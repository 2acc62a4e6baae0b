"""The flat-index slice: qadc_tpu_torch.index.flat vs qadc_tpu.index.flat on
the CPU, on indexes built by the JAX package (PQ trained on
tests/test_flat.py's _synthetic data, n = 4000, dim 32) and carried across
through convert.flat_index_from_arrays.

The JAX window paths run with interpret=True (their Pallas kernels in
interpret mode) against the port's window paths (windowed=True, the plain
versions of flat_scan / flat_scan8 / rows_adc); the JAX CPU paths
(interpret=False) against the port's per-code paths (windowed=False).

Tolerances and why:
  - int8 tables: the port's keep-prefix bound comes from M2 (rows_adc), the
    reference's from adc_scan_f32 (a one-hot matmul): float sums in another
    order. The mismatching entries are counted (ROADMAP Queue 3) and held
    to MAX_TABLE_MISMATCH.
  - rerank off (quantized distances): bit-exact, as
    tests/test_flat.py::test_flat_window_search_qadc_norerank_exact holds
    the reference's two paths; with saturate, too.
  - float distances (rerank on, adc at 4 and 8 bits): rtol 1e-5, float32
    sums in another order; labels equal wherever the distance stands apart
    from its neighbours in the row by more than that.
  - 16-bit: rtol 1e-4 (float32 GEMM distances |q|^2 + |x|^2 - 2 q.x, whose
    cancellation the two libraries round differently), labels as above.
Labels are compared only where distances are finite.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.core.packing import row128_to_codes
from qadc_tpu.index import flat as jflat
from qadc_tpu.io.checkpoint import save_index
from qadc_tpu.kernels.scan_ref import adc_scan_f32
from qadc_tpu.ops.quantization import (clamp_bound_to_max_distance, keep_prefix_bound,
                                       quantize_tables_int8)
from qadc_tpu.ops.tables import adc_tables
from qadc_tpu.quantizers.opq import OPQQuantizer as JOPQ
from qadc_tpu.quantizers.pq import ProductQuantizer as JPQ, train_pq
from qadc_tpu_torch.convert import flat_index_from_arrays
from qadc_tpu_torch.index import flat
from qadc_tpu_torch.io.checkpoint import load_index
from qadc_tpu_torch.kernels import lut_scan
from test_flat import _synthetic
from torch_parity import as_np

RTOL = 1e-5
MAX_TABLE_MISMATCH = 0


@functools.cache
def _data(n: int = 4000):
    return _synthetic(np.random.default_rng(0), n=n)


@functools.cache
def _jax_index(m: int = 16, bits: int = 4, n: int = 4000):
    """The JAX flat index of tests/test_flat.py (PQ trained, flat.add)."""
    base, _, _ = _data(n)
    pq = train_pq(jax.random.PRNGKey(0), base, sq_count=m, sq_bits=bits, iters=10)
    return jflat.add(jflat.FlatIndex.create(pq), base)


def _to_port(jindex):
    arrays = {"codes": np.asarray(jindex.codes),
              "pq_centroids": np.asarray(jindex.pq.centroids, np.float32)}
    if getattr(jindex.pq, "rotation", None) is not None:
        arrays["pq_rotation"] = np.asarray(jindex.pq.rotation, np.float32)
    meta = {"n": jindex.n, "pq": {"sq_bits": jindex.pq.sq_bits}}
    return flat_index_from_arrays(arrays, meta, torch.device("cpu"))


def _queries(n: int = 4000):
    return _data(n)[1]


def _assert_same(got, want, rtol=RTOL, exact=False):
    """Distances within rtol (or equal); labels equal where the distance is
    finite and stands apart from its row neighbours by more than rtol (the
    r-th never does: the next distance is unknown)."""
    (gd, gl), (wd, wl) = (tuple(as_np(x) for x in got), tuple(as_np(x) for x in want))
    assert gd.shape == wd.shape and gl.shape == wl.shape
    assert np.array_equal(np.isfinite(gd), np.isfinite(wd))
    if exact:
        np.testing.assert_array_equal(gd, wd)
    else:
        np.testing.assert_allclose(gd, wd, rtol=rtol)
    fin = np.isfinite(wd)
    pad = np.concatenate([np.full_like(wd[:, :1], -np.inf), wd, wd[:, -1:]], axis=1)
    with np.errstate(invalid="ignore"):
        gap = np.minimum(np.abs(pad[:, 1:-1] - pad[:, :-2]), np.abs(pad[:, 2:] - pad[:, 1:-1]))
    clear = fin & (gap > rtol * np.abs(wd))
    assert clear.mean() > 0.3
    np.testing.assert_array_equal(gl[clear], wl[clear])


def _jax_qtables(jindex, queries, r, keep):
    """The reference's int8 tables (flat.search_qadc:486-506)."""
    tables = adc_tables(jindex.pq.rotate(jnp.asarray(queries)), jindex.pq.centroids)
    cb = jindex.pq.code_size
    ps = jflat._prefix_size(jindex.n or jindex.n_pad, keep)
    prefix = row128_to_codes(jindex.codes[:-(-ps // jindex.cpr)], cb)[:ps]
    bound = keep_prefix_bound(adc_scan_f32(prefix, tables, 4), r)
    tables_nn = jnp.maximum(tables, 0.0)
    bound = clamp_bound_to_max_distance(bound, jnp.sum(jnp.max(tables_nn, axis=-1), axis=-1))
    qmin = jnp.min(tables_nn, axis=(-2, -1))
    return np.asarray(quantize_tables_int8(tables, bound[:, None, None], qmin[:, None, None]))


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("r,keep", [(10, 0.05), (100, 0.05), (100, 0.5)])
def test_int8_tables_match_reference(m, r, keep):
    jindex = _jax_index(m)
    queries = _queries()
    _, got, _ = flat._quantized_tables(_to_port(jindex), torch.from_numpy(queries), r, keep,
                                       lut_scan.DISPATCH)
    want = _jax_qtables(jindex, queries, r, keep)
    assert int((got.numpy() != want).sum()) <= MAX_TABLE_MISMATCH


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("windowed", [True, False])
@pytest.mark.parametrize("rerank", [True, False])
def test_search_qadc_matches_reference(m, windowed, rerank):
    jindex = _jax_index(m)
    queries = _queries()
    got = flat.search_qadc(_to_port(jindex), queries, r=10, keep=0.05, rerank=rerank,
                           windowed=windowed)
    want = jflat.search_qadc(jindex, queries, r=10, keep=0.05, rerank=rerank,
                             interpret=windowed)
    _assert_same(got, want, exact=not rerank)


@pytest.mark.parametrize("windowed", [True, False])
def test_search_qadc_saturate_matches_reference(windowed):
    jindex = _jax_index()
    queries = _queries()
    got = flat.search_qadc(_to_port(jindex), queries, r=10, keep=0.05, rerank=False,
                           saturate=True, windowed=windowed)
    want = jflat.search_qadc(jindex, queries, r=10, keep=0.05, rerank=False, saturate=True,
                             interpret=windowed)
    _assert_same(got, want, exact=True)
    assert float(got[0].max()) <= 127.0


@pytest.mark.parametrize("m,bits", [(16, 4), (32, 4), (8, 8)])
@pytest.mark.parametrize("windowed", [True, False])
def test_search_adc_matches_reference(m, bits, windowed):
    jindex = _jax_index(m, bits)
    queries = _queries()
    got = flat.search_adc(_to_port(jindex), queries, r=10, windowed=windowed)
    want = jflat.search_adc(jindex, queries, r=10, interpret=windowed)
    _assert_same(got, want)


def test_search_adc4_windowed_equals_the_exact_scan():
    """wq = r is exact: the window path returns the per-code scan's top-r."""
    tindex = _to_port(_jax_index())
    queries = _queries()
    got = flat.search_adc(tindex, queries, r=50)
    want = flat.search_adc(tindex, queries, r=50, windowed=False)
    torch.testing.assert_close(got[0], want[0], rtol=0, atol=0)


@functools.cache
def _jax_index16(n: int, m: int = 4, dim: int = 32, seed: int = 16):
    """A 16-bit flat index of random codes (the tail repeats the last code)
    and a random codebook: 16-bit training needs 65536 centroids."""
    rng = np.random.default_rng(seed)
    n_pad = -(-n // 1024) * 1024
    codes = rng.integers(0, 256, size=(n_pad, 2 * m), dtype=np.uint8)
    codes[n:] = codes[n - 1]
    pq = JPQ(centroids=jnp.asarray(rng.normal(size=(m, 1 << 16, dim // m)).astype(np.float32)),
             sq_bits=16)
    queries = rng.normal(size=(8, dim)).astype(np.float32)
    return jflat.FlatIndex(pq=pq, codes=jnp.asarray(codes.reshape(-1, 128)), n=n), queries


@pytest.mark.parametrize("n,r", [(3000, 10), (3000, 100), (70000, 100)])
def test_search_adc16_matches_reference(n, r):
    """N_pad 3072: one port chunk vs the reference's three of 1024 codes
    (r = 100 skips the screen); N_pad 70656: the port's 65536 + 5120 vs
    the reference's 69 chunks of 1024."""
    jindex, queries = _jax_index16(n)
    got = flat.search_adc(_to_port(jindex), queries, r=r)
    want = jflat.search_adc(jindex, queries, r=r)
    _assert_same(got, want, rtol=1e-4)


def test_scan_budget_ranges_identical():
    """A small scan budget splits the codes into ranges; the merged results
    equal one range's (labels too, but among equal quantized distances),
    and the reference's under the same budget."""
    jindex = _jax_index(n=8000)
    tindex = _to_port(jindex)
    queries = _queries(8000)
    budget = 1 << 16
    assert flat._flat_range_count(tindex.n_pad, 128, 16, budget) > 1
    for fn, jfn, kw in ((flat.search_qadc, jflat.search_qadc, dict(keep=0.05, rerank=False)),
                        (flat.search_adc, jflat.search_adc, {})):
        one = fn(tindex, queries, r=20, **kw)
        many = fn(tindex, queries, r=20, scan_budget_bytes=budget, **kw)
        _assert_same(many, one, exact=True)
        want = jfn(jindex, queries, r=20, interpret=True, scan_budget_bytes=budget, **kw)
        _assert_same(many, want, exact="rerank" in kw)


def test_r_larger_than_n():
    """Five codes, r = 8: the window path runs (N_pad / 16 = 8r) and returns
    exactly the five codes, then +inf."""
    base, queries, _ = _data()
    jindex = jflat.add(jflat.FlatIndex.create(_jax_index().pq), base[:5])
    tindex = _to_port(jindex)
    assert flat._scan4_gate(tindex, 8)
    for kw in (dict(keep=0.5), dict(keep=0.5, rerank=False)):
        got = flat.search_qadc(tindex, queries, r=8, **kw)
        assert np.isfinite(got[0].numpy()).sum(axis=1).tolist() == [5] * len(queries)
        assert (np.sort(got[1].numpy()[:, :5], axis=1) == np.arange(5)).all()
        _assert_same(got, jflat.search_qadc(jindex, queries, r=8, interpret=True, **kw),
                     exact="rerank" in kw)
    got = flat.search_adc(tindex, queries, r=8)
    assert np.isfinite(got[0].numpy()).sum(axis=1).tolist() == [5] * len(queries)
    _assert_same(got, jflat.search_adc(jindex, queries, r=8, interpret=True))


@pytest.mark.parametrize("r", [8, 10])
def test_empty_index(r):
    """r = 8 takes the window path, r = 10 the per-code one: all +inf."""
    jpq = _jax_index().pq
    tindex = flat.FlatIndex.create(_to_port(_jax_index()).pq)
    assert tindex.n == 0 and tindex.n_pad == 1024
    assert flat._scan4_gate(tindex, r) == (r == 8)
    queries = _queries()[:4]
    for got in (flat.search_qadc(tindex, queries, r=r), flat.search_adc(tindex, queries, r=r)):
        assert got[0].shape == (4, r) and torch.isinf(got[0]).all()
    want = jflat.search_adc(jflat.FlatIndex.create(jpq), queries, r=r, interpret=True)
    assert np.isinf(np.asarray(want[0])).all()


def test_opq_index_matches_reference():
    """A random orthonormal rotation: queries rotate before the tables."""
    jindex = _jax_index()
    dim = jindex.pq.dim
    rot, _ = np.linalg.qr(np.random.default_rng(2).normal(size=(dim, dim)))
    pq = JOPQ(centroids=jindex.pq.centroids, sq_bits=4,
              rotation=jnp.asarray(rot.astype(np.float32)))
    jindex = dataclasses.replace(jindex, pq=pq)
    tindex = _to_port(jindex)
    queries = _queries()
    _assert_same(flat.search_qadc(tindex, queries, r=10, keep=0.05),
                 jflat.search_qadc(jindex, queries, r=10, keep=0.05, interpret=True))
    _assert_same(flat.search_adc(tindex, queries, r=10),
                 jflat.search_adc(jindex, queries, r=10, interpret=True))


def test_saved_flat_index_loads(tmp_path):
    jindex = _jax_index()
    save_index(str(tmp_path), jindex)
    loaded = load_index(str(tmp_path))
    assert isinstance(loaded, flat.FlatIndex) and loaded.n == jindex.n
    np.testing.assert_array_equal(loaded.codes.numpy(), np.asarray(jindex.codes))
    np.testing.assert_array_equal(loaded.pq.centroids.numpy(), np.asarray(jindex.pq.centroids))
    queries = _queries()[:8]
    a = flat.search_qadc(loaded, queries, r=10, keep=0.05)
    b = flat.search_qadc(_to_port(jindex), queries, r=10, keep=0.05)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_checkpoint_geometry_is_checked():
    arrays = {"codes": np.zeros((64, 128), np.uint8),
              "pq_centroids": np.zeros((16, 16, 2), np.float32)}
    with pytest.raises(ValueError):
        flat_index_from_arrays(arrays, {"n": 64 * 16 + 1, "pq": {"sq_bits": 4}}, "cpu")
    with pytest.raises(ValueError):
        flat_index_from_arrays({**arrays, "codes": np.zeros((64, 64), np.uint8)},
                               {"n": 10, "pq": {"sq_bits": 4}}, "cpu")


def test_adc8_last_code_flood():
    """16-byte codes, n = 812, padding repeats the last code, and the query
    is that code's reconstruction (distance 0). JAX's window (rows 5 and 21
    of block 3, in slot order) finds a padded copy first and masks it, so the
    reference loses code 811; the port returns it first, as the exact
    per-code scan does (ROADMAP Queue 3)."""
    m, n, dim = 16, 812, 32
    rng = np.random.default_rng(12)
    codes = rng.integers(0, 256, size=(1024, m), dtype=np.uint8)
    codes[n:] = codes[n - 1]
    cent = rng.normal(size=(m, 256, dim // m)).astype(np.float32)
    jindex = jflat.FlatIndex(pq=JPQ(centroids=jnp.asarray(cent), sq_bits=8),
                             codes=jnp.asarray(codes.reshape(-1, 128)), n=n)
    tindex = _to_port(jindex)
    query = cent[np.arange(m), codes[n - 1]].reshape(1, dim)
    got = flat.search_adc(tindex, query, r=8)
    assert int(got[1][0, 0]) == n - 1 and float(got[0][0, 0]) < 1e-4
    _assert_same(got, flat.search_adc(tindex, query, r=8, windowed=False))
    want = jflat.search_adc(jindex, query, r=8, interpret=True)
    assert n - 1 not in np.asarray(want[1][0]).tolist()        # the reference's fault
