"""The conventional-ADC slice: qadc_tpu_torch.index.ivf.search_adc vs
qadc_tpu's at 4, 8 and 16 bits (the JAX grouped paths in interpret mode, and
their per-probe paths), and search_qadc(grouped=False) vs the JAX
_search_qadc_impl, on the CPU.

Tolerances and why:
  - exact paths (4-bit grouped, every per-probe path): distances rtol 1e-5
    (float32 sums in another order); label sets equal outside 1e-5 of the
    r-th distance, where an ulp can swap the cut.
  - 8-bit grouped: the port's windows are its own (row, parity class), its
    padded codes never enter a minimum, and the bf16 minima screen with a
    margin, so it is held to the exact per-probe oracle: top-1 equal,
    distances equal where labels agree (rtol 1e-5), mean overlap with the
    oracle >= 0.95, and at least the JAX grouped path's.
  - 16-bit grouped: distances rtol 1e-4 where labels agree (float32 GEMM
    distances), top-1 equal, overlap with the oracle >= 0.95.
  - search_qadc(grouped=False): rerank off, labels and distances identical
    on queries whose int8 tables agree; rerank on, top-1 equal and mean
    overlap >= 0.98.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.index import ivf as jivf
from qadc_tpu.io.checkpoint import save_index
from qadc_tpu.ops.knn import assign_nearest
from qadc_tpu.quantizers.pq import ProductQuantizer, train_pq
from qadc_tpu_torch.convert import ivf_index_from_arrays
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.io.checkpoint import load_index
from qadc_tpu_torch.kernels import lut_scan
from torch_parity import (EMPTY_PART, TINY_SIZE, as_np, index_arrays, synthetic_index,
                          to_port, trained_index)

G = 16  # group size: small keeps the interpret-mode kernels quick


def _mk(rng, n, basis):
    """Vectors on a 16-dim subspace of the space of `basis`, plus noise."""
    k, dim = basis.shape
    return (rng.normal(size=(n, k)) @ basis + 0.3 * rng.normal(size=(n, dim))).astype(np.float32)


@functools.cache
def trained8_index(n: int = 8000, parts: int = 16, m: int = 8):
    """A trained 8-bit index in the manner of tests/test_scan8_grouped.py."""
    rng = np.random.default_rng(8)
    basis = rng.normal(size=(16, 32)).astype(np.float32)
    base, queries = _mk(rng, n, basis), _mk(rng, 16, basis)
    coarse = jivf.train_coarse(jax.random.PRNGKey(1), base, part_count=parts, iters=8)
    a = np.asarray(assign_nearest(base, coarse))
    pq = train_pq(jax.random.PRNGKey(0), base - np.asarray(coarse)[a], m, 8, iters=6)
    return jivf.add(jivf.IVFIndex.create(pq, coarse), base), base, queries


@functools.cache
def trained16_index():
    """A 16-bit index (2x16 PQ, dim 8) as in tests/test_16bit.py: 512 real
    centroids a sub-quantizer, the other 65024 tiny noise."""
    rng = np.random.default_rng(16)
    m, dim, n = 2, 8, 1500
    base = rng.normal(size=(n, dim)).astype(np.float32)
    queries = base[:8] + 0.001 * rng.normal(size=(8, dim)).astype(np.float32)
    cent = (rng.normal(size=(m, 1 << 16, dim // m)) * 1e-3).astype(np.float32)
    cent[:, :512] = rng.normal(size=(m, 512, dim // m)).astype(np.float32)
    coarse = jivf.train_coarse(jax.random.PRNGKey(0), base[:1000], 8, iters=5)
    pq = ProductQuantizer(centroids=jnp.asarray(cent), sq_bits=16)
    return jivf.add(jivf.IVFIndex.create(pq, coarse), base), queries


def _jax(jindex, queries, grouped, **kw):
    jd, jl = jivf.search_adc(jindex, jnp.asarray(queries), grouped=grouped,
                             interpret=grouped, group_size=G, **kw)
    return np.asarray(jd), np.asarray(jl)


def _port(tindex, queries, grouped, **kw):
    td, tl = ivf.search_adc(tindex, queries, grouped=grouped, group_size=G, **kw)
    assert td.dtype == torch.float32 and tl.dtype == torch.int32
    return as_np(td), as_np(tl)


def _assert_exact(jd, jl, td, tl, rtol=1e-5):
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=rtol)
    for qi in range(jd.shape[0]):
        cut = jd[qi][fin[qi]].max() * (1 - 1e-5) if fin[qi].any() else -np.inf
        inside = lambda d, l: set(l[d < cut].tolist())  # noqa: E731
        assert inside(jd[qi], jl[qi]) == inside(td[qi], tl[qi]), qi


def _overlap(a, b, da):
    fin = np.isfinite(da)
    return np.mean([len(set(x[f]) & set(y[f])) / max(1, f.sum())
                    for x, y, f in zip(a, b, fin)])


def _assert_screened(od, ol, td, tl, rtol, min_overlap=0.95):
    """A screened search vs the exact oracle (od, ol)."""
    np.testing.assert_array_equal(tl[:, 0], ol[:, 0])
    same = (tl == ol) & np.isfinite(od)
    np.testing.assert_allclose(td[same], od[same], rtol=rtol)
    overlap = _overlap(ol, tl, od)
    assert overlap >= min_overlap, overlap
    return overlap


# ---------------------------------------------------------------- 4-bit


@pytest.mark.parametrize("grouped", [True, False])
def test_adc4_matches_reference(grouped):
    jindex, queries, _ = trained_index()
    kw = dict(r=100, ma=6)
    _assert_exact(*_jax(jindex, queries, grouped, **kw),
                  *_port(to_port(jindex), queries, grouped, **kw))


def test_adc4_grouped_equals_the_exact_path():
    """wq = r is lossless in the port: the grouped path returns the exact
    per-probe top-r (distances bit for bit where labels agree)."""
    jindex, queries = synthetic_index(m=32)
    tindex = to_port(jindex)
    od, ol = _port(tindex, queries, False, r=60, ma=4)
    td, tl = _port(tindex, queries, True, r=60, ma=4)
    _assert_exact(od, ol, td, tl, rtol=0)


# ---------------------------------------------------------------- 8-bit


@pytest.mark.parametrize("m", [4, 8, 16])
def test_adc8_grouped_matches_reference(m):
    jindex, base, queries = trained8_index(n=6000 if m != 8 else 8000, m=m)
    tindex = to_port(jindex)
    kw = dict(r=50, ma=6)
    od, ol = _jax(jindex, queries, False, **kw)                 # exact oracle
    jd, jl = _jax(jindex, queries, True, **kw)
    td, tl = _port(tindex, queries, True, **kw)
    ours = _assert_screened(od, ol, td, tl, rtol=1e-5)
    assert ours >= _overlap(ol, jl, od) - 0.01
    np.testing.assert_array_equal(tl[:, 0], jl[:, 0])


def test_adc8_per_probe_matches_reference():
    jindex, _, queries = trained8_index()
    kw = dict(r=50, ma=6)
    _assert_exact(*_jax(jindex, queries, False, **kw),
                  *_port(to_port(jindex), queries, False, **kw))


def test_adc8_last_code_flood():
    """Queries at a partition's last real code, tail padding repeating it in
    every padded slot (tests/test_scan8_grouped.py's adversarial case): the
    port's padded-code rule returns no duplicate and, with every probed code
    in a screened window, exactly the exact per-probe top-r."""
    jindex, base, _ = trained8_index(n=600, parts=16)
    tindex = to_port(jindex)
    sizes, labels = np.asarray(jindex.part_sizes), np.asarray(jindex.labels)
    hard = np.stack([base[labels[p, sizes[p] - 1]] for p in range(4) if sizes[p]])
    od, ol = _port(tindex, hard, False, r=30, ma=4)
    td, tl = _port(tindex, hard, True, r=30, ma=4)
    for qi in range(len(hard)):
        fin = np.isfinite(td[qi])
        assert len(set(tl[qi][fin])) == fin.sum()                # no duplicate
    _assert_exact(od, ol, td, tl)
    jd, jl = _jax(jindex, hard, True, r=30, ma=4)
    np.testing.assert_array_equal(tl[:, 0], jl[:, 0])           # the NN, as JAX


# ---------------------------------------------------------------- 16-bit


@pytest.mark.parametrize("grouped", [True, False])
def test_adc16_matches_reference(grouped):
    jindex, queries = trained16_index()
    tindex = to_port(jindex)
    kw = dict(r=20, ma=4)
    jd, jl = _jax(jindex, queries, grouped, **kw)
    td, tl = _port(tindex, queries, grouped, **kw)
    if not grouped:
        _assert_exact(jd, jl, td, tl, rtol=1e-4)
        return
    od, ol = _port(tindex, queries, False, **kw)
    _assert_screened(od, ol, td, tl, rtol=1e-4)
    np.testing.assert_array_equal(tl[:, 0], jl[:, 0])
    same = tl == jl
    np.testing.assert_allclose(td[same], jd[same], rtol=1e-4)


# ---------------------------------------------------------------- edge cases


@pytest.mark.parametrize("bits", [4, 8])
def test_adc_r_beyond_probed_codes(bits):
    jindex, queries = synthetic_index(m=16 if bits == 4 else 8, sq_bits=bits)
    tindex = to_port(jindex)
    q = queries[-1:]  # sits on the tiny partition: ma=1 probes TINY_SIZE codes
    for grouped in (True, False):
        td, tl = _port(tindex, q, grouped, r=100, ma=1)
        assert td.shape == (1, 100) and np.isfinite(td).sum() == TINY_SIZE
        jd, jl = _jax(jindex, q, False, r=100, ma=1)
        _assert_exact(jd, jl, td, tl)


@pytest.mark.parametrize("bits", [4, 8, 16])
def test_adc_ma_beyond_part_count_and_empty_partition(bits):
    m = {4: 16, 8: 8, 16: 2}[bits]
    jindex, queries = synthetic_index(m=m, sq_bits=bits)
    tindex = to_port(jindex)
    assert int(tindex.part_sizes[EMPTY_PART]) == 0
    od, ol = _port(tindex, queries[:4], False, r=50, ma=50)    # probes all 8
    jd, jl = _jax(jindex, queries[:4], False, r=50, ma=50)
    _assert_exact(jd, jl, od, ol, rtol=1e-4)
    td, tl = _port(tindex, queries[:4], True, r=50, ma=50)
    if bits == 4:
        _assert_exact(od, ol, td, tl)
    else:
        _assert_screened(od, ol, td, tl, rtol=1e-4)


def test_adc_governor_chunks_give_the_same_result():
    jindex, queries = synthetic_index(m=8, sq_bits=8)
    tindex = to_port(jindex)
    whole = ivf.search_adc(tindex, queries, r=20, ma=3)
    chunked = ivf.search_adc(tindex, queries, r=20, ma=3, scan_budget_bytes=1)
    torch.testing.assert_close(chunked[0], whole[0], rtol=1e-6, atol=0)
    assert torch.equal(whole[1], chunked[1])


def test_adc_plain_kernel_set_is_the_default_on_cpu():
    jindex, queries = synthetic_index(m=8, sq_bits=8)
    tindex = to_port(jindex)
    a = ivf.search_adc(tindex, queries, r=20, ma=3)
    b = ivf.search_adc(tindex, queries, r=20, ma=3, kernels=lut_scan.PLAIN)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------- Quick ADC


def _int8_equal_queries(jindex, tindex, queries, r, ma, keep):
    prefix_pad = min(max(1, int(jindex.max_part_size * keep)), jindex.part_pad)
    _, _, jq, _ = jivf._quantized_tables(jindex, jnp.asarray(queries), r, ma, keep,
                                         prefix_pad)
    _, _, tq, _ = ivf._quantized_tables(tindex, torch.from_numpy(queries), r, ma, keep,
                                        prefix_pad, lut_scan.DISPATCH)
    return (np.asarray(jq) == as_np(tq)).reshape(queries.shape[0], -1).all(axis=1)


@pytest.mark.parametrize("rerank", [False, True])
def test_qadc_per_probe_matches_reference(rerank):
    jindex, queries, _ = trained_index()
    tindex = to_port(jindex)
    kw = dict(r=50, ma=6, keep=0.05, rerank=rerank, grouped=False, direct=False)
    jd, jl = map(np.asarray, jivf.search_qadc(jindex, jnp.asarray(queries), **kw))
    td, tl = map(as_np, ivf.search_qadc(tindex, queries, **kw))
    if rerank:
        np.testing.assert_array_equal(tl[:, 0], jl[:, 0])
        assert _overlap(jl, tl, jd) >= 0.98
        return
    same = _int8_equal_queries(jindex, tindex, queries, 50, 6, 0.05)
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(tl[same], jl[same])
    np.testing.assert_array_equal(td[same], jd[same])


def test_qadc_per_probe_saturates():
    jindex, queries, _ = trained_index()
    kw = dict(r=30, ma=4, keep=0.05, rerank=False, grouped=False, direct=False)
    td, _ = ivf.search_qadc(to_port(jindex), queries[:8], saturate=True, **kw)
    assert float(td.max()) <= 127.0


# ---------------------------------------------------------------- checkpoints


@pytest.mark.parametrize("bits", [8, 16])
def test_wide_checkpoints_load_and_search(tmp_path, bits):
    jindex = trained8_index()[0] if bits == 8 else trained16_index()[0]
    queries = trained8_index()[2] if bits == 8 else trained16_index()[1]
    save_index(str(tmp_path), jindex)
    loaded = load_index(str(tmp_path), device="cpu")
    assert loaded.pq.sq_bits == bits
    arrays, _ = index_arrays(jindex)
    np.testing.assert_array_equal(as_np(loaded.codes), arrays["codes"])
    a = ivf.search_adc(loaded, queries, r=20, ma=3)
    b = ivf.search_adc(to_port(jindex), queries, r=20, ma=3)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_convert_rejects_geometries_the_port_cannot_search():
    jindex, _ = synthetic_index()
    arrays, meta = index_arrays(jindex)
    bad_bits = {**meta, "pq": {"sq_bits": 8}}           # 16 centroids at 8 bits
    with pytest.raises(ValueError):
        ivf_index_from_arrays(arrays, bad_bits, 'cpu')
    with pytest.raises(ValueError):                      # labels of another pad
        ivf_index_from_arrays({**arrays, "labels": arrays["labels"][:, :-16]}, meta, "cpu")
    odd = {**arrays, "pq_centroids": np.zeros((3, 256, 4), np.float32)}
    with pytest.raises(ValueError):                      # 3-byte codes tile no row
        ivf_index_from_arrays(odd, bad_bits, 'cpu')
