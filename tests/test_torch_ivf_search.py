"""The whole slice: qadc_tpu_torch.index.ivf.search_qadc vs qadc_tpu's, on
the CPU (the JAX side in interpret mode, window 16, block_n 2048).

Tolerances and why:
  - direct path (exact float ADC): distances rtol 1e-5 (float32 sums in
    another order); label sets equal outside 1e-5 of the r-th distance,
    where an ulp can swap the cut; dead slots (-1, +inf) identical.
  - grouped path, rerank on: the int8 screen can differ where an int8
    table entry differs by one (test_torch_tables), so top-1 labels equal,
    mean overlap >= 98 of 100, recall@r within 0.01 of the reference's;
    dead slots identical.
  - grouped path, rerank off: labels identical on every query whose int8
    tables agree exactly (the ranking is by int8 distance).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.eval.recall import recall_at_r as j_recall
from qadc_tpu.index import ivf as jivf
from qadc_tpu_torch.eval.recall import recall_at_r
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.kernels.lut_scan import DISPATCH
from torch_parity import EMPTY_PART, TINY_SIZE, as_np, synthetic_index, to_port, trained_index

JAX_KW = dict(interpret=True, grouped_window=16, block_n=2048)


@pytest.fixture(scope="module")
def trained():
    jindex, queries, gt = trained_index()
    return jindex, to_port(jindex), queries, gt


@pytest.fixture(scope="module")
def synthetic():
    jindex, queries = synthetic_index()
    return jindex, to_port(jindex), queries


def _both(jindex, tindex, queries, **kw):
    jd, jl = jivf.search_qadc(jindex, jnp.asarray(queries), **kw, **JAX_KW)
    td, tl = ivf.search_qadc(tindex, queries, **kw)
    assert td.dtype == torch.float32 and tl.dtype == torch.int32
    return np.asarray(jd), np.asarray(jl), as_np(td), as_np(tl)


def _dead_equal(jd, jl, td, tl):
    np.testing.assert_array_equal(np.isinf(td), np.isinf(jd))
    np.testing.assert_array_equal(tl[np.isinf(td)], jl[np.isinf(jd)])


def _assert_direct(jd, jl, td, tl):
    _dead_equal(jd, jl, td, tl)
    fin = np.isfinite(jd)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5)
    for qi in range(jd.shape[0]):
        cut = jd[qi][fin[qi]].max() * (1 - 1e-5) if fin[qi].any() else -np.inf
        inside = lambda d, l: set(l[d < cut].tolist())  # noqa: E731
        assert inside(jd[qi], jl[qi]) == inside(td[qi], tl[qi]), qi


def _assert_grouped(jd, jl, td, tl):
    _dead_equal(jd, jl, td, tl)
    np.testing.assert_array_equal(tl[:, 0], jl[:, 0])
    fin = np.isfinite(jd)  # the same slots on both sides (_dead_equal)
    overlap = np.mean([len(set(a[f]) & set(b[f])) / max(1, len(set(a[f])))
                       for a, b, f in zip(jl, tl, fin)])
    assert overlap >= 0.98, overlap


@pytest.mark.parametrize("b", [1, 4])
def test_direct_matches_reference(trained, synthetic, b):
    for jindex, tindex, queries in (trained[:3], synthetic):
        out = _both(jindex, tindex, queries[:b], r=100, ma=6, keep=0.05, direct=True)
        _assert_direct(*out)


def test_grouped_rerank_matches_reference(trained):
    jindex, tindex, queries, gt = trained
    jd, jl, td, tl = _both(jindex, tindex, queries, r=100, ma=6, keep=0.05,
                           grouped=True, direct=False)
    _assert_grouped(jd, jl, td, tl)
    assert abs(recall_at_r(tl, gt) - j_recall(jl, gt)) <= 0.01
    np.testing.assert_allclose(td[:, 0], jd[:, 0], rtol=1e-5)


def _int8_equal_queries(jindex, tindex, queries, r, ma, keep):
    prefix_pad = min(max(1, int(jindex.max_part_size * keep)), jindex.part_pad)
    _, _, jq, _ = jivf._quantized_tables(jindex, jnp.asarray(queries), r, ma, keep,
                                         prefix_pad, interpret=True)
    _, _, tq, _ = ivf._quantized_tables(tindex, torch.from_numpy(queries), r, ma, keep,
                                        prefix_pad, DISPATCH)
    return (np.asarray(jq) == as_np(tq)).reshape(queries.shape[0], -1).all(axis=1)


@pytest.mark.parametrize("saturate", [False, True])
def test_grouped_no_rerank_matches_reference(trained, saturate):
    jindex, tindex, queries, _ = trained
    kw = dict(r=50, ma=6, keep=0.05)
    jd, jl, td, tl = _both(jindex, tindex, queries, grouped=True, direct=False,
                           rerank=False, saturate=saturate, **kw)
    same = _int8_equal_queries(jindex, tindex, queries, **kw)
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_array_equal(tl[same], jl[same])
    np.testing.assert_array_equal(td[same], jd[same])
    if saturate:
        assert td.max() <= 127.0


def test_grouped_saturate_with_rerank(trained):
    jindex, tindex, queries, _ = trained
    out = _both(jindex, tindex, queries[:8], r=100, ma=6, keep=0.05,
                grouped=True, direct=False, saturate=True)
    _assert_grouped(*out)


def test_empty_partition_probed(synthetic):
    jindex, tindex, queries = synthetic
    ma = jindex.part_count  # probes the empty partition
    _assert_direct(*_both(jindex, tindex, queries[:4], r=100, ma=ma, keep=0.05,
                          direct=True))
    jd, jl, td, tl = _both(jindex, tindex, queries[:4], r=100, ma=ma, keep=0.05,
                           grouped=True, direct=False)
    _assert_grouped(jd, jl, td, tl)
    assert int(tindex.part_sizes[EMPTY_PART]) == 0


def test_r_beyond_probed_codes(synthetic):
    jindex, tindex, queries = synthetic
    q = queries[-1:]  # sits on the tiny partition: ma=1 probes TINY_SIZE codes
    jd, jl, td, tl = _both(jindex, tindex, q, r=100, ma=1, keep=0.05, direct=True)
    _assert_direct(jd, jl, td, tl)
    assert np.isfinite(td).sum() == TINY_SIZE
    assert (tl[np.isinf(td)] == -1).all()
    jd, jl, td, tl = _both(jindex, tindex, q, r=100, ma=1, keep=0.05,
                           grouped=True, direct=False)
    _assert_grouped(jd, jl, td, tl)
    assert np.isfinite(td).sum() == TINY_SIZE


def test_bound_and_screen_windows(synthetic):
    jindex, tindex, queries = synthetic
    bound = np.full(queries.shape[0], 400.0, np.float32)
    kw = dict(r=30, ma=3, keep=0.05, grouped=True, direct=False, screen_windows=45)
    jd, jl, td, tl = _both(jindex, tindex, queries, bound=bound, **kw)
    _assert_grouped(jd, jl, td, tl)


def test_default_path_on_cpu_is_grouped(synthetic):
    _, tindex, queries = synthetic
    d0, l0 = ivf.search_qadc(tindex, queries, r=20, ma=2)
    d1, l1 = ivf.search_qadc(tindex, queries, r=20, ma=2, grouped=True, direct=False)
    assert torch.equal(d0, d1) and torch.equal(l0, l1)
    # grouped=False is the per-probe path, a different screen of the same data.
    d2, l2 = ivf.search_qadc(tindex, queries, r=20, ma=2, grouped=False, direct=False)
    assert torch.equal(l2[:, 0], l0[:, 0])


def test_governor_chunks_give_the_same_result(synthetic):
    """Chunked batches rank the same; distances may move by an ulp because
    the float32 table einsum blocks a smaller batch differently."""
    _, tindex, queries = synthetic
    for kw in (dict(grouped=True, direct=False), dict(direct=True)):
        whole = ivf.search_qadc(tindex, queries, r=20, ma=3, **kw)
        chunked = ivf.search_qadc(tindex, queries, r=20, ma=3, scan_budget_bytes=1, **kw)
        torch.testing.assert_close(chunked[0], whole[0], rtol=1e-6, atol=0)
        assert torch.equal(whole[1], chunked[1])
