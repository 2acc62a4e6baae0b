"""The port's code-sharded flat searches and query-parallel search
(qadc_tpu_torch/dist/sharded.py) against the JAX package's, on the CPU: the
cases of tests/test_sharded.py at their sizes and seeds, 8 local shards in
one process against the JAX package's 8-device mesh, and the sharded float
ADC at 8 and 16 bits.

Tolerances: float ADC distances rtol 1e-5 (1e-4 at 16 bits, a GEMM against
table sums: tests/test_torch_flat.py), labels equal; Quick ADC with rerank
against the JAX kernel path (interpret mode): top-1 labels equal and an
overlap of at least 38 of 50 (the JAX test's own bound); without rerank
(int8 distances) bit for bit; query-parallel labels equal to the single
search's.
"""

import jax
import numpy as np
import pytest
import torch

from qadc_tpu.dist import sharded as jsharded
from qadc_tpu.dist.mesh import make_mesh as jmake_mesh
from qadc_tpu.index import flat as jflat
from qadc_tpu.index import ivf as jivf
from qadc_tpu.ops.knn import assign_nearest, exact_knn
from qadc_tpu.quantizers.pq import train_pq
from qadc_tpu_torch.dist.mesh import Mesh, make_mesh
from qadc_tpu_torch.dist.sharded import (search_adc_flat_sharded, search_qadc_flat_sharded,
                                         search_query_parallel, shard_flat_codes)
from qadc_tpu_torch.eval.recall import recall_at_r
from qadc_tpu_torch.index import flat, ivf
from test_torch_flat import _assert_same, _jax_index, _jax_index16, _to_port
from torch_parity import as_np, to_port

MIN_OVERLAP = 38 / 50   # the JAX test's bound, as a share of r


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(7)
    dim, n = 32, 20000
    centers = rng.normal(scale=3.0, size=(12, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 12, n)] + rng.normal(size=(n, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 12, 24)] + rng.normal(size=(24, dim))).astype(np.float32)
    pq = train_pq(jax.random.PRNGKey(0), base, 16, 4, iters=10)
    jindex = jflat.add(jflat.FlatIndex.create(pq), base)
    return jindex, _to_port(jindex), base, queries


def _meshes():
    return jmake_mesh(), make_mesh(8, device="cpu")


def _overlap_ok(a, b):
    a, b = as_np(a), as_np(b)
    for qi, (x, y) in enumerate(zip(a.tolist(), b.tolist())):
        assert len(set(x) & set(y)) >= MIN_OVERLAP * a.shape[1], (qi, len(set(x) & set(y)))


def test_mesh_has_8_shards():
    mesh = make_mesh(8, device="cpu")
    assert (mesh.shards, mesh.world, mesh.rank, mesh.local_shards) == (8, 1, 0, 8)
    assert isinstance(mesh, Mesh) and mesh.device == torch.device("cpu")
    default = make_mesh()  # no process group: one shard, on the card
    assert (default.shards, default.world) == (1, 1) and default.device.type == "cuda"
    with pytest.raises(ValueError):
        make_mesh(0, device="cpu")


def test_flat_sharded_adc_matches_single(setup):
    jindex, tindex, _, queries = setup
    jm, tm = _meshes()
    sharded = shard_flat_codes(tindex, tm)
    js = jsharded.shard_flat_codes(jindex, jm)
    assert sharded.codes.shape[0] % 8 == 0
    np.testing.assert_array_equal(as_np(sharded.codes), np.asarray(js.codes))
    got = search_adc_flat_sharded(sharded, queries, r=50, mesh=tm)
    _assert_same(got, jsharded.search_adc_flat_sharded(js, queries, r=50, mesh=jm))
    np.testing.assert_array_equal(as_np(got[1]), as_np(flat.search_adc(tindex, queries, r=50)[1]))


def test_flat_sharded_qadc_matches_single(setup):
    """Each shard screens 2r windows of its own: strong overlap with the
    single-card search, not equality (the JAX test's bound)."""
    _, tindex, _, queries = setup
    _, tm = _meshes()
    d1, l1 = flat.search_qadc(tindex, queries, r=50, keep=0.02)
    d2, l2 = search_qadc_flat_sharded(shard_flat_codes(tindex, tm), queries, r=50, keep=0.02,
                                      mesh=tm)
    _overlap_ok(l1, l2)
    np.testing.assert_allclose(as_np(d1)[:, 0], as_np(d2)[:, 0], rtol=1e-4)


@pytest.mark.parametrize("rerank", [True, False])
def test_flat_sharded_qadc_kernel_path(setup, rerank):
    """Against the JAX kernel path per shard (use_kernel=True, interpret)."""
    jindex, tindex, _, queries = setup
    jm, tm = _meshes()
    jd, jl = jsharded.search_qadc_flat_sharded(
        jsharded.shard_flat_codes(jindex, jm), queries, r=50, keep=0.02, mesh=jm,
        use_kernel=True, interpret=True, rerank=rerank)
    td, tl = search_qadc_flat_sharded(shard_flat_codes(tindex, tm), queries, r=50, keep=0.02,
                                      mesh=tm, rerank=rerank)
    np.testing.assert_array_equal(as_np(tl)[:, 0], np.asarray(jl)[:, 0])
    _overlap_ok(tl, jl)
    if rerank:
        np.testing.assert_allclose(as_np(td), np.asarray(jd), rtol=1e-5)
    else:  # int8 distances: exact
        np.testing.assert_array_equal(as_np(td), np.asarray(jd))


@pytest.mark.parametrize("bits", [8, 16])
def test_flat_sharded_adc_wide_codes(bits):
    """8 bits by the exact per-code scan, 16 by the reconstruction GEMM."""
    if bits == 8:
        jindex, queries = _jax_index(m=8, bits=8), np.random.default_rng(3).normal(
            size=(8, 32)).astype(np.float32)
    else:
        jindex, queries = _jax_index16(3000)
    jm, tm = _meshes()
    got = search_adc_flat_sharded(shard_flat_codes(_to_port(jindex), tm), queries, r=20, mesh=tm)
    want = jsharded.search_adc_flat_sharded(jsharded.shard_flat_codes(jindex, jm), queries,
                                            r=20, mesh=jm)
    _assert_same(got, want, rtol=1e-5 if bits == 8 else 1e-4)


def test_query_parallel_flat(setup):
    jindex, tindex, _, queries = setup
    _, tm = _meshes()
    _, l1 = flat.search_adc(tindex, queries, r=20)
    _, l2 = search_query_parallel(flat.search_adc, tindex, queries, mesh=tm, r=20)
    np.testing.assert_array_equal(as_np(l1), as_np(l2))
    # 13 queries: padded to a shard multiple.
    _, l3 = search_query_parallel(flat.search_adc, tindex, queries[:13], mesh=tm, r=20)
    np.testing.assert_array_equal(as_np(l1)[:13], as_np(l3))
    _, jl = jsharded.search_query_parallel(jflat.search_adc, jindex, queries[:13],
                                           mesh=jmake_mesh(), r=20)
    np.testing.assert_array_equal(as_np(l3), np.asarray(jl))


def test_query_parallel_ivf(setup):
    _, _, base, queries = setup
    coarse = jivf.train_coarse(jax.random.PRNGKey(2), base[:4000], 16, iters=8)
    a = np.asarray(assign_nearest(base[:4000], coarse))
    pq = train_pq(jax.random.PRNGKey(1), base[:4000] - np.asarray(coarse)[a], 16, 4, iters=8)
    jindex = jivf.add(jivf.IVFIndex.create(pq, coarse), base)
    tindex = to_port(jindex)
    _, tm = _meshes()
    kw = dict(r=20, ma=4, keep=0.1)
    _, l1 = ivf.search_qadc(tindex, queries, **kw)
    _, l2 = search_query_parallel(ivf.search_qadc, tindex, queries, mesh=tm, **kw)
    np.testing.assert_array_equal(as_np(l1), as_np(l2))
    _, jl = jsharded.search_query_parallel(jivf.search_qadc, jindex, queries, mesh=jmake_mesh(),
                                           grouped=True, interpret=True, **kw)
    np.testing.assert_array_equal(as_np(l2)[:, 0], np.asarray(jl)[:, 0])
    _overlap_ok(l2, jl)


def test_sharded_recall(setup):
    _, tindex, base, queries = setup
    _, tm = _meshes()
    _, gt = exact_knn(queries, base, 1)
    _, labels = search_qadc_flat_sharded(shard_flat_codes(tindex, tm), queries, r=100,
                                         keep=0.02, mesh=tm)
    _, single = flat.search_qadc(tindex, queries, r=100, keep=0.02)
    gt = np.asarray(gt)
    assert recall_at_r(as_np(labels), gt) >= recall_at_r(as_np(single), gt) - 0.05
