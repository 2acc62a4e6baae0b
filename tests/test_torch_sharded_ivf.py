"""The port's partition-sharded IVF search (qadc_tpu_torch/dist/sharded_ivf.py)
against the JAX package's, on the CPU: the cases of tests/test_sharded_ivf.py
at their sizes and seeds, 8 local shards in one process against the JAX
package's 8-device mesh (interpret mode).

Tolerances, those of tests/test_torch_ivf_search.py's grouped path: labels
equal to the JAX sharded search's (its int8 tables agree here), distances
rtol 1e-5 (float32 sums in another order); against the single-card search
(another candidate set by design: each shard screens r windows of its own)
only top-1 and recall, as the JAX test holds; a change that must not move
results (overlap chunks, padding) bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from qadc_tpu.dist.mesh import make_mesh as jmake_mesh
from qadc_tpu.dist.sharded_ivf import search_qadc_ivf_sharded as jsearch
from qadc_tpu.dist.sharded_ivf import shard_ivf_partitions as jshard
from qadc_tpu.index import build as jbuild
from qadc_tpu.index import ivf as jivf
from qadc_tpu.ops.knn import assign_nearest, exact_knn
from qadc_tpu.quantizers.pq import train_pq
from qadc_tpu_torch.dist.mesh import make_mesh
from qadc_tpu_torch.dist.sharded_ivf import search_qadc_ivf_sharded, shard_ivf_partitions
from qadc_tpu_torch.eval.recall import recall_at_r
from qadc_tpu_torch.index import build, ivf
from torch_parity import as_np, to_port

RTOL = 1e-5


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(11)
    dim, n = 32, 24000
    centers = rng.normal(scale=3.0, size=(16, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 16, n)] + rng.normal(size=(n, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 16, 16)] + rng.normal(size=(16, dim))).astype(np.float32)
    coarse = jivf.train_coarse(jax.random.PRNGKey(0), base[:5000], 24, iters=10)
    a = np.asarray(assign_nearest(base[:5000], coarse))
    pq = train_pq(jax.random.PRNGKey(1), base[:5000] - np.asarray(coarse)[a], 16, 4, iters=10)
    index = jivf.add(jivf.IVFIndex.create(pq, coarse), base)
    _, gt = exact_knn(queries, base, 1)
    return index, to_port(index), queries, np.asarray(gt)


def _both(jindex, tindex, queries, shards, **kw):
    """(JAX sharded, port sharded) results at `shards` shards."""
    jm = jmake_mesh(shards)
    jd, jl = jsearch(jshard(jindex, jm), queries, mesh=jm, interpret=True, **kw)
    tm = make_mesh(shards, device="cpu")
    td, tl = search_qadc_ivf_sharded(shard_ivf_partitions(tindex, tm), queries, mesh=tm, **kw)
    assert td.dtype == torch.float32 and tl.dtype == torch.int32
    return np.asarray(jd), np.asarray(jl), as_np(td), as_np(tl)


@pytest.mark.parametrize("shards", [8, 5])
def test_shard_pads_partitions(built, shards):
    """Padding to a shard multiple: the JAX package's arrays (24 partitions
    over 5 shards: one empty partition with a far coarse centroid)."""
    jindex, tindex, _, _ = built
    sharded = shard_ivf_partitions(tindex, make_mesh(shards, device="cpu"))
    want = jshard(jindex, jmake_mesh(shards))
    assert sharded.part_count % shards == 0 and sharded.part_count == want.part_count
    assert sharded.n == jindex.n
    for name in ("codes", "labels", "part_sizes", "coarse_centroids"):
        np.testing.assert_array_equal(as_np(getattr(sharded, name)), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(as_np(sharded.part_sizes)[: jindex.part_count],
                                  np.asarray(jindex.part_sizes))


@pytest.mark.parametrize("shards,ma", [(8, 6), (5, 25)])
def test_sharded_matches_reference(built, shards, ma):
    """Against the JAX sharded search; at 5 shards ma = 25 also probes the
    padded partition (coarse centroid 1e30: score -inf, tables +inf), which
    must give no NaN and no candidate."""
    jindex, tindex, queries, _ = built
    jd, jl, td, tl = _both(jindex, tindex, queries, shards, r=50, ma=ma, keep=0.05)
    assert np.isfinite(td).all()
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, rtol=RTOL)


def test_sharded_matches_single_device(built):
    """Against the single-card grouped search: top-1 and recall only."""
    jindex, tindex, queries, gt = built
    mesh = make_mesh(8, device="cpu")
    d2, l2 = search_qadc_ivf_sharded(shard_ivf_partitions(tindex, mesh), queries, r=50, ma=6,
                                     keep=0.05, mesh=mesh)
    d1, l1 = ivf.search_qadc(tindex, queries, r=50, ma=6, keep=0.05, grouped=True)
    d1, l1, d2, l2 = map(as_np, (d1, l1, d2, l2))
    assert recall_at_r(l2, gt) >= recall_at_r(l1, gt) - 0.07
    np.testing.assert_array_equal(l1[:, 0], l2[:, 0])
    np.testing.assert_allclose(d1[:, 0], d2[:, 0], rtol=RTOL)
    assert np.mean(d2[:, -1] - d1[:, -1]) < 2.0


def test_sharded_recall_vs_exact(built):
    _, tindex, queries, gt = built
    mesh = make_mesh(8, device="cpu")
    _, labels = search_qadc_ivf_sharded(shard_ivf_partitions(tindex, mesh), queries, r=100,
                                        ma=8, keep=0.05, mesh=mesh)
    assert recall_at_r(as_np(labels), gt) > 0.85


def test_sharded_ma_exceeds_part_count(rng):
    """ma > part_count through the sharded path clamps to probing all."""
    base = rng.normal(size=(1500, 32)).astype(np.float32)
    coarse = jivf.train_coarse(jax.random.PRNGKey(1), base, part_count=8, iters=4)
    a = np.asarray(assign_nearest(base, coarse))
    pq = train_pq(jax.random.PRNGKey(2), base - np.asarray(coarse)[a], 16, 4, iters=4)
    jindex = jivf.add(jivf.IVFIndex.create(pq, coarse), base)
    mesh = make_mesh(8, device="cpu")
    sharded = shard_ivf_partitions(to_port(jindex), mesh)
    qs = base[:4] + 0.01
    kw = dict(r=10, keep=0.05, mesh=mesh)
    _, l_all = search_qadc_ivf_sharded(sharded, qs, ma=sharded.part_count, **kw)
    _, l_big = search_qadc_ivf_sharded(sharded, qs, ma=100, **kw)
    np.testing.assert_array_equal(as_np(l_big), as_np(l_all))
    jd, jl, td, tl = _both(jindex, to_port(jindex), qs, 8, r=10, ma=100, keep=0.05)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_allclose(td, jd, rtol=RTOL)


@pytest.mark.parametrize("extra", [dict(overlap_chunks=2), dict(overlap_chunks=5),
                                   dict(overlap_chunks=2, scan_budget_bytes=1)])
def test_sharded_overlap_chunks_identical(built, extra):
    """overlap_chunks only reorders independent work (5 does not divide the
    16 queries: it falls back to 1); a budget of 1 byte makes the memory
    governor scan one query at a time inside each chunk."""
    _, tindex, queries, _ = built
    mesh = make_mesh(8, device="cpu")
    sharded = shard_ivf_partitions(tindex, mesh)
    kw = dict(r=50, ma=6, keep=0.05, mesh=mesh)
    d1, l1 = search_qadc_ivf_sharded(sharded, queries, **kw)
    d2, l2 = search_qadc_ivf_sharded(sharded, queries, **extra, **kw)
    assert torch.equal(l1, l2) and torch.equal(d1, d2)


def test_sharded_repadded_matches(built):
    """The counterpart of the JAX tq case: the port has no byte-planes, so
    an index re-padded to a multiple of 2048 codes (where the JAX package
    builds planes) gives the same results bit for bit, and the JAX
    package's tq path's labels."""
    jindex, tindex, queries, _ = built
    pad = -(-tindex.part_pad // 2048) * 2048
    mesh = make_mesh(8, device="cpu")
    kw = dict(r=50, ma=6, keep=0.05, mesh=mesh)
    d0, l0 = search_qadc_ivf_sharded(shard_ivf_partitions(tindex, mesh), queries, **kw)
    d1, l1 = search_qadc_ivf_sharded(
        shard_ivf_partitions(build.repad_partitions(tindex, pad), mesh), queries, **kw)
    assert torch.equal(l0, l1) and torch.equal(d0, d1)
    jm = jmake_mesh(8)
    jsharded = jshard(jbuild.repad_partitions(jindex, pad), jm)
    assert jsharded.planes is not None
    jd, jl = jsearch(jsharded, queries, r=50, ma=6, keep=0.05, mesh=jm, interpret=True)
    np.testing.assert_array_equal(as_np(l1), np.asarray(jl))
    np.testing.assert_allclose(as_np(d1), np.asarray(jd), rtol=RTOL)
