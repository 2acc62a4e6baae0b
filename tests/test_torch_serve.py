"""The port's SearchServer (qadc_tpu_torch/serve.py) on the CPU: the cases of
tests/test_serve.py, on a flat 16x4 index of 5,000 x 32 vectors (numpy
seed 4) trained by the port; the two sharded cases serve the port's
partition-sharded IVF search (dist/sharded_ivf.py) over IVF 16x4 indexes
of 4,000 x 32 vectors (numpy seeds 5 and 6) trained by the port, on 8 and
4 local shards.

Every answer is held to the port's search of the same queries: labels
exact, distances rtol 1e-6 (the server's batch has another shape than the
direct call's, and the tables' float products may round by shape). Waits
have timeouts.
"""

import threading
import time
from functools import partial

import numpy as np
import pytest
import torch

from qadc_tpu_torch.dist.mesh import make_mesh
from qadc_tpu_torch.dist.sharded_ivf import (load_sharded_index, search_qadc_ivf_sharded,
                                             shard_ivf_partitions)
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.io.checkpoint import save_index_sharded
from qadc_tpu_torch.ops.knn import assign_nearest
from qadc_tpu_torch.quantizers.pq import train_pq
from qadc_tpu_torch.serve import SearchServer

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

TIMEOUT = 60
RTOL = 1e-6


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(4)
    base = rng.normal(size=(5000, 32)).astype(np.float32)
    pq = train_pq(0, base, 16, 4, iters=8, device="cpu")
    return flat.add(flat.FlatIndex.create(pq), base), base


def test_serve_matches_direct(built):
    index, base = built
    queries = base[:10] + 0.01
    with SearchServer(index, r=20, keep=0.05, batch_size=16, max_wait_ms=20) as srv:
        futs = [srv.submit(q) for q in queries]
        results = [f.result(timeout=TIMEOUT) for f in futs]
    d_direct, l_direct = flat.search_qadc(index, torch.from_numpy(queries), r=20, keep=0.05)
    for i, (d, lab) in enumerate(results):
        assert futs[i].bucket in srv.batch_buckets
        np.testing.assert_array_equal(lab, l_direct[i].numpy())
        np.testing.assert_allclose(d, d_direct[i].numpy(), rtol=RTOL)


def test_serve_batches_requests(built):
    index, base = built
    with SearchServer(index, r=5, keep=0.05, batch_size=64, max_wait_ms=100) as srv:
        futs = [srv.submit(base[i]) for i in range(32)]
        for f in futs:
            f.result(timeout=TIMEOUT)
        assert srv._batches <= 3  # requests were batched
        assert srv.batch_buckets == [1, 8, 64]
        assert max(f.bucket for f in futs) == 64


def test_serve_concurrent_callers(built):
    index, base = built
    results = {}
    with SearchServer(index, r=5, keep=0.05, batch_size=16, max_wait_ms=5) as srv:
        def caller(tid):
            futs = [srv.submit(base[tid * 10 + i]) for i in range(10)]
            results[tid] = [int(f.result(timeout=TIMEOUT)[1][0]) for f in futs]

        threads = [threading.Thread(target=caller, args=(t,)) for t in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
    for tid in range(4):
        # each query's own row is its nearest neighbour
        assert results[tid] == [tid * 10 + i for i in range(10)]


def test_serve_rejects_bad_dim(built):
    index, _ = built
    with SearchServer(index, r=5, keep=0.05) as srv:
        with pytest.raises(ValueError, match="dim"):
            srv.submit(np.zeros(7, np.float32))


def test_serve_search_fn_override(built):
    """search_fn replaces the search: it gets the index and the padded batch
    (a tensor on the index's device) and returns (dists, labels)."""
    index, base = built
    seen = []

    def nearest_rows(idx, batch):
        seen.append((idx is index, tuple(batch.shape), batch.device.type))
        d = torch.cdist(batch, torch.from_numpy(base)) ** 2
        dist, lab = torch.topk(d, 3, largest=False)
        return dist, lab.to(torch.int32)

    queries = base[[5, 17, 42]]
    with SearchServer(index, batch_size=4, max_wait_ms=20, search_fn=nearest_rows) as srv:
        got = [f.result(timeout=TIMEOUT) for f in [srv.submit(q) for q in queries]]
    assert [int(lab[0]) for _, lab in got] == [5, 17, 42]
    assert all(same and dev == "cpu" and shape[1] == 32 for same, shape, dev in seen)
    assert {shape[0] for _, shape, _ in seen} <= {1, 4}


def test_serve_survives_transient_failure(built):
    """One failed batch fails only its own futures; the server keeps serving.
    Only max_consecutive_failures in a row close it."""
    index, base = built
    calls = {"n": 0}

    def flaky(idx, batch):
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("transient device error")
        return flat.search_qadc(idx, batch, r=5, keep=0.05)

    with SearchServer(index, batch_size=4, max_wait_ms=5, search_fn=flaky,
                      max_consecutive_failures=3) as srv:
        f1 = srv.submit(base[0])
        with pytest.raises(RuntimeError, match="transient"):
            f1.result(timeout=TIMEOUT)
        d, lab = srv.submit(base[1]).result(timeout=TIMEOUT)
        assert lab[0] == 1


def test_serve_closes_after_consecutive_failures(built):
    index, base = built

    def always_fail(idx, batch):
        raise RuntimeError("poisoned")

    srv = SearchServer(index, batch_size=1, max_wait_ms=1, search_fn=always_fail,
                       max_consecutive_failures=2)
    try:
        for _ in range(2):
            f = srv.submit(base[0])
            with pytest.raises(RuntimeError, match="poisoned"):
                f.result(timeout=TIMEOUT)
        deadline = time.monotonic() + 10
        while not srv._closed and time.monotonic() < deadline:
            time.sleep(0.01)
        with pytest.raises(RuntimeError, match="closed"):
            srv.submit(base[0])
    finally:
        srv.close()
    assert not srv._collector.is_alive() and not srv._executor.is_alive()


def test_serve_collects_next_batch_while_executing(built):
    """Double buffering: while the executor is inside the search of batch N,
    the collector stages batch N+1."""
    index, base = built
    in_search = threading.Event()
    release = threading.Event()

    def blocking(idx, batch):
        in_search.set()
        assert release.wait(timeout=30)
        return flat.search_qadc(idx, batch, r=5, keep=0.05)

    with SearchServer(index, batch_size=4, max_wait_ms=1, search_fn=blocking) as srv:
        first = srv.submit(base[0])
        assert in_search.wait(timeout=30)
        in_search.clear()
        later = [srv.submit(base[i]) for i in (1, 2, 3)]
        deadline = time.monotonic() + 10
        while srv._exec_q.empty() and time.monotonic() < deadline:
            time.sleep(0.005)
        assert not srv._exec_q.empty(), "collector did not overlap collection"
        release.set()
        assert first.result(timeout=TIMEOUT)[1][0] == 0
        for i, f in enumerate(later):
            assert f.result(timeout=TIMEOUT)[1][0] == i + 1


def _ivf_index(seed: int, parts: int):
    """An IVF 16x4 index of 4,000 x 32 normal vectors, trained by the port."""
    base = np.random.default_rng(seed).normal(size=(4000, 32)).astype(np.float32)
    coarse = ivf.train_coarse(1, base, parts, iters=5, device="cpu")
    a = assign_nearest(torch.from_numpy(base), coarse).long()
    pq = train_pq(2, torch.from_numpy(base) - coarse[a], 16, 4, iters=5)
    return ivf.add(ivf.IVFIndex.create(pq, coarse), base), base


def test_serve_sharded_search_fn():
    """SearchServer over a partition-sharded IVF index through search_fn:
    the sharded search under the batching worker."""
    index, base = _ivf_index(5, 16)
    mesh = make_mesh(8, device="cpu")
    sharded = shard_ivf_partitions(index, mesh)
    fn = partial(search_qadc_ivf_sharded, r=20, ma=4, keep=0.05, mesh=mesh)
    queries = base[:6] + 0.01
    with SearchServer(sharded, batch_size=8, max_wait_ms=20,
                      search_fn=lambda idx, b: fn(idx, b)) as srv:
        results = [f.result(timeout=TIMEOUT) for f in [srv.submit(q) for q in queries]]
    _, l_ref = fn(sharded, queries)
    for i, (_, lab) in enumerate(results):
        np.testing.assert_array_equal(lab, l_ref[i].numpy())


def test_serve_restart_from_sharded_checkpoint(tmp_path):
    """Stop a server, start a new one over the sharded checkpoint saved
    while serving (loaded shard by shard): the same answers."""
    index, base = _ivf_index(6, 8)
    mesh = make_mesh(4, device="cpu")
    fn = partial(search_qadc_ivf_sharded, r=10, ma=4, keep=0.05, mesh=mesh)
    queries = base[:5] + 0.01
    with SearchServer(shard_ivf_partitions(index, mesh), batch_size=4, max_wait_ms=10,
                      search_fn=lambda idx, b: fn(idx, b)) as srv:
        before = [srv.submit(q).result(timeout=TIMEOUT) for q in queries]
        save_index_sharded(str(tmp_path / "ck"), index, num_shards=1)
    restored = load_sharded_index(str(tmp_path / "ck"), mesh)
    with SearchServer(restored, batch_size=4, max_wait_ms=10,
                      search_fn=lambda idx, b: fn(idx, b)) as srv2:
        after = [srv2.submit(q).result(timeout=TIMEOUT) for q in queries]
    for (d0, l0), (d1, l1) in zip(before, after):
        np.testing.assert_array_equal(l0, l1)
        np.testing.assert_allclose(d0, d1, rtol=RTOL)
