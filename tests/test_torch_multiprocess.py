"""The port's sharded IVF search across two OS processes over gloo (the
cases of tests/test_multiprocess.py).

Each worker (tests/torch_multiproc_worker.py) joins the group through the
QADC_* environment path of dist.mesh.maybe_init_distributed, holds 2 of a
4-shard mesh's shards, loads only its own partition rows of a checkpoint
that the JAX package wrote, and runs the sharded search with its gathers
issued asynchronously (overlap_chunks=2). Every process's result equals the
port's single-process 4-shard mesh bit for bit (the same arithmetic on the
same rows) and the JAX package's 4-device result: labels equal, distances
rtol 1e-5 (float32 sums in another order).

Workers run with one thread each, under a time limit: on a timeout the test
kills their whole process group. Ports come from a bound socket.
"""

import os
import signal
import socket
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from qadc_tpu.dist.mesh import make_mesh as jmake_mesh
from qadc_tpu.dist.sharded_ivf import search_qadc_ivf_sharded as jsearch
from qadc_tpu.dist.sharded_ivf import shard_ivf_partitions as jshard
from qadc_tpu.index import ivf as jivf
from qadc_tpu.io.checkpoint import save_index_sharded
from qadc_tpu.ops.knn import assign_nearest
from qadc_tpu.quantizers.pq import train_pq
from qadc_tpu_torch.dist.mesh import make_mesh
from qadc_tpu_torch.dist.sharded_ivf import (load_sharded_index, search_qadc_ivf_sharded,
                                             shard_ivf_partitions)
from torch_parity import as_np, to_port

R, MA, KEEP, SHARDS = 20, 4, 0.05, 4
WORKER_TIMEOUT = 120   # seconds a pair of workers may take
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_mp")
    rng = np.random.default_rng(21)
    dim, n = 16, 6000
    centers = rng.normal(scale=3.0, size=(8, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 8, n)] + rng.normal(size=(n, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 8, 8)] + rng.normal(size=(8, dim))).astype(np.float32)
    coarse = jivf.train_coarse(jax.random.PRNGKey(0), base[:3000], 8, iters=8)
    a = np.asarray(assign_nearest(base[:3000], coarse))
    pq = train_pq(jax.random.PRNGKey(1), base[:3000] - np.asarray(coarse)[a], 16, 4, iters=8)
    index = jivf.add(jivf.IVFIndex.create(pq, coarse), base)
    ckpt = str(tmp / "ckpt")
    save_index_sharded(ckpt, index, num_shards=2)
    qfile = _query_file(tmp / "queries.npz", queries)
    return index, queries, ckpt, qfile, tmp


def _query_file(path, queries, overlap: int = 2) -> str:
    np.savez(path, queries=queries, r=R, ma=MA, keep=KEEP, shards=SHARDS, overlap=overlap)
    return str(path)


def _spawn_workers(ckpt, qfile, tmp, tag, progress_dir=None):
    worker = os.path.join(os.path.dirname(__file__), "torch_multiproc_worker.py")
    port = _free_port()
    procs, outs = [], []
    for i in range(2):
        out = str(tmp / f"out_{tag}_{i}.npz")
        outs.append(out)
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        env.update(QADC_COORDINATOR=f"127.0.0.1:{port}", QADC_NUM_PROCESSES="2",
                   QADC_PROCESS_ID=str(i), OMP_NUM_THREADS="1")
        argv = [sys.executable, worker, ckpt, qfile, out]
        if progress_dir is not None:
            argv.append(str(progress_dir))
        procs.append(subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True,
                                      start_new_session=True))
    return procs, outs


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
        p.wait()


def _join_workers(procs):
    deadline = time.monotonic() + WORKER_TIMEOUT
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    except subprocess.TimeoutExpired:
        _kill(procs)
        raise
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"


def _port_expected(index, queries):
    """The port's search over a single-process 4-shard mesh."""
    mesh = make_mesh(SHARDS, device="cpu")
    sharded = shard_ivf_partitions(to_port(index), mesh)
    d, lab = search_qadc_ivf_sharded(sharded, queries, r=R, ma=MA, keep=KEEP, mesh=mesh)
    return as_np(d), as_np(lab)


def _jax_expected(index, queries):
    """The JAX package's search over a 4-device mesh."""
    mesh = jmake_mesh(SHARDS)
    d, lab = jsearch(jshard(index, mesh), queries, r=R, ma=MA, keep=KEEP, mesh=mesh,
                     interpret=True)
    return np.asarray(d), np.asarray(lab)


def _assert_results(outs, port, ref):
    for out in outs:  # every process holds the same merged result
        got = np.load(out)
        np.testing.assert_array_equal(got["l"], port[1])
        np.testing.assert_array_equal(got["d"], port[0])
        np.testing.assert_array_equal(got["l"], ref[1])
        np.testing.assert_allclose(got["d"], ref[0], rtol=1e-5)


def test_two_process_distributed_matches_single_process(built):
    index, queries, ckpt, qfile, tmp = built
    procs, outs = _spawn_workers(ckpt, qfile, tmp, "eq")
    _join_workers(procs)
    _assert_results(outs, _port_expected(index, queries), _jax_expected(index, queries))


def test_reshard_on_load_4_shards_2_processes(built):
    """A checkpoint written for 4 processes restarts on 2: each process
    reads two shard files' rows."""
    index, queries, _, qfile, tmp = built
    ckpt4 = str(tmp / "ckpt4")
    save_index_sharded(ckpt4, index, num_shards=4)
    procs, outs = _spawn_workers(ckpt4, qfile, tmp, "rs")
    _join_workers(procs)
    _assert_results(outs, _port_expected(index, queries), _jax_expected(index, queries))


def test_kill_and_restart_bitmatches(built):
    """SIGKILL one worker after its first batch; a restarted group reloads
    only its shards and the whole run matches bit for bit."""
    index, queries, ckpt, _, tmp = built
    rng = np.random.default_rng(7)
    q2 = np.stack([queries, queries + rng.normal(size=queries.shape).astype(np.float32) * 0.1])
    qfile2 = _query_file(tmp / "queries2.npz", q2, overlap=1)
    exp = [_port_expected(index, b) for b in q2]
    port = (np.concatenate([e[0] for e in exp]), np.concatenate([e[1] for e in exp]))
    ref = [_jax_expected(index, b) for b in q2]
    ref = (np.concatenate([e[0] for e in ref]), np.concatenate([e[1] for e in ref]))

    prog = tmp / "prog"
    prog.mkdir()
    procs, _ = _spawn_workers(ckpt, qfile2, tmp, "k1", prog)
    try:
        deadline = time.monotonic() + WORKER_TIMEOUT
        while not ((prog / "p0_b0.done").exists() and (prog / "p1_b0.done").exists()):
            if time.monotonic() > deadline:
                pytest.fail("workers never finished batch 0")
            for p in procs:
                assert p.poll() is None or p.returncode == 0, "a worker died early"
            time.sleep(0.05)
        os.killpg(procs[1].pid, signal.SIGKILL)  # a host fails mid-run
        procs[1].wait()
        # The survivor cannot finish batch 1's collectives alone: tear it
        # down, as a launcher does once it declares the peer dead.
        try:
            procs[0].wait(timeout=10)
        except subprocess.TimeoutExpired:
            pass
    finally:
        _kill(procs)
        for p in procs:
            p.stdout.close()

    for f in prog.iterdir():
        f.unlink()
    procs2, outs2 = _spawn_workers(ckpt, qfile2, tmp, "k2", prog)
    _join_workers(procs2)
    _assert_results(outs2, port, ref)


def test_load_sharded_index_single_process(built):
    """Single-process load paths: reshard-on-load of a 2-shard checkpoint
    into a 4-shard mesh, and a 1-shard checkpoint."""
    index, queries, ckpt, _, tmp = built
    mesh = make_mesh(SHARDS, device="cpu")
    loaded = load_sharded_index(ckpt, mesh)
    d, lab = search_qadc_ivf_sharded(loaded, queries, r=R, ma=MA, keep=KEEP, mesh=mesh)
    port = _port_expected(index, queries)
    np.testing.assert_array_equal(as_np(lab), port[1])
    np.testing.assert_array_equal(as_np(d), port[0])

    ckpt1 = str(tmp / "ckpt1")
    save_index_sharded(ckpt1, index, num_shards=1)
    loaded = load_sharded_index(ckpt1, mesh)
    assert loaded.n == index.n and loaded.codes.device == torch.device("cpu")
    np.testing.assert_array_equal(as_np(loaded.part_sizes)[: index.part_count],
                                  np.asarray(index.part_sizes))
