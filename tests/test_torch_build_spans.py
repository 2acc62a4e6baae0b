"""The build's spans and counters (ivf.train_coarse, train_opq, ivf.add):
a recording around a small build holds one `build.add` with a
`build.encode` child for each chunk of vectors encoded, `build.vectors`
and `build.part_max` equal to what the index says, and one span for each
training; with no recording open the same build reads no clock and gives
the same index and quantizers bit for bit. IVF-8 and OPQ 16x4 over 3,000 x
32 vectors (numpy seed 19), on the CPU."""

import time

import numpy as np
import pytest
import torch

from qadc_tpu_torch.eval.trace import recording
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.quantizers.opq import train_opq

torch.set_num_threads(1)

N, CHUNK = 3000, 700        # five chunks, the last of 200 vectors


@pytest.fixture(scope="module")
def base():
    return np.random.default_rng(19).normal(size=(N, 32)).astype(np.float32)


def _train(base):
    coarse = ivf.train_coarse(1, base, 8, iters=3, balance_cap=3.0, device="cpu")
    opq = train_opq(2, base[:1500], 16, 4, opq_iters=1, kmeans_iters=3, device="cpu")
    return coarse, opq


def _build(base, coarse, opq):
    return ivf.add(ivf.IVFIndex.create(opq, coarse), base, encode_batch=CHUNK)


def _no_clock():
    raise AssertionError("a build span read the clock with no recording open")


def test_a_recording_holds_the_add_its_chunks_and_counters(base):
    coarse, opq = _train(base)
    with recording() as rec:
        index = _build(base, coarse, opq)
    add, = [s for s in rec.spans if s.name == "build.add"]
    encodes = [s for s in rec.spans if s.name == "build.encode"]
    assert {s.name for s in rec.spans} == {"build.add", "build.encode"}
    assert len(encodes) == -(-N // CHUNK) == 5
    for s in encodes:
        assert s.parent == add.id and s.batch == add.batch
        assert add.start_ns <= s.start_ns <= s.end_ns <= add.end_ns
    got = {c.name: c for c in rec.counts}
    assert len(rec.counts) == 2 and set(got) == {"build.vectors", "build.part_max"}
    assert got["build.vectors"].value == N == index.n
    assert got["build.part_max"].value == index.max_part_size > 0
    assert all(c.batch == add.batch for c in rec.counts)


def test_each_training_records_one_span(base):
    with recording() as rec:
        _train(base)
    assert [s.name for s in rec.spans] == ["build.train_coarse", "build.train_opq"]
    assert all(s.parent is None for s in rec.spans)
    assert rec.counts == []


def test_off_the_build_reads_no_clock_and_builds_the_same_index(base, monkeypatch):
    with recording():
        coarse, opq = _train(base)
        on = _build(base, coarse, opq)
    monkeypatch.setattr(time, "time_ns", _no_clock)
    coarse_off, opq_off = _train(base)
    off = _build(base, coarse_off, opq_off)
    assert torch.equal(coarse, coarse_off)
    assert torch.equal(opq.rotation, opq_off.rotation)
    assert torch.equal(opq.centroids, opq_off.centroids)
    for field in ("codes", "labels", "part_sizes", "coarse_centroids"):
        assert torch.equal(getattr(on, field), getattr(off, field)), field
    assert (on.n, on.max_part_size) == (off.n, off.max_part_size)
