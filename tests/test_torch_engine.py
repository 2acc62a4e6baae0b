"""The port's QueryEngine (qadc_tpu_torch/engine.py) against its own searches
and against qadc_tpu's engine, on the CPU; its metrics and tracing helpers
(eval/metrics.py, eval/trace.py).

Indexes are trained and built by the JAX package (5,000 x 32, numpy seed 2,
as tests/test_engine.py draws them) and carried across by the checkpoint.

Tolerances:
  - the engine against the port's own search, batch by batch with the tail
    padded as the engine pads it: exact (the same calls);
  - against the JAX engine with adc_type="adc" (exact ADC on both sides):
    labels equal, distances rtol 1e-5 (float32 sums in another order);
  - the CSV strings: equal, character for character.
"""

import contextlib
import functools
import itertools
import time

import jax
import numpy as np
import pytest
import torch

from qadc_tpu.engine import QueryEngine as JQueryEngine
from qadc_tpu.eval.metrics import QueryMetrics as JQueryMetrics
from qadc_tpu.index import flat as jflat, ivf as jivf
from qadc_tpu.io.checkpoint import save_index as jsave_index
from qadc_tpu.ops.knn import assign_nearest
from qadc_tpu.quantizers.pq import train_pq
from qadc_tpu_torch import engine as engine_mod
from qadc_tpu_torch.engine import QueryEngine, phase_split
from qadc_tpu_torch.eval.metrics import PhaseTimer, QueryMetrics
from qadc_tpu_torch.eval.trace import annotate, recording, span, timed, trace
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.io.checkpoint import load_index

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

RTOL = 1e-5
N, DIM, NQ = 5000, 32, 21


@functools.cache
def _data():
    rng = np.random.default_rng(2)
    centers = rng.normal(scale=3.0, size=(10, DIM)).astype(np.float32)
    base = (centers[rng.integers(0, 10, N)] + rng.normal(size=(N, DIM))).astype(np.float32)
    queries = (centers[rng.integers(0, 10, NQ)] + rng.normal(size=(NQ, DIM))).astype(np.float32)
    return base, queries


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """{name: (jax index, port index)}: flat 16x4, IVF-8 16x4, flat 8x8."""
    base, _ = _data()
    tmp = tmp_path_factory.mktemp("engine")
    pq = train_pq(jax.random.PRNGKey(0), base, 16, 4, iters=8)
    coarse = jivf.train_coarse(jax.random.PRNGKey(1), base, 8, iters=5)
    a = np.asarray(assign_nearest(base, coarse))
    rpq = train_pq(jax.random.PRNGKey(2), base - np.asarray(coarse)[a], 16, 4, iters=8)
    pq8 = train_pq(jax.random.PRNGKey(3), base, 8, 8, iters=3)
    built = {"flat": jflat.add(jflat.FlatIndex.create(pq), base),
             "ivf": jivf.add(jivf.IVFIndex.create(rpq, coarse), base),
             "flat8": jflat.add(jflat.FlatIndex.create(pq8), base)}
    out = {}
    for name, index in built.items():
        jsave_index(str(tmp / name), index)
        out[name] = index, load_index(str(tmp / name), device="cpu")
    return out


def _port_search(index, queries, adc_type, r, ma, keep):
    if isinstance(index, ivf.IVFIndex):
        if adc_type == "qadc":
            return ivf.search_qadc(index, queries, r=r, ma=ma, keep=keep)
        return ivf.search_adc(index, queries, r=r, ma=ma)
    if adc_type == "qadc":
        return flat.search_qadc(index, queries, r=r, keep=keep)
    return flat.search_adc(index, queries, r=r)


@pytest.mark.parametrize("name,adc_type", [("flat", "qadc"), ("flat", "adc"),
                                           ("ivf", "qadc"), ("ivf", "adc")])
def test_engine_equals_the_ports_search_batch_by_batch(indexes, name, adc_type):
    _, index = indexes[name]
    _, queries = _data()
    r, ma, keep, b = 20, 4, 0.05, 8
    d, lab, metrics = QueryEngine(index, r=r, ma=ma, keep=keep, adc_type=adc_type,
                                  batch_size=b).run(queries)
    assert metrics.count == 0  # no measurement unless asked
    assert d.shape == lab.shape == (NQ, r)
    for s in range(0, NQ, b):  # 8, 8, then a tail of 5 padded to 8
        batch = np.zeros((b, DIM), np.float32)
        real = queries[s:s + b]
        batch[:len(real)] = real
        wd, wl = _port_search(index, torch.from_numpy(batch), adc_type, r, ma, keep)
        np.testing.assert_array_equal(lab[s:s + b], wl[:len(real)].numpy())
        np.testing.assert_array_equal(d[s:s + b], wd[:len(real)].numpy())


@pytest.mark.parametrize("name,ma", [("ivf", 4), ("flat", 1), ("flat8", 1)])
def test_engine_adc_matches_the_jax_engine(indexes, name, ma):
    jindex, index = indexes[name]
    _, queries = _data()
    jd, jl, _ = JQueryEngine(jindex, r=20, ma=ma, adc_type="adc", batch_size=8).run(queries)
    d, lab, _ = QueryEngine(index, r=20, ma=ma, adc_type="adc", batch_size=8).run(queries)
    np.testing.assert_allclose(d, np.asarray(jd), rtol=RTOL)
    np.testing.assert_array_equal(lab, np.asarray(jl))


def test_metrics_strings_match_the_reference():
    ours, theirs = QueryMetrics(), JQueryMetrics()
    for vals in ((10.4, 0.0, 3.6, 120.5), (11.6, 2.0, 4.4, 99.5), (0.0, 0.0, 0.0, 0.2)):
        ours.add(*vals)
        theirs.add(*vals)
    assert QueryMetrics.HEADER == JQueryMetrics.HEADER
    assert ours.csv_row() == theirs.csv_row()
    assert ours.averaged() == QueryMetrics(*(getattr(theirs.averaged(), f) for f in
                                             ("index_us", "rotate_us", "table_us",
                                              "scan_us", "count")))
    assert QueryMetrics().csv_row() == JQueryMetrics().csv_row() == "0,0,0,0"
    timer = PhaseTimer()
    assert timer.lap_us() >= 0.0


PHASE_SPANS = {"ivf": ["front.assign", "front.rotate", "front.tables", "front.keep_bound",
                       "front.int8"],
               "flat": ["front.rotate", "front.tables", "front.keep_bound", "front.int8"]}


def _phases_us(m):
    return np.array([m.index_us, m.rotate_us, m.table_us, m.scan_us])


@contextlib.contextmanager
def _kept_recordings(monkeypatch):
    """Keep each Recording that measure_phases opens."""
    kept, real = [], engine_mod.recording

    @contextlib.contextmanager
    def keep(**kw):
        with real(**kw) as rec:
            kept.append(rec)
            yield rec

    monkeypatch.setattr(engine_mod, "recording", keep)
    yield kept


@pytest.mark.parametrize("name", ["ivf", "flat"])
def test_measure_phases_attributes_the_full_search(indexes, name, monkeypatch):
    """index + rotate + table + scan is the search span's time, and each
    phase is the time of its spans: a clock that advances 1 us a read makes
    every search alike, so the phases equal one search's split."""
    _, index = indexes[name]
    _, queries = _data()
    engine = QueryEngine(index, r=20, ma=4, keep=0.05, batch_size=8)
    ticks = itertools.count(0, 1000)
    monkeypatch.setattr(time, "time_ns", lambda: next(ticks))
    qs = torch.from_numpy(queries[:8])
    with recording() as rec:
        engine.search(qs)
    (split,) = phase_split(rec.spans)
    (search,) = [s for s in rec.spans if s.name == "search"]
    assert sum(split) == search.end_ns - search.start_ns
    m = engine.measure_phases(queries[:8], iters=5, warmup=1)
    assert m.count == 1
    index_ns, rotate_ns, table_ns, scan_ns = split
    want = ((index_ns + rotate_ns, 0.0) if name == "ivf" else (0.0, rotate_ns))
    np.testing.assert_allclose(_phases_us(m) * 8 * 1e3, (*want, table_ns, scan_ns))
    assert (m.index_us if name == "flat" else m.rotate_us) == 0.0
    assert index_ns == 0 if name == "flat" else index_ns > 0
    assert min(split) > 0 or name == "flat"


@pytest.mark.parametrize("name", ["ivf", "flat"])
def test_measure_phases_sum_to_the_median_search(indexes, name, monkeypatch):
    _, index = indexes[name]
    _, queries = _data()
    engine = QueryEngine(index, r=20, ma=4, keep=0.05, batch_size=8)
    with _kept_recordings(monkeypatch) as kept:
        m = engine.measure_phases(queries[:8], iters=7, warmup=1)
    (rec,) = kept
    searches = sorted(s.end_ns - s.start_ns for s in rec.spans if s.name == "search")
    assert len(searches) == 7
    np.testing.assert_allclose(_phases_us(m).sum() * 8 * 1e3, searches[3], rtol=1e-9)


@pytest.mark.parametrize("name", ["ivf", "flat"])
def test_measure_phases_inside_an_open_span(indexes, name, monkeypatch):
    """A span open around measure_phases (with its own recording) leaves
    each search's phases to that search: non-negative, summing to the
    median search."""
    _, index = indexes[name]
    _, queries = _data()
    engine = QueryEngine(index, r=20, ma=4, keep=0.05, batch_size=8)
    with _kept_recordings(monkeypatch) as kept, recording() as outer, span("job"):
        m = engine.measure_phases(queries[:8], iters=5, warmup=1)
    (rec,) = kept
    splits = phase_split(rec.spans)
    assert len(splits) == 5 and all(min(split) >= 0 for split in splits)
    assert (_phases_us(m) >= 0).all() and m.table_us > 0 and m.scan_us > 0
    searches = sorted(s.end_ns - s.start_ns for s in rec.spans if s.name == "search")
    np.testing.assert_allclose(_phases_us(m).sum() * 8 * 1e3, searches[2], rtol=1e-9)
    (job,) = [s for s in outer.spans if s.name == "job"]  # and the warm-up's spans
    assert {s.batch for s in rec.spans} == {job.batch}     # the batch id is the job's
    assert all(s.parent == job.id for s in rec.spans if s.name == "search")


@pytest.mark.parametrize("name", ["ivf", "flat"])
def test_phases_are_nonnegative_and_in_span_order(indexes, name, monkeypatch):
    _, index = indexes[name]
    _, queries = _data()
    engine = QueryEngine(index, r=20, ma=4, keep=0.05, batch_size=8)
    with _kept_recordings(monkeypatch) as kept:
        m = engine.measure_phases(queries[:8], iters=3, warmup=0)
    assert (_phases_us(m) >= 0).all() and m.scan_us > 0
    for split in phase_split(kept[0].spans):
        assert min(split) >= 0
    by_batch = {}
    for s in sorted(kept[0].spans, key=lambda s: s.start_ns):
        by_batch.setdefault(s.batch, []).append(s)
    assert len(by_batch) == 3
    for batch in by_batch.values():
        search = next(s for s in batch if s.name == "search")
        front = [s for s in batch if s.name.startswith("front.")]
        assert [s.name for s in front] == PHASE_SPANS[name]
        assert all(s.parent == search.id for s in front)
        for a, b in zip(front, front[1:]):
            assert a.end_ns <= b.start_ns
        assert search.start_ns <= front[0].start_ns and front[-1].end_ns <= search.end_ns


def test_measure_phases_on_the_cpu_clock(indexes):
    _, index = indexes["ivf"]
    _, queries = _data()
    _, _, m = QueryEngine(index, r=20, ma=4, keep=0.05, batch_size=8).run(
        queries, with_metrics=True)
    avg = m.averaged()
    assert avg.scan_us > 0 and avg.table_us >= 0 and avg.index_us >= 0
    assert avg.rotate_us == 0.0
    assert len(m.csv_row().split(",")) == 4


def test_engine_rejects_qadc_on_8bit_and_unknown_types(indexes):
    _, index8 = indexes["flat8"]
    with pytest.raises(ValueError, match="sq_bits"):
        QueryEngine(index8, adc_type="qadc")
    with pytest.raises(ValueError, match="adc_type"):
        QueryEngine(index8, adc_type="bogus")
    with pytest.raises(TypeError, match="unsupported"):
        QueryEngine(object.__new__(type("X", (), {"pq": index8.pq})), adc_type="adc")


def test_engine_warns_when_the_index_is_smaller_than_r(indexes, capsys):
    _, index = indexes["flat"]
    small = flat.add(flat.FlatIndex.create(index.pq), _data()[0][:30])
    d, lab, _ = QueryEngine(small, r=50, keep=0.5, adc_type="adc", batch_size=4).run(
        _data()[1][:6])
    assert d.shape == (6, 50) and np.isinf(d[:, 30:]).all()
    assert "fewer than r=50 results for 6/6 queries" in capsys.readouterr().err


def test_trace_names_the_annotated_spans(tmp_path):
    with trace(str(tmp_path / "t")) as prof:
        with annotate("qadc.phase.probe"):
            torch.ones(64).sum()
    assert any(e.key == "qadc.phase.probe" for e in prof.key_averages())
    with open(tmp_path / "t" / "trace.json") as f:
        assert "qadc.phase.probe" in f.read()


def test_timed_is_the_median_call_on_the_cpu_clock():
    calls = []
    seconds = timed(lambda x: calls.append(x), 7, iters=5, warmup=2, device="cpu")
    assert calls == [7] * 7 and 0.0 <= seconds < 1.0
