"""The port's spans and counters (qadc_tpu_torch/eval/trace.py) and the
benchmark's reductions of them (portbench/spans.py).

On the CPU: a span that is off reads no clock and records nothing; spans
nest, carry their parents and batch ids, and keep each thread's stack
apart; a counter given a tensor reads it only when the recording closes;
an IVF grouped batch and a flat batch answer bit for bit the same with the
recording on and off, and record exactly the spans and counters that
PERF.md §3 names; the server's queue waits share their batch's id; the
reductions split idle gaps, attribute device ops and take self times on
synthetic events. Indexes: IVF-8 and flat 16x4 over 4,000 x 32 vectors
(numpy seed 11), trained by the port.

On a card (skipped without one), the clock: the launch of a sleep kernel
lies inside the span around it on torch.profiler's host clock, and after
portbench/spans.align the kernel starts after its launch and within 50 us
of the span's start (the profiler's own device times can be off by a few
hundred microseconds, PERF.md §6); `measure_phases` places CUDA events at
its phase spans alone, and its phases sum to about what an untraced search
takes.

    python -m pytest --noconftest tests/test_torch_spans.py -k card -s   # on a card
"""

import contextlib
import threading
import time
from collections import namedtuple

import numpy as np
import pytest
import torch

from portbench import spans as red
from qadc_tpu_torch.engine import QueryEngine
from qadc_tpu_torch.eval import trace
from qadc_tpu_torch.eval.trace import count, recording, span
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.quantizers.pq import train_pq
from qadc_tpu_torch.serve import SearchServer

torch.set_num_threads(1)

R, MA, KEEP, B = 20, 4, 0.05, 8
ENGINE = {"engine.batch", "engine.copy_in", "search", "engine.copy_out"}
FRONT = {"front.rotate", "front.tables", "front.keep_bound", "front.int8"}
IVF_SPANS = ENGINE | FRONT | {"front.assign", "route", "scan", "screen", "rerank"}
FLAT_SPANS = ENGINE | FRONT | {"scan", "screen", "rerank"}
IVF_COUNTS = {"route.groups", "scan.rows"}
FLAT_COUNTS = set()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the profiler's device clock exists only there")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(11)
    base = rng.normal(size=(4000, 32)).astype(np.float32)
    queries = (base[:B] + 0.05 * rng.normal(size=(B, 32))).astype(np.float32)
    pq = train_pq(0, base, 16, 4, iters=4, device="cpu")
    coarse = ivf.train_coarse(1, base, 8, iters=4, device="cpu")
    return {"ivf": ivf.add(ivf.IVFIndex.create(pq, coarse), base),
            "flat": flat.add(flat.FlatIndex.create(pq), base)}, queries


def _engine(index):
    return QueryEngine(index, r=R, ma=MA, keep=KEEP, batch_size=B)


def test_off_reads_no_clock_and_records_nothing(indexes, monkeypatch):
    built, queries = indexes

    def no_clock():
        raise AssertionError("a span read the clock while off")

    monkeypatch.setattr(time, "time_ns", no_clock)
    assert span("a") is span("b", path="x")          # one shared object, nothing made
    with span("a") as sp:
        sp.set(path="x")
        count("n", 3)
    assert trace.stamp() is None
    trace.add_span("serve.queue_wait", None)
    for index in built.values():
        _engine(index).run(queries)


def test_spans_nest_with_parents_and_batch_ids():
    with recording() as rec:
        with span("a", k=1) as a:
            with span("b") as b:
                with span("c"):
                    pass
            b.set(path="p")
        with span("d"):
            pass
        b_e = trace.add_span("e", trace.stamp(), a.batch)
    got = {s.name: s for s in rec.spans}
    assert [s.name for s in rec.spans] == ["c", "b", "a", "d", "e"]     # in closing order
    assert got["a"].parent is None and got["b"].parent == got["a"].id
    assert got["c"].parent == got["b"].id
    assert got["a"].batch == got["b"].batch == got["c"].batch == got["a"].id
    assert got["d"].batch == got["d"].id != got["a"].batch
    assert got["e"].batch == b_e == got["a"].batch and got["e"].parent is None
    assert got["a"].attrs == {"k": 1} and got["b"].attrs == {"path": "p"}
    for s in rec.spans:
        assert s.start_ns <= s.end_ns and s.device_start_ns is None
    assert got["a"].start_ns <= got["b"].start_ns <= got["c"].start_ns
    assert got["c"].end_ns <= got["b"].end_ns <= got["a"].end_ns


def test_two_threads_keep_their_own_stacks():
    barrier = threading.Barrier(2, timeout=30)
    roots = {}

    def work(tag):
        with span(f"root.{tag}") as root:
            roots[tag] = root.batch
            barrier.wait()
            with span(f"child.{tag}"):
                barrier.wait()
                count(f"n.{tag}", 1)

    with recording() as rec:
        threads = [threading.Thread(target=work, args=(t,)) for t in "xy"]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    got = {s.name: s for s in rec.spans}
    for tag in "xy":
        root, child = got[f"root.{tag}"], got[f"child.{tag}"]
        assert child.parent == root.id and child.batch == root.batch == roots[tag]
        assert child.thread == root.thread
        (c,) = [c for c in rec.counts if c.name == f"n.{tag}"]
        assert c.batch == root.batch
    assert got["root.x"].thread != got["root.y"].thread
    assert roots["x"] != roots["y"]


def test_a_tensor_counter_is_read_when_the_recording_closes():
    value = torch.tensor(3)
    with recording() as rec:
        with span("a"):
            count("route.groups", value)
            count("n", 7)
        assert isinstance(rec.counts[0].value, torch.Tensor)
        value += 2                        # read at close, not when counted
    assert [(c.name, c.value) for c in rec.counts] == [("route.groups", 5.0), ("n", 7)]
    assert all(c.batch == rec.spans[0].batch for c in rec.counts)


@pytest.mark.parametrize("name", ["ivf", "flat"])
def test_answers_are_the_same_with_the_recording_on(indexes, name):
    built, queries = indexes
    engine = _engine(built[name])
    d_off, l_off, _ = engine.run(queries)
    with recording():
        d_on, l_on, _ = engine.run(queries)
    np.testing.assert_array_equal(l_on, l_off)
    np.testing.assert_array_equal(d_on, d_off)


@pytest.mark.parametrize("name,want_spans,want_counts,path", [
    ("ivf", IVF_SPANS, IVF_COUNTS, "ivf.grouped"),
    ("flat", FLAT_SPANS, FLAT_COUNTS, "flat.window"),
])
def test_a_batch_records_the_named_spans(indexes, name, want_spans, want_counts, path):
    built, queries = indexes
    with recording() as rec:
        _engine(built[name]).run(queries[:B - 3])          # a padded batch
    assert {s.name for s in rec.spans} == want_spans
    assert [c.name for c in rec.counts] == sorted(want_counts)
    assert len({s.batch for s in rec.spans}) == 1
    assert all(c.batch == rec.spans[0].batch for c in rec.counts)
    (search,) = [s for s in rec.spans if s.name == "search"]
    assert search.attrs == {"path": path}
    got = {c.name: c.value for c in rec.counts}
    if name == "ivf":
        assert 1 <= got["route.groups"] <= B * MA
        assert 1 <= got["scan.rows"] <= got["route.groups"] * built[name].codes.shape[1]


def test_scan_rows_counts_the_real_rows_of_the_probed_lists(indexes):
    """scan.rows: ceil(size / cpr) of each probed partition (one group each at
    B * MA pairs of G = 128), summed; route.groups their number."""
    built, queries = indexes
    index = built["ivf"]
    q = torch.from_numpy(queries)
    parts, _ = ivf.assign_queries(index, q, MA)
    probed = torch.unique(parts.long())
    want = int(((index.part_sizes[probed] + index.cpr - 1) // index.cpr).sum())
    with recording() as rec:
        ivf.search_qadc(index, q, r=R, ma=MA, keep=KEEP)
    got = {c.name: c.value for c in rec.counts}
    assert got == {"route.groups": probed.numel(), "scan.rows": want}


def test_flat_ranges_record_a_scan_each_and_their_merge(indexes):
    built, queries = indexes
    index = built["flat"]
    with recording() as rec:
        flat.search_qadc(index, torch.from_numpy(queries), r=R, keep=KEEP,
                         scan_budget_bytes=index.n_pad // 16 * 128 * 4 // 2)
    names = [s.name for s in rec.spans]
    assert names.count("scan") == 2 and names.count("merge") == 1
    assert names.count("screen") == names.count("rerank") == 2


def test_served_spans_share_their_batch(indexes):
    built, queries = indexes
    with recording() as rec:
        with SearchServer(built["flat"], r=R, keep=KEEP, batch_size=B, max_wait_ms=50) as srv:
            futs = [srv.submit(q) for q in queries[:5]]
            for f in futs:
                f.result(timeout=60)
    waits = [s for s in rec.spans if s.name == "serve.queue_wait"]
    assert len(waits) == 5 and all(s.parent is None for s in waits)
    by_batch = {}
    for s in waits:
        by_batch.setdefault(s.batch, []).append(s)
        assert s.start_ns <= s.end_ns
    assert len({s.thread for s in waits}) == 1                 # the collector's
    fills = [c.value for c in rec.counts if c.name == "serve.fill"]
    assert sorted(fills) == sorted(len(v) for v in by_batch.values())
    searches = [s for s in rec.spans if s.name == "search"]
    assert len(searches) == len(fills)
    assert all(s.thread != waits[0].thread for s in searches)  # the executor's
    assert {s.name for s in rec.spans} <= FLAT_SPANS | {"serve.queue_wait"}


def test_annotate_is_a_span():
    assert trace.annotate is span
    with recording() as rec:
        with trace.annotate("a"):
            pass
    assert [s.name for s in rec.spans] == ["a"]


# ------------------------------------------------ the benchmark's reductions

S = namedtuple("S", "name start_ns end_ns id parent thread batch")
C = namedtuple("C", "name value batch")


def _nested():
    """engine.batch [0, 100) > search [10, 80) > front.tables [20, 30),
    scan [40, 60); a second thread's span that the timeline ignores."""
    return [S("engine.batch", 0, 100, 1, None, 1, 1), S("search", 10, 80, 2, 1, 1, 1),
            S("front.tables", 20, 30, 3, 2, 1, 1), S("scan", 40, 60, 4, 2, 1, 1),
            S("other", 0, 200, 5, None, 2, 5)]


def test_self_time_is_the_duration_less_the_children():
    got = red.self_ns(_nested())
    assert got == {1: 30, 2: 40, 3: 10, 4: 20, 5: 200}


def test_the_gap_split_follows_the_innermost_span_and_sums_to_the_idle_time():
    line = red.Timeline(red.timeline(_nested() + [S("x", 0, 1, 6, None, 2, 6)]))
    ops = [("k", 25, 45, 0), ("k", 50, 55, 0)]
    gaps = red.gap_split(ops, line, -10, 120)
    assert gaps == {"outside spans": 10 + 20, "engine.batch": 10 + 20, "search": 10 + 20,
                    "front.tables": 5, "scan": 5 + 5}
    assert sum(gaps.values()) == 130 - 25


def test_ops_go_to_the_span_of_their_launch_else_of_their_start():
    line = red.Timeline(red.timeline(_nested()))
    ops = [("k1", 70, 90, 7), ("k2", 50, 52, 8), ("k3", 95, 99, 0)]
    launches = [("cudaLaunchKernel", 25, 7), ("cudaLaunchKernel", 45, 8),
                ("cudaMemcpyAsync", 85, 9)]
    by_span, diag = red.attribute(ops, launches, line)
    assert by_span == {"front.tables": 20, "scan": 2, "engine.batch": 4}
    assert diag == {"ops_matched": 2, "ops_unmatched": 1, "launches_without_op": 1}
    by_start, diag = red.attribute(ops, [], line)
    assert by_start == {"search": 20, "scan": 2, "engine.batch": 4}
    assert diag["ops_unmatched"] == 3


def test_align_moves_drifting_device_times_onto_the_host_clock():
    """Device times read 10 ms early at the first launch and 9.7 ms early
    29 ms later; ops launched onto an idle device mark the drift."""
    def drift(t):
        return -10_000_000 + (t - 1_000_000) * 300_000 // 29_000_000

    truth = [("idle", 1_000_000, 1_010_000, 1), ("queued", 15_000_000, 15_020_000, 2),
             ("idle", 30_000_000, 30_005_000, 3)]
    launches = [("cudaLaunchKernel", 1_000_000, 1), ("cudaLaunchKernel", 14_960_000, 2),
                ("cudaLaunchKernel", 30_000_000, 3)]
    seen = [(n, s + drift(s), e + drift(s), c) for n, s, e, c in truth]
    aligned, clock = red.align(seen, launches)
    for (_, s, e, _), (_, ws, we, _) in zip(aligned, truth):
        assert abs(s - ws) < 1_000 and abs(e - we) < 1_000
    assert clock["lag_us"][0] == pytest.approx(-10_000, abs=1)
    assert clock["lag_us"][-1] == pytest.approx(-9_700, abs=1)
    line = red.Timeline([(0, 40_000_000, "search")])
    assert red.gap_split(aligned, line, 0, 40_000_000)["search"] == pytest.approx(
        40_000_000 - 35_000, abs=3_000)
    assert red.align(seen, []) == (seen, None)


def test_the_window_reduces_to_the_layer_metrics():
    spans = _nested()[:4] + [S("screen", 82, 90, 9, 1, 1, 1)]
    counts = [C("route.groups", 3.0, 1), C("route.groups", 2.0, 1), C("route.groups", 4.0, 2)]
    ops = [("k1", 70, 90, 7), ("k2", 84, 95, 8)]
    launches = [("cudaLaunchKernel", 25, 7), ("cudaLaunchKernel", 84, 8)]
    out = red.reduce(spans, counts, ops, launches, 0, 200, batches=2)
    m = out["metrics"]
    assert m["search_host_us.batch"] == pytest.approx(70 / 2e3)
    assert m["engine_host_us.batch"] == pytest.approx(30 / 2e3)
    assert m["front_host_us.batch"] == pytest.approx(10 / 2e3)
    assert m["tail_host_us.batch"] == pytest.approx(8 / 2e3)
    assert m["front_device_share.batch"] == pytest.approx(20 / 25)
    assert m["tail_device_share.batch"] == pytest.approx(11 / 25)
    assert m["groups_per_batch.batch"] == pytest.approx((5 + 4) / 2)
    assert m["idle_outside_spans_us.batch"] == pytest.approx(100 / 2e3)
    gaps = dict(out["breakdown"]["idle_gaps_by_span"])
    assert sum(gaps.values()) == pytest.approx((200 - 25) / 1e9)
    assert out["diagnostics"]["device_outside_spans_share"] == 0.0
    assert red.reduce([], [], ops, [], 0, 200, batches=2)["metrics"] == {}


# ----------------------------------------------------------------- the card


def test_span_clock_is_the_profilers_on_the_card(cuda):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):   # the first window can drop events
        torch.cuda._sleep(1000)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):                       # a profile's first launches are slow
            torch.cuda._sleep(1000)
        torch.cuda.synchronize(cuda)
        with recording() as rec:
            with span("sleep"):
                torch.cuda._sleep(1_000_000)
            torch.cuda.synchronize(cuda)
    events = prof.profiler.kineto_results.events()
    ops = [(e.name(), e.start_ns(), e.end_ns(), e.correlation_id()) for e in events
           if e.device_type() == DeviceType.CUDA]
    launches = [(e.name(), e.start_ns(), e.correlation_id()) for e in events
                if e.device_type() != DeviceType.CUDA and e.name().startswith("cuda")]
    sleep = max(ops, key=lambda o: o[2] - o[1])
    (launch,) = [t for _, t, c in launches if c == sleep[3]]
    aligned = {o[3]: o for o in red.align(ops, launches)[0]}[sleep[3]]
    (s,) = rec.spans
    print(f"{sleep[0]}: kernel start less span start {(sleep[1] - s.start_ns) / 1e3:.3f} us "
          f"as the profiler gives it, {(aligned[1] - s.start_ns) / 1e3:.3f} us after "
          f"spans.align; its launch {(launch - s.start_ns) / 1e3:.3f} us after the span's "
          f"start; span {(s.end_ns - s.start_ns) / 1e3:.3f} us, kernel "
          f"{(sleep[2] - sleep[1]) / 1e3:.3f} us")
    assert s.start_ns <= launch <= s.end_ns          # the span's clock is the profiler's host clock
    assert launch <= aligned[1] < s.start_ns + 50_000


@pytest.mark.parametrize("name", ["ivf", "flat"])
def test_measure_phases_on_the_card(cuda, indexes, name, monkeypatch, tmp_path):
    """The phases come from CUDA events at the boundaries of the phase spans
    alone and sum to the median search's time on the device timeline. Over
    rounds that alternate with untraced searches bracketed by CUDA events
    (eval/trace.timed), the median ratio of the two is within a factor 1.5:
    the events and spans slow a search by 10-15% (PERF.md §6)."""
    from qadc_tpu_torch import engine as engine_mod
    from qadc_tpu_torch.eval.trace import timed
    from qadc_tpu_torch.io.checkpoint import load_index, save_index

    built, queries = indexes
    kept, real = [], engine_mod.recording

    @contextlib.contextmanager
    def keep(**kw):
        with real(**kw) as rec:
            kept.append(rec)
            yield rec

    monkeypatch.setattr(engine_mod, "recording", keep)
    save_index(str(tmp_path / name), built[name])
    index = load_index(str(tmp_path / name), device=cuda)
    engine = _engine(index)
    qs = torch.as_tensor(queries, device=cuda)
    ratios = []
    for _ in range(5):
        plain_us = timed(engine.search, qs, iters=15, warmup=3, device=cuda) * 1e6
        m = engine.measure_phases(queries, iters=15, warmup=3)
        phases = np.array([m.index_us, m.rotate_us, m.table_us, m.scan_us])
        rec = kept[-1]
        searches = sorted(s.device_end_ns - s.device_start_ns for s in rec.spans
                          if s.name == "search")
        assert rec.device_events == set(engine_mod.PHASE_SPANS) and len(searches) == 15
        for s in rec.spans:
            assert (s.device_start_ns is not None) == (s.name in engine_mod.PHASE_SPANS)
        assert (phases >= 0).all() and phases[2] > 0 and phases[3] > 0
        np.testing.assert_allclose(phases.sum() * B * 1e3, searches[7], rtol=1e-6)
        ratios.append(phases.sum() * B / plain_us)
    print(f"{name} phases, us a query: {phases}; their sum over an untraced search, "
          f"by round: {np.round(ratios, 4)}")
    assert 1 / 1.5 < sorted(ratios)[2] < 1.5
