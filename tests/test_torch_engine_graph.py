"""QueryEngine.run's CUDA graphs (qadc_tpu_torch/engine.py).

On the CPU: a CPU index never captures (every `engine.batch` span carries
graph="eager"); a kept graph is dropped when any argument of the search or
the index (the object itself) changes; `measure_phases` still splits an
eager search into its phase spans.

On a card (skipped without one), for every path the engine takes there
(IVF Quick ADC grouped, direct and per-probe; IVF ADC at 4, 8 and 16 bits
and per-probe; flat Quick ADC by windows and by codes; flat ADC at 4, 8 and
16 bits and by codes): replayed batches equal the eager search of the same
padded batch bit for bit (tolerance 0: the same kernels on the same
inputs), and torch.profiler sees the same device ops in a replayed batch as
in an eager one, by name and number, also where the capture itself ran
under the profiler, while `lut_scan.launches` (the wrappers' count) does not
move. Besides: the arrays `run` returned stay as they were through later
batches; two engines on two indexes keep their own graphs; a new `r`
captures anew; under QADC_AUTOTUNE=1 the tuner runs in the warm-up on the
first batch, never in the capture. Indexes: random codes at the bench
geometry (eval/synth), 16 partitions of part_pad 4,096 (one cut to 3,840)
and flat indexes of 100,000 codes (one of 4,096).

    python -m pytest --noconftest tests/test_torch_engine_graph.py -q   # on a card
"""

import collections
import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

from qadc_tpu_torch import autotune
from qadc_tpu_torch import engine as engine_mod
from qadc_tpu_torch.convert import flat_index_from_arrays, ivf_index_from_arrays
from qadc_tpu_torch.engine import QueryEngine, phase_split
from qadc_tpu_torch.eval.synth import (bench_flat_arrays, bench_ivf8_arrays, bench_ivf16_arrays,
                                       bench_ivf_arrays)
from qadc_tpu_torch.eval.trace import recording
from qadc_tpu_torch.kernels import lut_scan

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

DIM, R = 128, 50
# name: (index, adc_type, batch, ma, keep, the search's path, a hand-written
# kernel the path launches or None). At b=64 and ma=4 the IVF search probes
# 256 x 4,096 codes, past the direct path's DIRECT_MAX_CODES; at b=8, 32 x
# 4,096 codes take it. The per-probe paths take an index whose part_pad is no
# multiple of 512; the per-code flat paths one whose 4,096 codes hold fewer
# than 8r windows.
CASES = {
    "ivf-qadc": ("ivf", "qadc", 64, 4, 0.005, "ivf.grouped", "grouped_scan_mma_kernel"),
    "ivf-qadc-direct": ("ivf", "qadc", 8, 4, 0.005, "ivf.direct", "direct_scan_kernel"),
    "ivf-qadc-probe": ("ivf-probe", "qadc", 64, 4, 0.005, "ivf.probe", None),
    "ivf-adc": ("ivf", "adc", 64, 4, 0.005, "ivf.adc4", "grouped_scan_sm_kernel"),
    "ivf-adc-probe": ("ivf-probe", "adc", 64, 4, 0.005, "ivf.adc.probe", None),
    "ivf8-adc": ("ivf8", "adc", 64, 4, 0.005, "ivf.adc8", "grouped_scan8_sm_kernel"),
    "ivf16-adc": ("ivf16", "adc", 64, 4, 0.005, "ivf.adc16", None),
    "flat-qadc": ("flat", "qadc", 64, 1, 0.01, "flat.window", "flat_scan_wgmma_kernel"),
    "flat-qadc-codes": ("flat-small", "qadc", 64, 1, 0.01, "flat.codes", None),
    "flat-adc": ("flat", "adc", 64, 1, 0.01, "flat.adc4", "flat_scan_qm_kernel"),
    "flat-adc-codes": ("flat-small", "adc", 64, 1, 0.01, "flat.adc.codes", None),
    "flat8-adc": ("flat8", "adc", 64, 1, 0.01, "flat.adc8", "flat_scan8_qm_kernel"),
    "flat16-adc": ("flat16", "adc", 64, 1, 0.01, "flat.adc16", None),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs exist only there")
    return torch.device("cuda", 0)


def _probe_arrays(rng):
    """IVF-16 16x4 cut to part_pad 3,840 (240 rows of 16 codes a
    partition, 3,800 of them filled): no multiple of 512, so every search
    takes a per-probe path."""
    arrays, meta = bench_ivf_arrays(rng, parts=16)
    arrays["codes"] = np.ascontiguousarray(arrays["codes"][:, :240])
    arrays["labels"] = np.ascontiguousarray(arrays["labels"][:, :3840])
    arrays["part_sizes"] = np.full((16,), 3800, np.int32)
    return arrays, {**meta, "n": 16 * 3800, "max_part_size": 3800}


# name: its codes, drawn from a generator (seeded by the name's place here)
# on the card or the CPU: IVF-16 at 16x4, 8x8 and 8x16 and the per-probe
# IVF-16 16x4 (65,536 codes each); flat 16x4, 8x8 and 8x16 over 100,000
# codes and flat 16x4 over 4,096. On the CPU, IVF-4 16x4 and flat 16x4 over
# 8,192 codes.
DRAWS = {
    "ivf": lambda rng, on_card: bench_ivf_arrays(rng, parts=16 if on_card else 4),
    "flat": lambda rng, on_card: bench_flat_arrays(rng, 16, 4, n=100_000 if on_card else 8192),
    "ivf-probe": lambda rng, _: _probe_arrays(rng),
    "ivf8": lambda rng, _: bench_ivf8_arrays(rng, parts=16),
    "ivf16": lambda rng, _: bench_ivf16_arrays(rng, parts=16),
    "flat-small": lambda rng, _: bench_flat_arrays(rng, 16, 4, n=4096),
    "flat8": lambda rng, _: bench_flat_arrays(rng, 8, 8, n=100_000),
    "flat16": lambda rng, _: bench_flat_arrays(rng, 8, 16, n=100_000),
}


@functools.cache
def _index(name: str, device: str):
    arrays, meta = DRAWS[name](np.random.default_rng(list(DRAWS).index(name)), device != "cpu")
    convert = ivf_index_from_arrays if name.startswith("ivf") else flat_index_from_arrays
    return convert(arrays, meta, device)


def _queries(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(n, DIM)).astype(np.float32)


def _engine(case: str, device: str, **over):
    name, adc_type, b, ma, keep, _, _ = CASES[case]
    kw = dict(r=R, ma=ma, keep=keep, adc_type=adc_type, batch_size=b) | over
    return QueryEngine(_index(name, device), **kw)


def _eager(engine, queries):
    """The engine's eager search of each batch, padded as `run` pads it,
    under a recording: (dists, labels) on the host and the searches' paths."""
    b = engine.batch_size
    out_d, out_l = [], []
    with recording() as rec:
        for s in range(0, len(queries), b):
            real = queries[s:s + b]
            batch = np.zeros((b, DIM), np.float32)
            batch[:len(real)] = real
            d, lab = engine.search(torch.from_numpy(batch).to(engine.index.device))
            out_d.append(d[:len(real)].cpu())
            out_l.append(lab[:len(real)].cpu())
    paths = {s.attrs.get("path") for s in rec.spans if s.name == "search"}
    return torch.cat(out_d), torch.cat(out_l), paths


def _assert_equal(got, want):
    """Bit for bit: (dists, labels) numpy from `run` against tensors."""
    assert torch.equal(torch.from_numpy(got[0]), want[0])
    assert torch.equal(torch.from_numpy(got[1]), want[1])


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("name", ["ivf", "flat"])
def test_a_cpu_index_never_captures(name):
    engine = QueryEngine(_index(name, "cpu"), r=20, ma=2, keep=0.05, batch_size=8)
    queries = _queries(13, 3)                                   # 8, then a tail of 5
    with recording() as rec:
        d, lab, _ = engine.run(queries)
        engine.run(queries)
    batches = [s for s in rec.spans if s.name == "engine.batch"]
    assert [s.attrs for s in batches] == [{"graph": "eager"}] * 4
    assert all(s.attrs.get("path") != "graph" for s in rec.spans if s.name == "search")
    assert engine._graph is None
    assert d.shape == lab.shape == (13, 20)


@pytest.mark.parametrize("arg,value", [("r", 30), ("ma", 3), ("keep", 0.02),
                                       ("adc_type", "adc"), ("rerank", False),
                                       ("batch_size", 16), ("index", "flat"),
                                       ("index", "an equal copy")])
def test_the_graph_key_follows_each_argument_and_the_index(arg, value):
    """A graph is kept while the engine's index (the object itself) and its
    search's arguments are those it was captured for."""
    index = _index("ivf", "cpu")
    engine = QueryEngine(index, r=20, ma=2, keep=0.05, batch_size=8)
    kept = engine_mod._Graph(index, engine.graph_key(), None, None, None)
    engine._graph = kept
    assert engine._kept_graph() is kept
    if arg == "index":
        value = _index("flat", "cpu") if value == "flat" else dataclasses.replace(index)
    setattr(engine, arg, value)
    assert engine._kept_graph() is None


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


def _check_phases_after_a_run(engine, monkeypatch):
    """After `run` (which captures on a card), measure_phases still splits
    eager searches: their front spans are recorded and the table and scan
    phases are positive."""
    queries = _queries(engine.batch_size, 4)
    engine.run(queries)
    with _kept_recordings(monkeypatch) as kept:
        m = engine.measure_phases(queries, iters=3, warmup=1)
    (rec,) = kept
    searches = [s for s in rec.spans if s.name == "search"]
    assert len(searches) == 3 and all(s.attrs.get("path") != "graph" for s in searches)
    names = {s.name for s in rec.spans}
    assert {"front.tables", "front.keep_bound", "front.int8"} <= names
    assert all(min(split) >= 0 for split in phase_split(rec.spans))
    assert m.count == 1 and m.table_us > 0 and m.scan_us > 0


@pytest.mark.parametrize("name", ["ivf", "flat"])
def test_measure_phases_still_splits_an_eager_search(name, monkeypatch):
    engine = QueryEngine(_index(name, "cpu"), r=20, ma=2, keep=0.05, batch_size=8)
    _check_phases_after_a_run(engine, monkeypatch)


# ----------------------------------------------------------------- the card


@pytest.mark.parametrize("case", list(CASES))
def test_replays_equal_the_eager_search_bit_for_bit(cuda, case):
    engine = _engine(case, str(cuda))
    b = engine.batch_size
    queries = _queries(2 * b + 5, 5)                            # b, b, then a padded tail
    want_d, want_l, paths = _eager(engine, queries)
    assert paths == {CASES[case][5]}
    got = engine.run(queries)[:2]
    assert engine._graph is not None
    _assert_equal(got, (want_d, want_l))
    with recording() as rec:                                    # replays, traced
        again = engine.run(queries)[:2]
    _assert_equal(again, (want_d, want_l))
    batches = [s for s in rec.spans if s.name == "engine.batch"]
    assert [s.attrs["graph"] for s in batches] == ["replay"] * 3
    assert {s.attrs.get("path") for s in rec.spans if s.name == "search"} == {"graph"}


@pytest.mark.parametrize("case", ["ivf-qadc", "flat-qadc"])
def test_returned_arrays_outlive_later_batches(cuda, case):
    engine = _engine(case, str(cuda))
    first = engine.run(_queries(engine.batch_size, 6))[:2]
    kept = [a.copy() for a in first]
    second = engine.run(_queries(engine.batch_size, 7))[:2]
    assert not np.array_equal(second[1], kept[1])
    for a, k in zip(first, kept):
        np.testing.assert_array_equal(a, k)


def test_two_engines_on_two_indexes_keep_their_own_graphs(cuda):
    engines = [_engine("ivf-qadc", str(cuda)), _engine("flat-qadc", str(cuda))]
    queries = _queries(2 * 64, 8)
    want = [_eager(e, queries)[:2] for e in engines]
    for _ in range(2):
        for e, w in zip(engines, want):
            _assert_equal(e.run(queries)[:2], w)
    assert engines[0]._graph.graph is not engines[1]._graph.graph


@pytest.mark.parametrize("case", ["ivf-qadc", "flat-adc"])
def test_a_new_r_captures_anew(cuda, case):
    engine = _engine(case, str(cuda))
    queries = _queries(engine.batch_size + 3, 9)
    engine.run(queries)
    first = engine._graph
    engine.r = 20
    got = engine.run(queries)[:2]
    assert engine._graph is not first and engine._graph.key == engine.graph_key()
    assert got[0].shape == (len(queries), 20)
    _assert_equal(got, _eager(engine, queries)[:2])


def _device_ops(fn):
    """Names of the device ops torch.profiler records (CUDA activity only,
    as portbench/trace.py records it) over one call of fn."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return collections.Counter(e.name for e in prof.events() if e.device_type == DeviceType.CUDA)


@pytest.mark.parametrize("case", list(CASES))
def test_the_profiler_sees_each_kernel_of_a_replay(cuda, case):
    """A replayed batch shows the same device ops by name and number as an
    eager one (one copy in, the search's kernels, the copies out), the
    path's hand-written scan among them; the replay issues no launch
    through the kernel wrappers, so `lut_scan.launches` stays; and a
    capture made under the profiler replays bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]):           # the first window can drop events
        torch.ones(8, device=cuda).sum()
    queries = _queries(64, 11)
    eager_engine, engine = _engine(case, str(cuda)), _engine(case, str(cuda))
    engine.run(queries)                                         # captures, unprofiled
    with recording():                                           # no graph yet: eager
        eager = _device_ops(lambda: eager_engine.run(queries))
    assert eager_engine._graph is None
    launches = dict(lut_scan.launches)
    replayed = _device_ops(lambda: engine.run(queries))
    assert replayed == eager
    assert lut_scan.launches == launches
    kernel = CASES[case][6]
    assert kernel is None or any(kernel in name for name in replayed)
    traced = _engine(case, str(cuda))
    with profile(activities=[ProfilerActivity.CUDA]):
        got = traced.run(queries)[:2]                           # captures under the profiler
    assert traced._graph is not None
    _assert_equal(got, _eager(traced, queries)[:2])


@pytest.mark.parametrize("confirmed", [True, False])
def test_autotune_settles_before_the_capture(cuda, monkeypatch, tmp_path, confirmed):
    """Under QADC_AUTOTUNE=1 the grouped IVF search tunes in the warm-up,
    on the first batch's queries, and never inside the capture. The tuner
    finds group size 64 fastest; confirmed, it records the pick; not
    confirmed, it records none, and a search with no pick would tune again:
    the capture must not. The replays equal the eager search."""
    monkeypatch.setenv("QADC_AUTOTUNE", "1")
    monkeypatch.setenv("QADC_AUTOTUNE_CACHE", str(tmp_path / "autotune.json"))
    monkeypatch.setattr(autotune, "_mem", {})
    monkeypatch.setattr(autotune, "_disk_loaded", False)
    real, timed = autotune._time_group_size, []

    def favour_64(index, queries, group_size, iters, **kw):
        assert not torch.cuda.is_current_stream_capturing()
        timed.append(queries.clone())
        t = real(index, queries, group_size, iters, **kw)
        if len(timed) > len(autotune.GROUP_CANDIDATES) and not confirmed:
            return 1e-3                                         # a tie: no pick
        return t if group_size == 64 else 2 * t + 1e-3

    monkeypatch.setattr(autotune, "_time_group_size", favour_64)
    engine = _engine("ivf-qadc", str(cuda))
    b = engine.batch_size
    queries = _queries(2 * b + 5, 12)
    got = engine.run(queries)[:2]
    assert engine._graph is not None
    # each candidate once, then 64 and the default again to confirm
    assert len(timed) == len(autotune.GROUP_CANDIDATES) + 2
    first = torch.from_numpy(queries[:b]).to(cuda)
    assert all(torch.equal(q, first) for q in timed)
    key = autotune.geometry_key(engine.index, "ivf_qadc_grouped", b)
    assert autotune.lookup(key) == ({"group_size": 64} if confirmed else {})
    monkeypatch.delenv("QADC_AUTOTUNE")                         # eager searches, no tuning
    _assert_equal(got, _eager(engine, queries)[:2])


def test_measure_phases_still_splits_an_eager_search_on_the_card(cuda, monkeypatch):
    engine = _engine("ivf-qadc", str(cuda))
    _check_phases_after_a_run(engine, monkeypatch)
    assert engine._graph is not None
