"""The 8-bit SIFT1M deployment (configs/sift1m-ivf256-opq8x8.json), its
cell `sift1m-ivf8-b128` and its four per-layer metrics, on the CPU.

The repository's own BENCHMARK.json gives the cell the 4-bit SIFT cell's
corpus, index and traffic with 8x8 codes searched by conventional ADC, and
exactly the four new metrics. portbench/work/scan_ivf8/count.py on a tiny
IVF 8x8 deployment equals a hand count from the probes, the partition
sizes and the port's scan8_windows, and its windows holding a real code
are the windows to which the port's grouped_scan8 gives a finite minimum.
The roofline reader reads None where no kernel-5 event ran and the share
of the least time on synthetic events; the sort share, the idle share
and the ops a batch read as their `.batch` twins.

    python -m pytest portbench/tests/test_portbench_sift8.py
"""

import json
import time

import pytest
import torch

from portbench import deploy, harness, peaks
from portbench.reference.search import nearest
from test_portbench_adc8 import ADC8

torch.set_num_threads(2)

PB = harness.ROOT / "portbench"
CELL = "sift1m-ivf8-b128"
SIFT8 = json.loads((PB / "configs" / "sift1m-ivf256-opq8x8.json").read_text())
SIFT4 = json.loads((PB / "configs" / "sift1m-ivf256-opq16x4.json").read_text())
SEED = 2 ** 31 + 2 ** 30 + 24
KERNEL5 = "void (anonymous namespace)::grouped_scan8_sm_kernel<8, 0>(unsigned char const*)"
SORT = "void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<...>"
NEW = {"scan_ivf8_roofline", "sort_device_share.adc8", "device_idle_share.adc8",
       "device_ops_per_batch.adc8"}


def _reader(name):
    return harness.load_module(PB / "metrics" / f"{name}.py", f"test_{name}").read


def test_the_cell_searches_8x8_codes_by_conventional_adc():
    cell = harness.find_cell(CELL)
    assert cell.workload["chips"] == 1 and cell.workload["traffic"] == "closed-b128"
    assert cell.traffic == {"loop": "closed_batch", "batch": 128, "warm_batches": 5}
    cfg = cell.config
    assert (cfg["adc_type"], cfg["sq_count"], cfg["sq_bits"], cfg["r"], cfg["ma"]) == (
        "adc", 8, 8, 100, 24)
    assert cfg["reduced"] == [] and not {"keep", "rerank", "screen_windows"} & set(cfg)
    same = ("index", "dim", "n_base", "n_learn", "n_queries", "data", "part_count",
            "balance_cap", "coarse_iters", "opq_iters", "kmeans_iters", "assumed")
    assert {k: cfg[k] for k in same} == {k: SIFT4[k] for k in same}
    # The 4-bit SIFT limits, but `miss`: 0.02 lies between the program's
    # reading (0 on every seed) and the control's (0.04-0.06).
    assert cfg["limits"] == dict(SIFT4["limits"], miss=0.02)
    assert cfg == SIFT8
    assert {m["name"] for m in cell.end_to_end} == {"qps", "recall_at_100", "setup_s"}
    assert {m["name"] for m in cell.per_layer} == NEW
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "qps"
    # No other cell reports them, and this cell reports none of theirs.
    for w in harness.load_spec()["workloads"]:
        if w["name"] != CELL:
            names = {m["name"] for m in harness.find_cell(w["name"]).per_layer}
            assert not names & NEW


@pytest.fixture(scope="module")
def dep():
    return deploy.build(dict(ADC8, n_queries=64), SEED, torch.device("cpu"))


def _by_hand(dep, qids):
    from qadc_tpu_torch.kernels.lut_scan import scan8_windows

    state = dep.state()
    m = state.codes.shape[-1]
    window, cs = scan8_windows(m)
    cpr = window * cs
    probes = nearest(dep.pool[qids], state.coarse, dep.cfg["ma"]).tolist()
    sizes = state.sizes.tolist()
    rpp = state.codes.shape[1] // cpr
    moved = sum(sizes[p] for p in {p for row in probes for p in row}) * m
    windows = ops = 0
    for row in probes:
        moved += len(row) * m * 256 * 2
        for p in row:
            ops += sizes[p] * m
            windows += sum(r * cpr + c0 < sizes[p] for r in range(rpp) for c0 in range(cs))
    return moved + 4 * windows, ops, windows


def test_the_scan_count_by_hand(dep):
    count = harness.load_module(PB / "work" / "scan_ivf8" / "count.py", "w_ivf8").count
    assert dep.state().codes.shape[-1] == 8
    for qids in ([0], [3, 5, 7], list(range(40))):
        moved, ops, _ = _by_hand(dep, torch.tensor(qids))
        assert count(dep, qids) == (moved, ops)


def test_the_counted_windows_are_those_kernel_5_fills(dep):
    """The windows counted are the windows of a probe to which the port's
    grouped_scan8 (its plain version here) gives a finite minimum."""
    from qadc_tpu_torch.index import ivf
    from qadc_tpu_torch.kernels import lut_scan
    from qadc_tpu_torch.ops.tables import adc_tables

    qids = torch.arange(24)
    index, ma = dep.index, dep.cfg["ma"]
    parts, rot = ivf.assign_queries(index, dep.pool[qids], ma)
    assert torch.equal(parts.long().sort(-1).values,
                       nearest(dep.pool[qids], dep.state().coarse, ma).sort(-1).values)
    tables = adc_tables(rot, index.pq.centroids).reshape(len(qids) * ma, 8, 256)
    routed, pairs, sizes = ivf._route(index, parts, 128)
    mins, _ = lut_scan.grouped_scan8(index.codes, tables.to(torch.bfloat16), routed.group_part,
                                     pairs, sizes)
    assert int(torch.isfinite(mins).sum()) == _by_hand(dep, qids)[2]


def test_the_roofline_reads_kernel_5_alone(dep):
    cell = harness.find_cell(CELL)
    batches = [list(range(0, 16)), list(range(16, 32))]
    win = harness.Window(qids=torch.arange(32).numpy(), labels=[], dists=[], attempted=32,
                         failed=0, elapsed_s=1.0, batches=batches)
    rec = harness.Record(cell=cell, dep=dep, window=win, setup_s=0.0)
    roof, sort = _reader("scan_ivf8_roofline"), _reader("sort_device_share.adc8")
    assert roof(rec) is None and sort(rec) is None                      # nothing traced
    rec.events = [("void grouped_scan_mma_kernel<8, 2, true>(...)", 0.0, 40.0),
                  ("void grouped_scan_sm_kernel<16, 0>(...)", 40.0, 50.0)]
    assert roof(rec) is None                                             # no kernel 5
    rec.events = [(KERNEL5, 0.0, 40.0), (SORT, 40.0, 50.0), ("elementwise", 50.0, 100.0)]
    least = 0.0
    for ids in batches:
        moved, ops, _ = _by_hand(dep, torch.tensor(ids))
        least += max(moved / peaks.PEAK_BYTES, ops / 67e12)
    assert roof(rec) == pytest.approx(100.0 * least / 40e-6, rel=1e-12)
    assert sort(rec) == _reader("sort_device_share.batch")(rec) == 0.1
    assert _reader("scan_ivf_roofline")(rec) is None                     # M1's reader


def test_the_tiny_deployment_runs_the_cell_path(tmp_path):
    """The configuration's keys drive the closed loop's adc8 search: a tiny
    copy of the cell through the harness is correct on `ivf.adc8`."""
    import tiny
    from qadc_tpu_torch.eval.trace import recording

    cfg = dict(SIFT8, name="tiny-sift8", dim=32, n_base=6000, n_learn=3000, n_queries=200,
               data={"generator": "sift_moment", "params": {"clusters": 64}},
               part_count=8, coarse_iters=5, opq_iters=1, kmeans_iters=4, r=20, ma=3,
               limits=ADC8["limits"])
    spec = tiny.spec()
    spec["configs"].append({"name": cfg["name"], "source": "test", "why": "test",
                            "file": f"portbench/configs/{cfg['name']}.json", "reduced": []})
    spec["workloads"].append({"name": "sift8-b", "config": cfg["name"], "traffic": "closed",
                              "chips": 1, "why": "test"})
    root = tiny.make_root(tmp_path, spec)
    (root / "portbench" / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
    with recording() as rec:
        result, checks = harness.run_cell(harness.find_cell("sift8-b", root), SEED + 1, 0.3,
                                          False, torch.device("cpu"), time.perf_counter())
    assert result["correct"] is True, checks
    assert {s.attrs.get("path") for s in rec.spans if s.name == "search"} == {"ivf.adc8"}
    assert "rerank" in {s.name for s in rec.spans}


@pytest.mark.parametrize("name", ["sort_device_share", "device_idle_share", "device_ops_per_batch"])
def test_the_twins_read_as_the_batch_metrics(dep, name):
    """Each `.adc8` twin reads what its `.batch` metric reads: None with
    nothing traced, and the same value on synthetic events with a pacing
    window (the idle share's divisor)."""
    cell = harness.find_cell(CELL)
    win = harness.Window(qids=torch.arange(32).numpy(), labels=[], dists=[], attempted=32,
                         failed=0, elapsed_s=1.0, batches=[list(range(16)), list(range(16, 32))])
    pacing = harness.Window(qids=torch.arange(64).numpy(), labels=[], dists=[], attempted=64,
                            failed=0, elapsed_s=4e-4, batches=[list(range(16))] * 4)
    rec = harness.Record(cell=cell, dep=dep, window=win, setup_s=0.0, pacing=pacing)
    twin, batch = _reader(f"{name}.adc8"), _reader(f"{name}.batch")
    assert twin(rec) is None and batch(rec) is None
    rec.events = [(KERNEL5, 0.0, 40.0), (SORT, 40.0, 50.0), ("elementwise", 60.0, 100.0)]
    want = {"sort_device_share": 10 / 90, "device_idle_share": 1 - 45e-6 / 1e-4,
            "device_ops_per_batch": 1.5}[name]
    assert twin(rec) == batch(rec) == pytest.approx(want, rel=1e-12)
