"""The harness finds configurations, traffic, loops, metrics and work by
name, and a new one of each is new files and new entries."""

import json

import pytest
import torch

import tiny
from portbench import harness

torch.set_num_threads(2)


def test_the_benchmark_names_files_that_exist():
    spec = harness.load_spec()
    for c in spec["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) == {"miss", "dist_err", "code_mismatch", "train_excess"}
    for w in spec["workloads"]:
        cell = harness.find_cell(w["name"])
        assert hasattr(cell.loop, "prepare") and hasattr(cell.loop, "run")
        for m in cell.end_to_end + cell.per_layer:
            assert hasattr(cell.metric_reader(m["name"]), "read"), m["name"]
    for work in ("scan_ivf", "scan_flat"):
        assert (harness.ROOT / "portbench" / "work" / work / "count.py").exists()


def test_cells_report_their_metrics():
    cell = harness.find_cell("sift1m-ivf-b128")
    assert {m["name"] for m in cell.end_to_end} == {"qps", "recall_at_100", "setup_s"}
    assert "scan_ivf_roofline" in {m["name"] for m in cell.per_layer}
    flat = harness.find_cell("gist1m-flat-b128")
    assert {m["name"] for m in flat.per_layer} == {
        "device_ops_per_batch.batch", "sort_device_share.batch", "scan_flat_roofline",
        "device_idle_share.batch"}


def test_a_new_config_traffic_metric_and_scan_are_files_and_entries(tmp_path):
    spec = tiny.spec()
    root = tiny.make_root(tmp_path, spec, copy=True)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    pb = root / "portbench"
    cfg = dict(tiny.IVF, name="tiny-ivf-wide", ma=5)
    (pb / "configs" / "tiny-ivf-wide.json").write_text(json.dumps(cfg))
    (pb / "traffic" / "closed8.json").write_text(json.dumps(dict(tiny.CLOSED, batch=8)))
    (pb / "metrics" / "answers_per_batch.batch.py").write_text(
        "def read(rec):\n    return len(rec.window.qids) / len(rec.window.batches)\n")
    (pb / "work" / "scan_ivf" / "dummy.json").write_text(
        json.dumps({"kernels": ["dummy_scan_kernel"]}))
    spec["configs"].append({"name": "tiny-ivf-wide", "source": "test", "why": "test",
                            "file": "portbench/configs/tiny-ivf-wide.json", "reduced": []})
    spec["workloads"].append({"name": "wide-b8", "config": "tiny-ivf-wide",
                              "traffic": "closed8", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "answers_per_batch.batch", "unit": "queries",
                              "better": "higher", "source": "program_counter", "layer": "test",
                              "moves": "qps", "workloads": ["wide-b8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    changed = [p for p, b in before.items()
               if p.name != "BENCHMARK.json" and p.read_bytes() != b]
    assert changed == []

    keep = {}
    result, checks = tiny.run(root, "wide-b8", keep=keep)
    assert result["correct"], checks
    cell = harness.find_cell("wide-b8", root)
    assert [m["name"] for m in cell.per_layer] == ["answers_per_batch.batch"]
    assert harness.read_metrics(cell, cell.per_layer, keep["rec"]) == {
        "answers_per_batch.batch": {"value": 8.0, "unit": "queries"}}
    rec = keep["rec"]
    assert rec.work_kernels("scan_ivf") == {"grouped_scan_mma_kernel", "dummy_scan_kernel"}
    rec.events = [("void dummy_scan_kernel<16>(...)", 0.0, 5.0), ("other", 5.0, 9.0)]
    assert rec.kernel_us(rec.work_kernels("scan_ivf")) == 5.0


def test_an_unknown_cell_is_refused(tiny_root):
    with pytest.raises(KeyError):
        harness.find_cell("no-such-cell", tiny_root)


def test_metrics_without_workloads_follow_what_they_move():
    e2e = {"qps"}
    assert harness.reports({"name": "x", "moves": "qps"}, "c", e2e)
    assert not harness.reports({"name": "x", "moves": "p95_ms"}, "c", e2e)
    assert harness.reports({"name": "x", "moves": "qps", "workloads": ["c"]}, "c", set())
    assert harness.reports({"name": "setup_s"}, "c", set())
