"""The result line has exactly the contract's keys; a failed search prints
no result; run.py refuses to run without a card; no JAX."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import tiny
from portbench import harness

torch.set_num_threads(2)
PB = Path(__file__).resolve().parents[1]

RESULT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}
DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", ["ivf-b", "flat-b"])
def test_result_has_the_contract_keys(tiny_root, cell):
    result, checks = tiny.run(tiny_root, cell)
    assert set(result) == RESULT_KEYS
    assert set(result["device"]) == DEVICE_KEYS
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["metrics"]) == {"qps", "recall_at_100", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(checks) == {"miss", "dist_err", "code_mismatch", "train_excess"}
    for v in checks.values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.dumps(result)


def test_a_failed_search_ends_the_run_with_no_result(tiny_root, monkeypatch, capsys):
    """A closed loop has every answer on the host before it sends the next
    batch: a search that fails ends the run, and no result is printed."""
    from portbench import run
    from qadc_tpu_torch.index import ivf

    calls = {"n": 0}
    real = ivf.search_qadc

    def sometimes(*args, **kw):
        calls["n"] += 1
        if calls["n"] % 3 == 0:
            raise RuntimeError("a failed batch")
        return real(*args, **kw)

    monkeypatch.setattr(ivf, "search_qadc", sometimes)
    with pytest.raises(RuntimeError, match="a failed batch"):
        run.main(["--workload", "ivf-b", "--seed", "5", "--seconds", "0.3", "--trace", "0"],
                 root=tiny_root, device=torch.device("cpu"))
    assert capsys.readouterr().out.strip() == ""


def test_the_printed_line_has_exactly_the_contract_keys(tiny_root, capsys):
    """What run.main prints last, not only what the harness returns."""
    from portbench import run

    rc = run.main(["--workload", "flat-b", "--seed", str(2 ** 33 + 1), "--seconds", "0.3",
                   "--trace", "0"], root=tiny_root, device=torch.device("cpu"))
    out, err = capsys.readouterr()
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    assert set(line) == RESULT_KEYS
    assert set(line["device"]) == DEVICE_KEYS
    assert line["correct"] is True
    tail = err.strip().splitlines()[-4:]
    assert [t.split(":")[0] for t in tail] == [
        "check miss", "check dist_err", "check code_mismatch", "check train_excess"]


def test_run_exits_without_a_card_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(PB / "run.py"), "--workload", "sift1m-ivf-b128",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=PB.parent, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names():
    fake = {"qadc_tpu_torch": 1, "qadc_tpu_torch.index.ivf": 1, "jaxtyping": 1, "numpy": 1,
            "qadc_tpu_torchx": 1}
    assert harness.forbidden_modules(fake) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen", "qadc_tpu",
                "qadc_tpu.index.ivf"):
        assert harness.forbidden_modules({**fake, bad: 1}) == [bad]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")), ids=lambda p: str(p.relative_to(PB)))
def test_no_benchmark_file_imports_jax(path):
    for name in _imports(path):
        assert name.split(".")[0] not in harness.FORBIDDEN, f"{path} imports {name}"


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        assert name.split(".")[0] in ("torch", "__future__", "contextlib", "dataclasses",
                                      "numpy"), name


def test_the_idle_share_is_read_at_the_untraced_pace():
    def window(elapsed, batches):
        return harness.Window(qids=np.zeros(0, int), labels=[], dists=[], attempted=0, failed=0,
                              elapsed_s=elapsed, batches=[[0]] * batches)

    read = harness.load_module(PB / "metrics" / "device_idle_share.batch.py", "idle").read
    # 3 ms busy (two overlapping ops) over 2 traced batches: 1.5 ms a batch;
    # untraced, a batch takes 3 ms: the device is idle half of the time.
    rec = harness.Record(cell=None, dep=None, window=window(0.5, 2), setup_s=0.0,
                         events=[("a", 0.0, 1000.0), ("b", 500.0, 3000.0)],
                         pacing=window(0.03, 10))
    assert read(rec) == pytest.approx(0.5)
    rec.pacing = None
    assert read(rec) is None
