"""A tiny benchmark root for the CPU tests: BENCHMARK.json, one IVF and one
flat configuration at small sizes, a closed-loop traffic, and the
real loops, metrics and work beside them (symbolic links), so a test runs
the harness end to end on the CPU with the kernels' plain versions."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

PORTBENCH = Path(__file__).resolve().parents[1]

IVF = {"name": "tiny-ivf", "source": "test", "index": "ivf", "dim": 32, "n_base": 6000,
       "n_learn": 3000, "n_queries": 200,
       "data": {"generator": "sift_moment", "params": {"clusters": 64}},
       "part_count": 8, "balance_cap": 3.0, "coarse_iters": 5, "sq_count": 16, "sq_bits": 4,
       "opq_iters": 1, "kmeans_iters": 4, "r": 20, "ma": 3, "keep": 0.05, "rerank": True,
       "screen_windows": 1, "reduced": [],
       "limits": {"miss": 0.05, "dist_err": 1e-4, "code_mismatch": 0.002,
                  "train_excess": 0.05}}
FLAT = {"name": "tiny-flat", "source": "test", "index": "flat", "dim": 64, "n_base": 6000,
        "n_learn": 3000, "n_queries": 200,
        "data": {"generator": "gist_moment", "params": {"clusters": 64}},
        "sq_count": 32, "sq_bits": 4, "opq_iters": 1, "kmeans_iters": 4, "r": 20,
        "keep": 0.02, "rerank": True, "screen_windows": 2, "reduced": [],
        "limits": {"miss": 0.05, "dist_err": 1e-4, "code_mismatch": 0.002,
                  "train_excess": 0.05}}
CLOSED = {"loop": "closed_batch", "batch": 16, "warm_batches": 1}
CELLS = {"ivf-b": ("tiny-ivf", "closed"), "flat-b": ("tiny-flat", "closed")}


def spec() -> dict:
    batch = ["ivf-b", "flat-b"]
    return {
        "command": ["python3", "portbench/run.py"], "paths": ["portbench"], "run_seconds": 1,
        "configs": [{"name": c["name"], "source": "test", "file": f"portbench/configs/{c['name']}.json",
                     "reduced": [], "why": "test"} for c in (IVF, FLAT)],
        "workloads": [{"name": n, "config": c, "traffic": t, "chips": 1, "why": "test"}
                      for n, (c, t) in CELLS.items()],
        "end_to_end": [
            {"name": "qps", "unit": "queries/s", "better": "higher", "bound": 0.1,
             "source": "host_clock"},
            {"name": "recall_at_100", "unit": "fraction", "better": "higher", "bound": 0.1,
             "source": "host_clock"},
            {"name": "setup_s", "unit": "s", "better": "lower", "bound": 0.25,
             "source": "host_clock"}],
        "per_layer": [
            {"name": "device_idle_share.batch", "unit": "fraction", "better": "lower",
             "source": "device_trace", "layer": "device", "moves": "qps", "workloads": batch}],
    }


def make_root(tmp: Path, spec_obj: dict | None = None, copy: bool = False) -> Path:
    """A benchmark root under tmp; returns it. copy=True copies the loops,
    metrics and work instead of linking them, so a test may add files."""
    pb = tmp / "portbench"
    for sub in ("configs", "traffic"):
        (pb / sub).mkdir(parents=True, exist_ok=True)
    for sub in ("loops", "metrics", "work"):
        if copy:
            shutil.copytree(PORTBENCH / sub, pb / sub,
                            ignore=shutil.ignore_patterns("__pycache__"))
        else:
            (pb / sub).symlink_to(PORTBENCH / sub, target_is_directory=True)
    for c in (IVF, FLAT):
        (pb / "configs" / f"{c['name']}.json").write_text(json.dumps(c))
    (pb / "traffic" / "closed.json").write_text(json.dumps(CLOSED))
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec_obj or spec()))
    return tmp


def run(root: Path, cell: str, seed: int = 1234567890123, seconds: float = 0.3, fault=None,
        keep: dict | None = None):
    """One run of a tiny cell on the CPU: (result, checks)."""
    import time

    from portbench import harness

    c = harness.find_cell(cell, root)
    return harness.run_cell(c, seed, seconds, False, torch.device("cpu"), time.perf_counter(),
                            fault=fault, keep=keep)
