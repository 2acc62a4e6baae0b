"""One run of one cell, driven by data.

Everything particular to a cell is found by name:
  - the cell (`workloads`), its configuration (`configs`) and its metrics
    (`end_to_end`, `per_layer`) in BENCHMARK.json at the root;
  - the configuration's sizes and limits in the file that `configs` names;
  - the traffic in portbench/traffic/<traffic>.json, which names its loop,
    portbench/loops/<loop>.py (`prepare(ctx)`, `run(ctx, seconds)`,
    `close(ctx)`);
  - each metric's reader in portbench/metrics/<metric>.py (`read(rec)`,
    which returns a number or None when it finds nothing to read);
  - each roofline's work in portbench/work/<work>/ (`count.py`, and one
    JSON file an implementation naming its kernels).
A later cell, metric or implementation is new files and new entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "qadc_tpu")
TRACE_SECONDS = 2.0     # the traced window's length (at most --seconds)


def load_spec(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def load_module(path: Path, name: str):
    """A module from a file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """Everything one cell runs with, found by name."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    loop: object
    end_to_end: list
    per_layer: list
    root: Path

    def metric_reader(self, name: str):
        return load_module(self.root / "portbench" / "metrics" / f"{name}.py",
                           f"portbench_metric_{name}")


def reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether a cell reports a metric: the metric's `workloads`, or,
    without that key, every cell that reports the end-to-end metric it
    moves (an end-to-end metric without it: every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_of_cell


def find_cell(name: str, root: Path = ROOT) -> Cell:
    spec = load_spec(root)
    w = _by_name(spec["workloads"], name, "workload")
    centry = _by_name(spec["configs"], w["config"], "config")
    with open(root / centry["file"]) as f:
        config = json.load(f)
    with open(root / "portbench" / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    loop = load_module(root / "portbench" / "loops" / f"{traffic['loop']}.py",
                       f"portbench_loop_{traffic['loop']}")
    e2e = [m for m in spec["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"] if reports(m, name, names)]
    return Cell(name, w, config, traffic, loop, e2e, layer, root)


@dataclasses.dataclass
class Window:
    """What a loop's measured window returned.

    qids / labels / dists: each answered query's id and answer (labels,
      dists: lists of (k, r) blocks, see `answers`).
    attempted / failed: queries sent, and those that failed or never came.
    elapsed_s: from the first query sent to the last answer on the host.
    batches: the query ids of each batch searched.
    info: what the loop reports on its own line (rates).
    """

    qids: np.ndarray
    labels: list
    dists: list
    attempted: int
    failed: int
    elapsed_s: float
    batches: list | None = None
    info: dict = dataclasses.field(default_factory=dict)

    def answers(self):
        """(qids (A,), labels (A, r), dists (A, r)) as numpy."""
        return self.qids, np.concatenate(self.labels), np.concatenate(self.dists)


@dataclasses.dataclass
class Context:
    """What a loop is given: the cell, the built deployment, the seed, and
    a place for its own state between prepare, run and close."""

    cell: Cell
    dep: object
    seed: int
    device: object
    state: dict = dataclasses.field(default_factory=dict)

    @property
    def cfg(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic


@dataclasses.dataclass
class Record:
    """What the metric readers read: the window, the deployment, the set-up
    seconds, the answers' labels (A, r) in the order of window.qids, and in
    a traced run the device ops and the pacing window: the same loop run
    untraced just before the traced one (the profiler slows the host)."""

    cell: Cell
    dep: object
    window: Window
    setup_s: float
    labels: np.ndarray | None = None
    events: list | None = None
    window_s: float | None = None
    pacing: Window | None = None

    def work_kernels(self, work: str) -> set:
        """Kernel names of every implementation file of a work."""
        names = set()
        for f in sorted((self.cell.root / "portbench" / "work" / work).glob("*.json")):
            with open(f) as fh:
                names.update(json.load(fh)["kernels"])
        return names

    def work_count(self, work: str, qids) -> tuple[int, int]:
        """(bytes, operations) the work needs for one batch of queries."""
        mod = load_module(self.cell.root / "portbench" / "work" / work / "count.py",
                          f"portbench_work_{work}")
        return mod.count(self.dep, qids)

    def busy_us(self) -> float:
        """Device-busy microseconds of the traced window (the union of ops)."""
        from portbench.trace import busy_us

        return busy_us(self.events)

    def kernel_us(self, names) -> float:
        """Device microseconds of the traced ops whose name holds any of names."""
        return sum(e - s for n, s, e in self.events if any(k in n for k in names))


class GcPauses:
    """The interpreter's garbage-collection pauses inside a block (the
    host-side stalls that no device trace shows), for the run's log."""

    def __init__(self):
        self.times: list[float] = []
        self._t = 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
        else:
            self.times.append(time.perf_counter() - self._t)

    def __enter__(self):
        import gc

        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        import gc

        gc.callbacks.remove(self._callback)
        return False

    def summary(self) -> dict:
        t = self.times or [0.0]
        return {"gc_pauses": len(self.times), "gc_ms_total": 1e3 * sum(t),
                "gc_ms_max": 1e3 * max(t)}


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def device_info(device, peak_bytes: int, chips: int) -> dict:
    import torch

    kind = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    return {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(peak_bytes)}


def read_metrics(cell: Cell, wanted: list, rec: Record) -> dict:
    """{name: {value, unit}} of each wanted metric whose reader found
    something to read."""
    metrics = {}
    for m in wanted:
        value = cell.metric_reader(m["name"]).read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return metrics


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_start: float,
             fault=None, keep: dict | None = None) -> tuple[dict, dict]:
    """One run: set-up, warm-up, the window, the check. Returns (the result
    line's object, the numbers compared with their limits).

    fault: for the harness's own tests, a function (ctx) called after
    prepare that breaks the timed path underneath.
    keep: a dict that receives the deployment ("dep"), the judged sample
    ("got") and the metrics' record ("rec"), for the control's readings on
    the same answers and for the harness's tests.
    """
    import torch

    from portbench import check, deploy
    from portbench import trace as tracing

    log(f"start: {time.perf_counter() - t_start:.3f} s after the process began")
    dep = deploy.build(cell.config, seed, device)
    ctx = Context(cell=cell, dep=dep, seed=seed, device=device)
    t0 = time.perf_counter()
    cell.loop.prepare(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    log(f"warm-up: {time.perf_counter() - t0:.3f} s")
    if fault is not None:
        fault(ctx)
    tracer = pacing = None
    if trace:
        with tracing.DeviceTrace():     # the profiler's first window can drop events
            cell.loop.run(ctx, 0.25)
        pacing = cell.loop.run(ctx, min(seconds, TRACE_SECONDS))
    setup_s = time.perf_counter() - t_start
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    window_len = min(seconds, TRACE_SECONDS) if trace else seconds
    pauses = GcPauses()
    try:
        with pauses:
            if trace:
                tracer = tracing.DeviceTrace()
                with tracer:
                    win = cell.loop.run(ctx, window_len)
            else:
                win = cell.loop.run(ctx, window_len)
    finally:
        cell.loop.close(ctx)
    win.info.update(pauses.summary())
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    ctx.state.clear()
    log(f"window: {win.attempted} attempted, {win.failed} failed, {win.elapsed_s:.3f} s; "
        + json.dumps(win.info))

    qids, labels, dists = win.answers()
    rec = Record(cell=cell, dep=dep, window=win, setup_s=setup_s, labels=labels, pacing=pacing)
    if tracer is not None:
        rec.events, rec.window_s = tracer.events, tracer.window_s

    t_check = time.perf_counter()
    got = check.sample(qids, labels, dists, deploy.subseed(seed, "sample"))
    numbers = check.judge(dep, got)
    ok, shown = check.verdict(numbers, cell.config["limits"])
    log(f"check: {time.perf_counter() - t_check:.3f} s")
    ok = ok and win.failed == 0

    if keep is not None:
        keep.update(dep=dep, got=got, rec=rec)
    metrics = read_metrics(cell, cell.per_layer if trace else cell.end_to_end, rec)
    result = {"correct": bool(ok), "attempted": int(win.attempted), "failed": int(win.failed),
              "metrics": metrics,
              "device": device_info(device, peak, cell.workload.get("chips", 1))}
    if tracer is not None:
        busy = tracing.busy_us(tracer.events) / 1e6
        result["device"].update(busy_s=busy, window_s=tracer.window_s)
        result["breakdown"] = tracing.breakdown(tracer.events)
    return result, shown
