"""A cell's traced window with the program's spans on: where each batch's
host time goes, layer by layer, and what the host was doing in each of the
device's idle gaps.

    python3 portbench/span_window.py --workload <cell> --seed <n> [--seconds 2]

from the root of a checkout, on a CUDA card. It builds the cell as run.py
does, warms it up, runs the same throw-away traced window and untraced
pacing window as a traced run, and then one traced window (CUDA activity
only, as portbench/trace.py records it) inside the program's
`eval.trace.recording()`. The last line of standard output (JSON) holds the
per-layer readings of portbench/spans.py, the two breakdown lists, the
attribution's diagnostics (with the device clock's lag behind the launches),
each span's host self time, the runtime calls that launched no op, and the
cost of the spans: batches a second in traced windows with the recording
off and on (off, on, on, off), and nanoseconds an off span takes on this
host. A program without spans (no `recording`) gives the device-only
numbers and no span readings.
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, spans  # noqa: E402
from portbench.trace import DeviceTrace  # noqa: E402

LAUNCH_PREFIXES = ("cuda", "cu")


def _program_recording():
    """The program's recording() context manager, or None without one."""
    try:
        from qadc_tpu_torch.eval import trace
    except ImportError:
        return None
    return getattr(trace, "recording", None)


class SpanTrace(DeviceTrace):
    """DeviceTrace that also opens the program's recording and keeps the
    profiler's absolute times: `ops` (name, start_ns, end_ns, correlation
    id) of the device, `launches` (name, start_ns, correlation id) of the
    host's CUDA runtime calls, `t0_ns` / `t1_ns` the window, `trace_start_ns`
    the profiler's, and `recording` the program's Recording (or None)."""

    def __init__(self, record: bool = True):
        super().__init__()
        self._record = _program_recording() if record else None
        self._rec_cm = self.recording = None
        self.ops, self.launches = [], []
        self.t0_ns = self.t1_ns = self.trace_start_ns = 0

    def __enter__(self):
        if self._record is not None:
            self._rec_cm = self._record()
            self.recording = self._rec_cm.__enter__()
        super().__enter__()
        self.t0_ns = time.time_ns()
        return self

    def __exit__(self, *exc):
        from torch.autograd import DeviceType

        prof = self._prof
        super().__exit__(*exc)
        self.t1_ns = self.t0_ns + int(self.window_s * 1e9)
        if self._rec_cm is not None:
            self._rec_cm.__exit__(*exc)
        results = prof.profiler.kineto_results
        self.trace_start_ns = results.trace_start_ns()
        for e in results.events():
            corr = e.correlation_id()
            if e.device_type() == DeviceType.CUDA:
                self.ops.append((e.name(), e.start_ns(), e.end_ns(), corr))
            elif e.name().startswith(LAUNCH_PREFIXES):
                self.launches.append((e.name(), e.start_ns(), corr))
        self.ops.sort(key=lambda o: o[1])
        return False


def host_self_ms(recorded, batches: int) -> list:
    """[span name, host self milliseconds a batch], largest first."""
    selfs = spans.self_ns(recorded)
    by_name = collections.Counter()
    for s in recorded:
        by_name[s.name] += selfs[s.id]
    return [[k, v / 1e6 / batches] for k, v in by_name.most_common()]


def off_span_ns() -> float | None:
    """Nanoseconds of one span with recording off, on this host's CPU."""
    try:
        from qadc_tpu_torch.eval.trace import span
    except ImportError:
        return None

    def one():
        with span("front.tables"):
            pass

    n = 200_000
    return min(timeit.repeat(one, number=n, repeat=5)) / n * 1e9


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """One window. root: the benchmark's root; device: None for the first
    CUDA card, which the tool requires."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=harness.TRACE_SECONDS)
    args = ap.parse_args(argv)

    import torch

    from portbench import deploy

    if device is None:
        if not torch.cuda.is_available():
            print("span_window: needs a CUDA card", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    torch.set_num_threads(1)
    cell = harness.find_cell(args.workload, root)
    dep = deploy.build(cell.config, args.seed, device)
    ctx = harness.Context(cell=cell, dep=dep, seed=args.seed, device=device)
    cell.loop.prepare(ctx)
    torch.cuda.synchronize(device)
    with DeviceTrace():                 # the profiler's first window can drop events
        cell.loop.run(ctx, 0.25)
    pacing = cell.loop.run(ctx, args.seconds)
    with SpanTrace() as tr:
        win = cell.loop.run(ctx, args.seconds)
    rec = tr.recording
    n = len(win.batches)
    out = spans.reduce(rec.spans if rec else [], rec.counts if rec else [], tr.ops,
                       tr.launches, tr.t0_ns, tr.t1_ns, n)
    busy_s = out["diagnostics"]["busy_s"]
    op_corrs = {o[3] for o in tr.ops}
    out.update(cell=cell.name, seed=args.seed, card=torch.cuda.get_device_name(device),
               batches=n, device_ops_per_batch=len(tr.ops) / n,
               device_idle_share=1.0 - busy_s / n / (pacing.elapsed_s / len(pacing.batches)),
               trace_start_ns=tr.trace_start_ns, t0_ns=tr.t0_ns,
               spans=len(rec.spans) if rec else 0,
               host_self_ms_by_span=host_self_ms(rec.spans, n) if rec else [],
               launches_without_op=collections.Counter(
                   name for name, _, c in tr.launches if c not in op_corrs).most_common(8))
    cost = []
    for on in (False, True, True, False):
        with SpanTrace(record=on):
            w = cell.loop.run(ctx, args.seconds)
        cost.append({"recording": on, "batches_per_s": len(w.batches) / w.elapsed_s})
    out["cost"] = {"windows": cost, "off_span_ns": off_span_ns()}
    cell.loop.close(ctx)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
