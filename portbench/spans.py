"""The program's spans against the device trace: pure reductions, no torch.

Inputs, all on one clock (`time.time_ns()` nanoseconds, which the profiler
shares):
  - spans: objects with `name`, `start_ns`, `end_ns`, `id`, `parent`,
    `thread`, `batch` (qadc_tpu_torch.eval.trace.Span);
  - counts: objects with `name`, `value`, `batch` (eval.trace.Count);
  - ops: device ops as (name, start_ns, end_ns, correlation id);
  - launches: the host's CUDA runtime calls as (name, start_ns, correlation id);
  - the window [t0_ns, t1_ns].
A span's self time is its duration less the part its children cover. Each
device op goes to the innermost span open on the host at its launch (the
runtime call of the same correlation id), or, for an op whose launch the
trace lacks, at the op's own start. Each idle gap of the device is split
over the innermost spans open on the host during it; time in no span is
`OUTSIDE`. The host timeline is the thread that recorded the most spans (the
closed loop's only thread).

The profiler converts the device's timestamps onto the host's clock, and
the conversion can be off by milliseconds and drift within a window (a
GIST window on the H100 read device starts 10-20 ms before their launches).
So before the gap split, `align` moves the device ops onto the host clock:
in each ALIGN_NS of launches, the smallest lag from a launch to its op's
start (an op launched onto an idle device) marks where the device clock
stands; the offset is interpolated between those marks, and an op so
moved starts no earlier than its launch.
"""

from __future__ import annotations

import bisect
import collections

OUTSIDE = "outside spans"
TOP = 10
ALIGN_NS = 20_000_000
FRONT = "front."
TAILS = ("screen", "rerank", "merge")


def self_ns(spans) -> dict:
    """{span id: its duration less the union of its children's intervals}."""
    children = collections.defaultdict(list)
    for s in spans:
        if s.parent is not None:
            children[s.parent].append(s)
    out = {}
    for s in spans:
        covered = union_ns([(max(c.start_ns, s.start_ns), min(c.end_ns, s.end_ns))
                            for c in children[s.id]])
        out[s.id] = (s.end_ns - s.start_ns) - covered
    return out


def union(intervals) -> list:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: list[list] = []
    for s, e in sorted(iv for iv in intervals if iv[1] > iv[0]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def union_ns(intervals) -> float:
    return sum(e - s for s, e in union(intervals))


def main_thread(spans):
    """The thread that recorded the most spans, or None without spans."""
    threads = collections.Counter(s.thread for s in spans)
    return threads.most_common(1)[0][0] if threads else None


def timeline(spans, thread=None) -> list:
    """Sorted disjoint (start, end, name) segments of one thread: in each,
    the innermost span open on it. thread: default main_thread(spans)."""
    thread = main_thread(spans) if thread is None else thread
    mine = [s for s in spans if s.thread == thread]
    ids = {s.id for s in mine}
    children = collections.defaultdict(list)
    for s in mine:
        children[s.parent if s.parent in ids else None].append(s)
    for kids in children.values():
        kids.sort(key=lambda s: s.start_ns)
    out = []

    def walk(s):
        cursor = s.start_ns
        for c in children[s.id]:
            if c.start_ns > cursor:
                out.append((cursor, min(c.start_ns, s.end_ns), s.name))
            walk(c)
            cursor = max(cursor, c.end_ns)
        if cursor < s.end_ns:
            out.append((cursor, s.end_ns, s.name))

    for root in children[None]:
        walk(root)
    return sorted(seg for seg in out if seg[1] > seg[0])


class Timeline:
    """Lookups on a thread's segments (timeline())."""

    def __init__(self, segments):
        self.segments = segments
        self.starts = [seg[0] for seg in segments]

    def at(self, t) -> str:
        """The innermost span open at time t, or OUTSIDE."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segments[i][1]:
            return self.segments[i][2]
        return OUTSIDE

    def split(self, a, b, into: collections.Counter) -> None:
        """Add the interval [a, b) to `into`, by the span open at each part."""
        i = max(bisect.bisect_right(self.starts, a) - 1, 0)
        covered = 0
        while i < len(self.segments) and self.segments[i][0] < b:
            s, e, name = self.segments[i]
            part = min(e, b) - max(s, a)
            if part > 0:
                into[name] += part
                covered += part
            i += 1
        if b - a - covered > 0:
            into[OUTSIDE] += b - a - covered


def idle(ops, t0, t1) -> list:
    """The device's idle intervals within [t0, t1]: the window less the
    union of the ops' intervals."""
    out, cursor = [], t0
    for s, e in union((max(o[1], t0), min(o[2], t1)) for o in ops):
        if s > cursor:
            out.append((cursor, s))
        cursor = max(cursor, e)
    if cursor < t1:
        out.append((cursor, t1))
    return out


def gap_split(ops, line: Timeline, t0, t1) -> collections.Counter:
    """{span name: idle nanoseconds of the device while it was innermost}."""
    into = collections.Counter()
    for a, b in idle(ops, t0, t1):
        line.split(a, b, into)
    return into


def launch_times(launches) -> dict:
    """{correlation id: host start of the runtime call that carries it}."""
    launched = {}
    for _, start, corr in launches:
        if corr:                            # 0: the trace gave the call none
            launched.setdefault(corr, start)
    return launched


def attribute(ops, launches, line: Timeline):
    """({span name: device nanoseconds of the ops launched in it}, counts):
    each op by its launch's host time (matched by correlation id), else by
    its own start. counts: ops matched, ops unmatched, launches with no op."""
    launched = launch_times(launches)
    by_span = collections.Counter()
    matched = 0
    for _, s, e, corr in ops:
        t = launched.get(corr) if corr else None
        matched += t is not None
        by_span[line.at(s if t is None else t)] += e - s
    op_corrs = {o[3] for o in ops}
    return by_span, {"ops_matched": matched, "ops_unmatched": len(ops) - matched,
                     "launches_without_op": sum(1 for c in launched if c not in op_corrs)}


def align(ops, launches):
    """(ops moved onto the host clock, {"lag_us": the smallest launch-to-op
    lag of each ALIGN_NS of launches before the move: min, median, max}, or
    None without a matched op). See the module's docstring."""
    launched = launch_times(launches)
    marks: dict[int, tuple] = {}
    for _, s, _, c in ops:
        t = launched.get(c) if c else None
        if t is not None and (t // ALIGN_NS not in marks or s - t < marks[t // ALIGN_NS][1]):
            marks[t // ALIGN_NS] = (t, s - t)
    if not marks:
        return list(ops), None
    pts = sorted(marks.values())
    xs = [t for t, _ in pts]

    def offset(t):
        i = bisect.bisect_left(xs, t)
        if i == 0 or i == len(pts):
            return pts[min(i, len(pts) - 1)][1]
        (x0, y0), (x1, y1) = pts[i - 1], pts[i]
        return y0 + (y1 - y0) * (t - x0) / (x1 - x0)

    out = []
    for name, s, e, c in ops:
        t = launched.get(c) if c else None
        d = offset(s - pts[0][1]) if t is None else min(offset(t), s - t)
        out.append((name, s - d, e - d, c))
    lags = sorted(lag / 1e3 for _, lag in pts)
    return out, {"lag_us": [lags[0], lags[len(lags) // 2], lags[-1]]}


def _top(counter, scale: float) -> list:
    return [[k, v * scale] for k, v in counter.most_common(TOP)]


def reduce(spans, counts, ops, launches, t0, t1, batches: int) -> dict:
    """The traced window's readings: {"metrics": the per-layer metrics
    (per batch, host times under the profiler; a metric whose spans or
    counters are absent is left out), "breakdown": {"idle_gaps_by_span",
    "device_by_span"} ([name, seconds], the TOP largest), "diagnostics"}."""
    line = Timeline(timeline(spans))
    device, diag = attribute(ops, launches, line)
    ops, clock = align(ops, launches)
    gaps = gap_split(ops, line, t0, t1)
    busy = union_ns((max(o[1], t0), min(o[2], t1)) for o in ops)
    selfs = self_ns(spans)
    names = {s.id: s.name for s in spans}
    dur = collections.Counter()
    for s in spans:
        dur[s.name] += s.end_ns - s.start_ns
    searched_in_engine = sum(s.end_ns - s.start_ns for s in spans
                             if s.name == "search" and names.get(s.parent) == "engine.batch")
    self_of = collections.Counter()
    for s in spans:
        self_of[s.name] += selfs[s.id]
    front = [n for n in dur if n.startswith(FRONT)]
    per = 1e-3 / max(batches, 1)           # ns in the window -> us a batch
    metrics = {}
    if "search" in dur:
        metrics["search_host_us.batch"] = dur["search"] * per
    if "engine.batch" in dur:
        metrics["engine_host_us.batch"] = (dur["engine.batch"] - searched_in_engine) * per
    if front:
        metrics["front_host_us.batch"] = sum(self_of[n] for n in front) * per
        if busy:
            metrics["front_device_share.batch"] = sum(device[n] for n in front) / busy
    if any(n in dur for n in TAILS):
        metrics["tail_host_us.batch"] = sum(self_of[n] for n in TAILS) * per
        if busy:
            metrics["tail_device_share.batch"] = sum(device[n] for n in TAILS) / busy
    groups = collections.Counter()
    for c in counts:
        if c.name == "route.groups":
            groups[c.batch] += c.value
    if groups:
        metrics["groups_per_batch.batch"] = sum(groups.values()) / len(groups)
    if spans:
        metrics["idle_outside_spans_us.batch"] = gaps[OUTSIDE] * per
    idle_ns = sum(gaps.values())
    diag.update(idle_s=idle_ns / 1e9, busy_s=busy / 1e9, window_s=(t1 - t0) / 1e9, clock=clock,
                device_outside_spans_share=device[OUTSIDE] / busy if busy else None)
    return {"metrics": metrics,
            "breakdown": {"idle_gaps_by_span": _top(gaps, 1e-9),
                          "device_by_span": _top(device, 1e-9)},
            "diagnostics": diag}
