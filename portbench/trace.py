"""The traced window: torch.profiler on the device only, and its reduction.

Only CUDA activity is recorded (kernels, copies, sets): recording every
host op as well would add a few microseconds to each of the ~100-400 ops a
search dispatches, and the host is what bounds these searches, so the
window would measure the profiler. The reduction gives the device's busy
time (the union of the op intervals), the ops by name, and the idle gaps
between them, each named by the device op that ended it: what the host was
launching while the device waited.
"""

from __future__ import annotations

import collections
import time

import torch

TOP = 10
NAME_CHARS = 96


class DeviceTrace:
    """Context manager: profiles the enclosed block; afterwards `events` is
    a list of (name, start_us, end_us) of device ops, sorted by start, and
    `window_s` the block's wall time on the host clock."""

    def __init__(self):
        self.events: list[tuple[str, float, float]] = []
        self.window_s = 0.0
        self._prof = None
        self._t0 = 0.0

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from torch.autograd import DeviceType

        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.events = sorted(
                ((e.name, float(e.time_range.start), float(e.time_range.end))
                 for e in self._prof.events() if e.device_type == DeviceType.CUDA),
                key=lambda ev: ev[1])
        self._prof = None
        return False


def busy_intervals(events) -> list[tuple[float, float]]:
    """The union of the events' intervals, as sorted disjoint intervals."""
    out: list[list[float]] = []
    for _, s, e in sorted(events, key=lambda ev: ev[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_us(events) -> float:
    return sum(e - s for s, e in busy_intervals(events))


def breakdown(events) -> dict:
    """{"device_ops": [[name, seconds]...], "idle_gaps": [[name, seconds]...]},
    each the TOP largest: device time by op name, and idle time between
    device ops by the op that ended the gap."""
    ops = collections.Counter()
    for name, s, e in events:
        ops[name[:NAME_CHARS]] += (e - s) / 1e6
    gaps = collections.Counter()
    reach = None
    for name, s, e in sorted(events, key=lambda ev: ev[1]):
        if reach is not None and s > reach:
            gaps["before " + name[:NAME_CHARS]] += (s - reach) / 1e6
        reach = e if reach is None else max(reach, e)
    return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
            "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}
