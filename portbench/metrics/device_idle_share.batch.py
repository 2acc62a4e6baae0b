"""device_idle_share.batch: the share of the untraced loop's time that the
device is idle, in the closed-loop batch cells: 1 - (device-busy seconds a
batch in the traced window, the union of its op intervals) / (seconds a
batch in the pacing window, the same loop untraced just before it). The
profiler slows the host's dispatch, so the traced window's own wall time
would read the device idler than it is when nothing traces it."""


def read(rec):
    traced, pacing = rec.window.batches, rec.pacing
    if not rec.events or not traced or pacing is None or not pacing.batches:
        return None
    busy_a_batch = rec.busy_us() / 1e6 / len(traced)
    return 1.0 - busy_a_batch / (pacing.elapsed_s / len(pacing.batches))
