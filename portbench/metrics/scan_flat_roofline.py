"""scan_flat_roofline: the least time of the flat 4-bit scan's work in
the traced window (portbench/work/scan_flat/count.py, for the batches
searched there) over the device time of the kernels that portbench/work/
scan_flat/ names, in percent. None when none of them ran."""

from portbench.peaks import least_seconds

WORK = "scan_flat"


def read(rec):
    if not rec.events or not rec.window.batches:
        return None
    spent = rec.kernel_us(rec.work_kernels(WORK)) / 1e6
    if spent <= 0:
        return None
    least = sum(least_seconds(*rec.work_count(WORK, ids)) for ids in rec.window.batches)
    return 100.0 * least / spent
