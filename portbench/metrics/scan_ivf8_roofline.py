"""scan_ivf8_roofline: the least time of the IVF grouped 8-bit scan's work
in the traced window (portbench/work/scan_ivf8/count.py, for the batches
searched there) over the device time of the kernels that portbench/work/
scan_ivf8/ names (kernel 5), in percent. Its operations are float32
additions, so the least time is the larger of the bytes over HBM's rate
(peaks.PEAK_BYTES) and the additions over PEAK_F32, not peaks.least_seconds'
int8 tensor-core rate. None when none of the kernels ran."""

from portbench.peaks import PEAK_BYTES

WORK = "scan_ivf8"
# Float32 operations a second of one NVIDIA H100 SXM outside the tensor
# cores (NVIDIA's data sheet, dense, at the 700 W limit).
PEAK_F32 = 67e12


def least_seconds(moved: int, ops: int) -> float:
    return max(moved / PEAK_BYTES, ops / PEAK_F32)


def read(rec):
    if not rec.events or not rec.window.batches:
        return None
    spent = rec.kernel_us(rec.work_kernels(WORK)) / 1e6
    if spent <= 0:
        return None
    least = sum(least_seconds(*rec.work_count(WORK, ids)) for ids in rec.window.batches)
    return 100.0 * least / spent
