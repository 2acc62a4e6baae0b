"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): HBM3 bytes a second and int8 tensor-core operations a
second. A roofline share is stated against these, with the card's power
limit beside it."""

PEAK_BYTES = 3.35e12
PEAK_INT8 = 1.979e15


def least_seconds(moved: int, ops: int) -> float:
    """The least time of a work: its bytes over the memory rate or its int8
    operations over their peak, whichever is larger."""
    return max(moved / PEAK_BYTES, ops / PEAK_INT8)


def bound_of(moved: int, ops: int) -> str:
    """Which of the two bounds the work: "bytes" or "operations"."""
    return "bytes" if moved / PEAK_BYTES >= ops / PEAK_INT8 else "operations"
