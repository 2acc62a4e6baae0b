"""Row128 code storage (counterpart of qadc_tpu/core/layout.py).

Codes are stored as 128-byte rows of cpr = 128 / code_size consecutive
codes, so a partition of part_pad codes is (part_pad / cpr, 128) uint8 and
code i of the partition is bytes [(i % cpr) * code_size, ...) of row
i // cpr. The row-major bytes are the same as (part_pad, code_size).
"""

from __future__ import annotations

import torch

# Codes a flat index is padded to a multiple of (qadc_tpu/core/layout.py).
DEFAULT_BLOCK = 1024


def codes_per_row(code_size: int) -> int:
    """Codes per 128-byte storage row."""
    if 128 % code_size != 0:
        raise ValueError(f"code_size {code_size} must divide 128")
    return 128 // code_size


def row128_view(codes: torch.Tensor, code_size: int) -> torch.Tensor:
    """(P, part_pad, code_size) packed codes -> (P, part_pad/cpr, 128) view."""
    p, part_pad, cb = codes.shape
    if cb != code_size:
        raise ValueError(f"code width {cb} != code_size {code_size}")
    cpr = codes_per_row(code_size)
    if part_pad % cpr != 0:
        raise ValueError(f"part_pad {part_pad} must be a multiple of {cpr}")
    return codes.reshape(p, part_pad // cpr, 128)


def code_view(rows: torch.Tensor, code_size: int) -> torch.Tensor:
    """(P, rpp, 128) row128 storage -> (P, rpp*cpr, code_size) view."""
    p, rpp, width = rows.shape
    if width != 128:
        raise ValueError(f"storage rows must be 128 bytes wide, got {width}")
    cpr = codes_per_row(code_size)
    return rows.reshape(p, rpp * cpr, code_size)
