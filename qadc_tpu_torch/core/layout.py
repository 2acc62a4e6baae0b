"""Row128 code storage (counterpart of qadc_tpu/core/layout.py).

Codes are stored as 128-byte rows of cpr = 128 / code_size consecutive
codes, so a partition of part_pad codes is (part_pad / cpr, 128) uint8 and
code i of the partition is bytes [(i % cpr) * code_size, ...) of row
i // cpr. The row-major bytes are the same as (part_pad, code_size).
"""

from __future__ import annotations

import numpy as np
import torch

# Codes a flat index is padded to a multiple of (qadc_tpu/core/layout.py).
DEFAULT_BLOCK = 1024


def padded_count(n: int, block: int = DEFAULT_BLOCK) -> int:
    """Smallest multiple of `block` that is >= max(n, 1)."""
    return -(-max(int(n), 1) // block) * block


def pad_codes_to_block(codes: np.ndarray, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Pad (N, code_size) packed codes to a multiple of `block` by repeating
    the last code (zeros when there is none). Host side (numpy): it runs once,
    when a builder finalizes."""
    codes = np.asarray(codes, dtype=np.uint8)
    n = codes.shape[0]
    n_pad = padded_count(n, block)
    if n == 0:
        return np.zeros((n_pad, codes.shape[1]), dtype=np.uint8)
    if n_pad == n:
        return codes
    return np.concatenate([codes, np.broadcast_to(codes[-1], (n_pad - n, codes.shape[1]))])


def pad_labels_to_block(labels: np.ndarray, block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Pad (N,) labels to a multiple of `block` by repeating the last label."""
    labels = np.asarray(labels, dtype=np.int32)
    n = labels.shape[0]
    n_pad = padded_count(n, block)
    if n == 0:
        return np.zeros((n_pad,), dtype=np.int32)
    if n_pad == n:
        return labels
    return np.concatenate([labels, np.full((n_pad - n,), labels[-1], dtype=np.int32)])


def codes_per_row(code_size: int) -> int:
    """Codes per 128-byte storage row."""
    if 128 % code_size != 0:
        raise ValueError(f"code_size {code_size} must divide 128")
    return 128 // code_size


def to_row128(codes: np.ndarray) -> np.ndarray:
    """(N_pad, code_size) packed codes -> (N_pad/cpr, 128) storage rows (numpy)."""
    n, cb = codes.shape
    cpr = codes_per_row(cb)
    if n % cpr != 0:
        raise ValueError(f"N {n} must be a multiple of {cpr}")
    return np.ascontiguousarray(codes).reshape(n // cpr, 128)


def from_row128(rows: np.ndarray, code_size: int) -> np.ndarray:
    """Inverse of to_row128."""
    r, width = rows.shape
    if width != 128:
        raise ValueError(f"storage rows must be 128 bytes wide, got {width}")
    return np.ascontiguousarray(rows).reshape(r * codes_per_row(code_size), code_size)


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
