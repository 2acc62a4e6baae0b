"""PQ code packing (counterpart of qadc_tpu/core/packing.py).

The byte layout is the reference's (quantizers.hpp:35-68), so codes are the
same bytes in both packages:
  - 4-bit: byte b holds sub-quantizer 2b in the LOW nibble and 2b+1 in the
    HIGH nibble; code_size = sq_count / 2 bytes.
  - 8-bit: one byte per sub-quantizer, in order.
  - 16-bit: one little-endian uint16 per sub-quantizer, in order
    ([lo0, hi0, lo1, hi1, ...]).
"""

from __future__ import annotations

import torch

SUPPORTED_BITS = (4, 8, 16)


def code_bytes(sq_count: int, sq_bits: int) -> int:
    """Bytes of one packed code (the reference's base_pq::code_size,
    quantizers.hpp:197-199). Raises ValueError for an unsupported sq_bits or
    a code that does not fill whole bytes."""
    if sq_bits not in SUPPORTED_BITS:
        raise ValueError(f"sq_bits must be one of {SUPPORTED_BITS}, got {sq_bits}")
    if (sq_count * sq_bits) % 8 != 0:
        raise ValueError(f"sq_count*sq_bits must be a multiple of 8 ({sq_count}x{sq_bits})")
    return sq_count * sq_bits // 8


def pack_codes(indices: torch.Tensor, sq_bits: int = 4) -> torch.Tensor:
    """(..., sq_count) centroid indices < 2**sq_bits -> (..., code_size) uint8."""
    if sq_bits == 4:
        if indices.shape[-1] % 2 != 0:
            raise ValueError("4-bit packing requires even sq_count")
        lo = indices[..., 0::2].to(torch.uint8)
        hi = indices[..., 1::2].to(torch.uint8)
        return lo | (hi << 4)
    if sq_bits == 8:
        return indices.to(torch.uint8)
    if sq_bits == 16:
        v = indices.to(torch.int32)
        lohi = torch.stack([v & 0xFF, (v >> 8) & 0xFF], dim=-1).to(torch.uint8)
        return lohi.reshape(*indices.shape[:-1], 2 * indices.shape[-1])
    raise ValueError(f"sq_bits must be one of {SUPPORTED_BITS}, got {sq_bits}")


def unpack_codes(packed: torch.Tensor, sq_count: int | None = None,
                 sq_bits: int = 4) -> torch.Tensor:
    """(..., code_size) uint8 -> (..., sq_count) int32 centroid indices.

    sq_count defaults to what code_size holds at sq_bits.
    """
    if sq_bits not in SUPPORTED_BITS:
        raise ValueError(f"sq_bits must be one of {SUPPORTED_BITS}, got {sq_bits}")
    width = packed.shape[-1] * 8 // sq_bits
    if sq_count is not None and sq_count != width:
        raise ValueError(f"{packed.shape[-1]} code bytes hold {width} "
                         f"{sq_bits}-bit sub-quantizers, not {sq_count}")
    p = packed.to(torch.int32)
    if sq_bits == 4:
        return torch.stack([p & 0x0F, p >> 4], dim=-1).reshape(*packed.shape[:-1], width)
    if sq_bits == 8:
        return p
    p = p.reshape(*packed.shape[:-1], width, 2)
    return p[..., 0] | (p[..., 1] << 8)


def gather_codes_row128(rows128: torch.Tensor, code_ids: torch.Tensor,
                        code_size: int) -> torch.Tensor:
    """Packed codes by global code index from row128 storage.

    rows128: (R, 128) uint8; code_ids: (...,) integer code indices.
    Returns (..., code_size) uint8: one gather over the (R*cpr, code_size)
    view of the storage (core/layout.code_view).
    """
    return rows128.reshape(-1, code_size)[code_ids.long()]


def row128_to_codes(rows: torch.Tensor, code_size: int) -> torch.Tensor:
    """(R, 128) uint8 storage rows -> (R * cpr, code_size) packed codes, a
    view of the same bytes (the inverse of core/layout.to_row128)."""
    return rows.reshape(rows.shape[0] * (128 // code_size), code_size)


def unpack_nibbles_split(packed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(lo, hi) nibble planes of packed 4-bit codes, each (..., code_bytes)
    int32: the even sub-quantizers' indices and the odd ones', not
    interleaved."""
    p = packed.to(torch.int32)
    return p & 0x0F, p >> 4
