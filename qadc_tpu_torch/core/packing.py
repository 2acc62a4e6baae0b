"""4-bit PQ code packing (counterpart of qadc_tpu/core/packing.py).

Byte b of a packed code holds sub-quantizer 2b in the LOW nibble and
sub-quantizer 2b+1 in the HIGH nibble (reference: multiple_set_bits_4,
quantizers.hpp:49-68); code_size = sq_count / 2 bytes.
"""

from __future__ import annotations

import torch


def pack_codes(indices: torch.Tensor) -> torch.Tensor:
    """(..., sq_count) centroid indices < 16 -> (..., sq_count/2) uint8."""
    if indices.shape[-1] % 2 != 0:
        raise ValueError("4-bit packing requires even sq_count")
    lo = indices[..., 0::2].to(torch.uint8)
    hi = indices[..., 1::2].to(torch.uint8)
    return lo | (hi << 4)


def unpack_codes(packed: torch.Tensor) -> torch.Tensor:
    """(..., code_bytes) uint8 -> (..., 2*code_bytes) int32 centroid indices."""
    p = packed.to(torch.int32)
    out = torch.stack([p & 0x0F, p >> 4], dim=-1)
    return out.reshape(*packed.shape[:-1], 2 * packed.shape[-1])
