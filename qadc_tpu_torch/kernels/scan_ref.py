"""Per-code ADC scans in plain PyTorch (counterpart of
qadc_tpu/kernels/scan_ref.py): every code scored with table lookups, and an
exact top-r chunked over the codes.

They serve the flat index's per-code paths (windowed=False, or a geometry
outside the scan kernels' gates), as the JAX versions serve its CPU paths.
The JAX versions sum by a one-hot matmul; these sum the lookups in the
order m = 0..M-1.
"""

from __future__ import annotations

import torch

from qadc_tpu_torch.core.packing import unpack_codes
from qadc_tpu_torch.ops.topk import merge_topk, topk_smallest


def _scan(codes_packed, tables, sq_bits: int, dtype: torch.dtype):
    """(Q, B) sums over m of tables[q, m, idx[b, m]], in the order m = 0..M-1."""
    q, m, _ = tables.shape
    idx = unpack_codes(codes_packed, m, sq_bits).long()     # (B, M)
    tab = tables.to(dtype)
    acc = torch.zeros((q, idx.shape[0]), dtype=dtype, device=tables.device)
    for mm in range(m):
        acc = acc + tab[:, mm][:, idx[:, mm]]
    return acc


def adc_scan_f32(codes_packed, tables, sq_bits: int):
    """Float ADC distances (Q, B) of (B, code_bytes) codes against (Q, M, K)
    float32 tables, at 4, 8 or 16 bits."""
    return _scan(codes_packed, tables, sq_bits, torch.float32)


def adc_scan_int8(codes_packed, qtables, saturate: bool = True):
    """Quick-ADC int32 distances (Q, B) of 4-bit codes against (Q, M, 16)
    int8 tables (entries in [0, 127]); saturate clamps the sums at 127, the
    reference's saturating int8 adds (simd_scan.hpp:161)."""
    acc = _scan(codes_packed, qtables, 4, torch.int32)
    return torch.clamp(acc, max=127) if saturate else acc


def _chunked_scan_topk(codes_packed, labels, q: int, r: int, chunk: int, scan_chunk_fn,
                       num_valid=None):
    """Scan codes in chunks, merging each chunk's top-r into the running one.

    num_valid: codes at or past it are padding and scored +inf.
    Returns (vals (Q, r) float32 ascending, labels (Q, r)).
    """
    n = codes_packed.shape[0]
    dev = codes_packed.device
    best_v = torch.full((q, r), torch.inf, dtype=torch.float32, device=dev)
    best_l = torch.zeros((q, r), dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        d = scan_chunk_fn(codes_packed[s:e]).to(torch.float32)
        if num_valid is not None:
            col = torch.arange(s, e, device=dev)
            d = torch.where(col < num_valid, d, torch.inf)
        lab = labels[s:e].expand(q, e - s)
        cv, cl = topk_smallest(d, lab, min(r, e - s))
        best_v, best_l = merge_topk(best_v, best_l, cv, cl, r)
    return best_v, best_l


def scan_topk_f32(codes_packed, labels, tables, sq_bits: int, r: int, chunk: int = 65536,
                  num_valid: int | None = None):
    """Float ADC scan and exact top-r, chunked over the codes.

    Args:
      codes_packed: (N_pad, code_bytes) uint8.
      labels: (N_pad,) int32 (padded tail clamped to the last real label).
      tables: (Q, M, K) float32.
      num_valid: real code count; padded codes are masked out.

    Returns (vals (Q, r) float32 ascending, labels (Q, r) int32).
    """
    return _chunked_scan_topk(codes_packed, labels, tables.shape[0], r, chunk,
                              lambda c: adc_scan_f32(c, tables, sq_bits), num_valid)


def scan_topk_int8(codes_packed, labels, qtables, r: int, chunk: int = 65536,
                   num_valid: int | None = None, saturate: bool = False):
    """Quick-ADC int8 scan and exact top-r, chunked over the codes.

    Returns (vals (Q, r) float32 quantized distances, labels (Q, r) int32).
    """
    return _chunked_scan_topk(codes_packed, labels, qtables.shape[0], r, chunk,
                              lambda c: adc_scan_int8(c, qtables, saturate), num_valid)
