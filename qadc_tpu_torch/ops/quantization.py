"""Int8 table quantization and the keep-prefix bound (counterpart of
qadc_tpu/ops/quantization.py).

QuantizerMAX (reference db_query_4.cpp:38-71): delta = (qmax - qmin) / 127;
q(v) = 127 if v >= qmax, else trunc((v - qmin) / delta), negatives clamped.
"""

from __future__ import annotations

import torch


def clamp_bound_to_max_distance(bound: torch.Tensor, max_possible: torch.Tensor):
    """Replace non-finite bounds by the query's largest possible distance."""
    return torch.where(torch.isfinite(bound), bound, max_possible * (1.0 + 1e-6))


def quantize_tables_int8(tables: torch.Tensor, qmax, qmin) -> torch.Tensor:
    """Quantize float ADC tables to int8 in [0, 127] per QuantizerMAX.

    Args:
      tables: (..., M, K) float32.
      qmax, qmin: per-query bounds broadcastable to tables.
    """
    tables = torch.clamp(tables.to(torch.float32), min=0.0)
    delta = (qmax - qmin) / 127.0
    scaled = (tables - qmin) / torch.clamp(delta, min=1e-30)
    # Truncation toward zero, then clip to [0, 127]; clamping before the
    # conversion keeps out-of-range floats defined (same result in range).
    q = torch.clamp(scaled, 0.0, 128.0).to(torch.int32).clamp(0, 127)
    q = torch.where(tables >= qmax, 127, q)
    return q.to(torch.int8)


def int8_tables(tables: torch.Tensor, bound: torch.Tensor) -> torch.Tensor:
    """QuantizerMAX int8 tables of per-query float tables (Q, ..., M, K)
    under the per-query bound (Q,): a bound that is not finite becomes the
    query's largest possible distance (over its probes), and qmin is the
    smallest non-negative table entry of the query."""
    tables_nn = torch.clamp(tables, min=0.0)
    max_possible = tables_nn.amax(dim=-1).sum(dim=-1)
    while max_possible.dim() > 1:
        max_possible = max_possible.amax(dim=-1)
    bound = clamp_bound_to_max_distance(bound, max_possible)
    qmin = tables_nn.flatten(1).amin(dim=1)
    shape = (-1,) + (1,) * (tables.dim() - 1)
    return quantize_tables_int8(tables, bound.reshape(shape), qmin.reshape(shape))


def keep_prefix_bound(prefix_dists: torch.Tensor, r: int, valid_mask=None):
    """R-th smallest of {+inf} U prefix distances (the reference's R-heap
    seeded with +inf, db_query_4.cpp:230-242). Returns (...,) float32."""
    d = prefix_dists.to(torch.float32)
    if valid_mask is not None:
        d = torch.where(valid_mask, d, torch.inf)
    if d.shape[-1] < r:
        return torch.full(d.shape[:-1], torch.inf, dtype=torch.float32, device=d.device)
    sv, _ = torch.sort(d, dim=-1, stable=True)
    return sv[..., r - 1]
