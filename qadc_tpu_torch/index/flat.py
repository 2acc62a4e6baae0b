"""Flat index (counterpart of qadc_tpu/index/flat.py).

Only the PQ reconstruction that the IVF 16-bit search shares with the flat
index is here so far; the flat index itself is still to be ported.
"""

from __future__ import annotations

import torch

from qadc_tpu_torch.quantizers.pq import ProductQuantizer


def decode_rows(pq: ProductQuantizer, idx: torch.Tensor) -> torch.Tensor:
    """PQ reconstruction of centroid indices.

    Args:
      idx: (..., M) integer centroid indices.

    Returns:
      (..., dim) float32: the M sub-quantizers' centroids, concatenated.
    """
    m, _, dsq = pq.centroids.shape
    sq = torch.arange(m, device=idx.device)
    return pq.centroids[sq, idx.long()].reshape(*idx.shape[:-1], m * dsq)
