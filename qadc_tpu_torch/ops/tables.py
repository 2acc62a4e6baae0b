"""ADC distance tables (counterpart of qadc_tpu/ops/tables.py)."""

from __future__ import annotations

import torch


def adc_tables(residuals: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """dists[..., m, k] = ||r_m - c_{m,k}||^2 for (rotated) residual queries.

    Args:
      residuals: (..., dim) float32.
      centroids: (M, K, dsq) float32 PQ codebooks, dim = M * dsq.

    Returns:
      (..., M, K) float32 tables.
    """
    m, _, dsq = centroids.shape
    r = residuals.to(torch.float32).reshape(*residuals.shape[:-1], m, dsq)
    r2 = torch.sum(r * r, dim=-1)
    c2 = torch.sum(centroids * centroids, dim=-1)
    cross = torch.einsum("...md,mkd->...mk", r, centroids)
    return r2[..., None] + c2 - 2.0 * cross
