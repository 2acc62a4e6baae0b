"""Exact batched k-NN (counterpart of qadc_tpu/ops/knn.py)."""

from __future__ import annotations

import torch


def exact_knn(queries: torch.Tensor, base: torch.Tensor, k: int):
    """Exact k nearest neighbors under squared L2.

    Scores are 2 q.b - ||b||^2 (larger is nearer), ranked by a stable
    descending sort so ties go to the lower index, as lax.top_k does.

    Returns (dists (Q, k) float32 ascending, idx (Q, k) int32).
    """
    queries = queries.to(torch.float32)
    base = base.to(torch.float32)
    b2 = torch.sum(base * base, dim=-1)
    scores = 2.0 * torch.matmul(queries, base.T) - b2[None, :]
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    return q2 - top, idx.to(torch.int32).contiguous()
