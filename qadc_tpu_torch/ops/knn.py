"""Exact batched k-NN (counterpart of qadc_tpu/ops/knn.py)."""

from __future__ import annotations

import torch

from qadc_tpu_torch.core.tensors import full_f32_matmul


def _neg_scores(queries: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """-(||q-b||^2 - ||q||^2) = 2 q.b - ||b||^2: larger is nearer. (.., Q, dim)
    against (.., N, dim), leading batch dimensions alike. The product runs in
    full float32 (no TF32)."""
    b2 = torch.sum(base * base, dim=-1)
    with full_f32_matmul():
        cross = torch.matmul(queries, base.transpose(-1, -2))
    # One pass, -b2 + 2 cross: the same float32 value as 2.0 * cross - b2
    # (doubling is exact), without the doubled product's own pass over the
    # (.., Q, N) scores.
    return torch.add(-b2[..., None, :], cross, alpha=2.0)


def exact_knn(queries: torch.Tensor, base: torch.Tensor, k: int):
    """Exact k nearest neighbors under squared L2.

    Scores are 2 q.b - ||b||^2 (larger is nearer), ranked by a stable
    descending sort so ties go to the lower index, as lax.top_k does.

    Returns (dists (Q, k) float32 ascending, idx (Q, k) int32).
    """
    queries = queries.to(torch.float32)
    base = base.to(torch.float32)
    scores = _neg_scores(queries, base)
    top, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    top, idx = top[:, :k], idx[:, :k]
    q2 = torch.sum(queries * queries, dim=-1, keepdim=True)
    return q2 - top, idx.to(torch.int32).contiguous()


def assign_nearest(vectors: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """Nearest base index per vector, (N,) int32 (k = 1, no distances).

    torch.argmax returns the first maximum, so ties go to the lower index,
    as jnp.argmax does.
    """
    scores = _neg_scores(vectors.to(torch.float32), base.to(torch.float32))
    return torch.argmax(scores, dim=-1).to(torch.int32)
