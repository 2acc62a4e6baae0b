"""Plain reference training, in PyTorch alone, for judging the program's.

The search checks (check.py) follow the program's trained quantizer step by
step. This module judges that quantizer by itself: it trains its own from
the same learn set, by the published algorithms written plainly (k-means++
seeding and Lloyd iterations for the coarse quantizer; OPQ-NP, Ge et al.,
CVPR 2013, for the rotation and codebooks: alternate a Lloyd refresh of
the sub-space codebooks and an orthogonal Procrustes update of the
rotation), with the configuration's iteration counts, and compares how well
each reconstructs the same held-out base vectors.

It imports nothing of the program and nothing of JAX, and takes nothing the
program made: only the learn set, the held-out vectors and a seed of its
own. Every product is float32 unless the caller's `precision` says TF32.
"""

from __future__ import annotations

import dataclasses

import torch

CHUNK = 16_384      # rows a distance block, so an (N, K) matrix stays small


@dataclasses.dataclass
class Model:
    """A trained quantizer: coarse (P, dim) or None (flat), rotation
    (dim, dim) with rotate(x) = x @ rotation.T, codebooks (M, K, dim / M)."""

    coarse: torch.Tensor | None
    rotation: torch.Tensor
    codebooks: torch.Tensor


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, N) index of each row's nearest centroid; x (B, N, d), c (B, K, d)."""
    out = torch.empty(x.shape[:2], dtype=torch.int64, device=x.device)
    c2 = (c * c).sum(-1)[:, None, :]
    for s in range(0, x.shape[1], CHUNK):
        xs = x[:, s:s + CHUNK]
        out[:, s:s + CHUNK] = (c2 - 2.0 * torch.bmm(xs, c.transpose(1, 2))).argmin(-1)
    return out


def lloyd(x: torch.Tensor, c: torch.Tensor, iters: int) -> torch.Tensor:
    """Lloyd iterations of B independent problems: x (B, N, d), c (B, K, d).
    A cluster that empties keeps its centroid."""
    b, _, d = x.shape
    k = c.shape[1]
    for _ in range(iters):
        a = _assign(x, c)
        sums = torch.zeros((b, k, d), device=x.device).scatter_add_(
            1, a[..., None].expand(-1, -1, d), x)
        counts = torch.zeros((b, k), device=x.device).scatter_add_(
            1, a, torch.ones(a.shape, device=x.device))
        c = torch.where(counts[..., None] > 0, sums / counts.clamp(min=1.0)[..., None], c)
    return c


def kmeans(gen: torch.Generator, x: torch.Tensor, k: int, iters: int) -> torch.Tensor:
    """k centroids of each of B problems x (B, N, d): k-means++ seeding (the
    first a uniform row, each next a row drawn in proportion to its squared
    distance to the nearest chosen so far), then `iters` Lloyd iterations."""
    b, n, _ = x.shape
    rows = torch.arange(b, device=x.device)
    first = x[rows, torch.randint(0, n, (b,), generator=gen, device=x.device)]
    chosen = [first]
    near = ((x - first[:, None]) ** 2).sum(-1)                          # (B, N)
    for _ in range(k - 1):
        weight = torch.where(near.sum(-1, keepdim=True) > 0, near.clamp(min=0.0), 1.0)
        c = x[rows, torch.multinomial(weight, 1, generator=gen)[:, 0]]
        chosen.append(c)
        near = torch.minimum(near, ((x - c[:, None]) ** 2).sum(-1))
    return lloyd(x, torch.stack(chosen, 1), iters)


def _subspaces(y: torch.Tensor, m: int) -> torch.Tensor:
    """(N, dim) -> (M, N, dim / M)."""
    return y.reshape(y.shape[0], m, -1).transpose(0, 1).contiguous()


def _decode(codebooks: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """codes (M, N) -> (N, dim): each sub-space's centroid, side by side."""
    m, _, dsq = codebooks.shape
    picked = torch.gather(codebooks, 1, codes[..., None].expand(-1, -1, dsq))
    return picked.transpose(0, 1).reshape(codes.shape[1], m * dsq)


def train_opq(gen: torch.Generator, x: torch.Tensor, m: int, bits: int, opq_iters: int,
              kmeans_iters: int) -> tuple[torch.Tensor, torch.Tensor]:
    """OPQ-NP from the identity: a PQ on x, then opq_iters rounds of
    (encode, Procrustes update of the rotation, Lloyd refresh of the
    codebooks under it). Returns (rotation (dim, dim), codebooks)."""
    rotation = torch.eye(x.shape[1], device=x.device)
    codebooks = kmeans(gen, _subspaces(x, m), 1 << bits, kmeans_iters)
    for _ in range(opq_iters):
        y = _decode(codebooks, _assign(_subspaces(x @ rotation.T, m), codebooks))
        u, _, vh = torch.linalg.svd(x.T @ y, full_matrices=False)
        rotation = (u @ vh).T           # min ||x R^T - y||: R^T = U V^T
        codebooks = lloyd(_subspaces(x @ rotation.T, m), codebooks, kmeans_iters)
    return rotation, codebooks


def train(gen: torch.Generator, learn: torch.Tensor, cfg: dict) -> Model:
    """The reference's quantizer for a configuration: for IVF a coarse
    k-means of `part_count` centroids and an OPQ on the residuals, for a
    flat index an OPQ on the vectors."""
    coarse = None
    x = learn
    if cfg["index"] == "ivf":
        coarse = kmeans(gen, learn[None], cfg["part_count"], cfg["coarse_iters"])[0]
        x = learn - coarse[_assign(learn[None], coarse[None])[0]]
    rotation, codebooks = train_opq(gen, x, cfg["sq_count"], cfg["sq_bits"], cfg["opq_iters"],
                                    cfg["kmeans_iters"])
    return Model(coarse, rotation, codebooks)


def distortion(model: Model, vectors: torch.Tensor) -> float:
    """Mean squared distance of each vector to its reconstruction: the
    nearest coarse centroid plus the rotated-back nearest sub-space
    centroids of the rotated residual (rotate back: y @ rotation)."""
    res = vectors
    if model.coarse is not None:
        res = vectors - model.coarse[_assign(vectors[None], model.coarse[None])[0]]
    m = model.codebooks.shape[0]
    codes = _assign(_subspaces(res @ model.rotation.T, m), model.codebooks)
    back = _decode(model.codebooks, codes) @ model.rotation
    return float(((res - back) ** 2).sum(-1).mean())
