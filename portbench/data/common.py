"""Helpers of the seeded generators: draws on the generator's device, in
chunks of rows so that the transients of a 1M x 960 set stay small."""

from __future__ import annotations

import torch

CHUNK_ROWS = 131_072


def gamma(gen, shape, alpha: float, scale: float, device) -> torch.Tensor:
    conc = torch.full(shape, alpha, dtype=torch.float32, device=device)
    return torch._standard_gamma(conc, generator=gen) * scale


def lognormal(gen, shape, sigma: float, device) -> torch.Tensor:
    return torch.empty(shape, dtype=torch.float32, device=device).log_normal_(
        0.0, sigma, generator=gen)


def normal(gen, shape, device) -> torch.Tensor:
    return torch.randn(shape, dtype=torch.float32, device=device, generator=gen)


def pick(gen, centers: torch.Tensor, k: int) -> torch.Tensor:
    idx = torch.randint(0, centers.shape[0], (k,), device=centers.device, generator=gen)
    return centers[idx]


def chunked(chunk, n: int, dim: int, device) -> torch.Tensor:
    out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for s in range(0, n, CHUNK_ROWS):
        out[s:s + CHUNK_ROWS] = chunk(min(CHUNK_ROWS, n - s))
    return out
