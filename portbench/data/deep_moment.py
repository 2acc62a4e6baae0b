"""Deep1B stand-in drawn on the device. Deep1B's vectors (Babenko and
Lempitsky, CVPR 2016) are GoogLeNet activations compressed by PCA to 96
dimensions and L2-normalised. A draw follows those published properties:

  - a mixture of `components` normal components of equal weight, whose
    centres are drawn from a zero-mean normal with standard deviation
    (d + 1) ** (-decay / 2) in dimension d (from 0): a PCA output's
    variance falls with the component's index, here as a power law;
  - each vector its component's centre plus noise of the same profile,
    `within` times the centres' spread, so the whole set keeps the
    spectrum;
  - each vector then scaled to unit L2 norm.

Rows are drawn in blocks of BLOCK_ROWS from one `torch.Generator` on the
generator's device, inside `common.chunked`'s chunks (100M x 96 float32 is
38.4 GB): a set is the same whatever the chunk, if it is a multiple of
BLOCK_ROWS."""

from __future__ import annotations

import torch

from portbench.data import common
from portbench.data.common import chunked, normal, pick

BLOCK_ROWS = 8192


def draw(gen: torch.Generator, counts, components: int = 1 << 20, within: float = 1.0,
         decay: float = 1.0, dim: int = 96) -> list[torch.Tensor]:
    """One (count, dim) float32 set of unit vectors on gen's device for each
    of `counts`, all from the same mixture, in order."""
    if common.CHUNK_ROWS % BLOCK_ROWS:
        raise ValueError(f"CHUNK_ROWS {common.CHUNK_ROWS} is no multiple of {BLOCK_ROWS}")
    dev = gen.device
    profile = (torch.arange(dim, dtype=torch.float32, device=dev) + 1.0) ** (-decay / 2)
    centers = normal(gen, (components, dim), dev) * profile

    def block(k):
        x = pick(gen, centers, k) + normal(gen, (k, dim), dev) * (within * profile)
        return x / x.norm(dim=1, keepdim=True)

    def chunk(k):
        return torch.cat([block(min(BLOCK_ROWS, k - s)) for s in range(0, k, BLOCK_ROWS)])

    return [chunked(chunk, n, dim, dev) for n in counts]
