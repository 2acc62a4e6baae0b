"""SIFT1M stand-in drawn on the device: a copy of the port's
`eval/synth.sift_moment_like` (gamma-distributed cluster centres shaped by
SIFT's 4x4x8 cell-energy profile, lognormal illumination, channel noise,
rounded to uint8 values), drawn with one `torch.Generator` on the card in
chunks of rows. The draws are not numpy's: a seed gives another set than
the host generator's, with the same moments."""

from __future__ import annotations

import torch

from portbench.data.common import chunked, gamma, lognormal, normal, pick

CELLS = (0.55, 0.75, 0.75, 0.55,
         0.75, 1.0, 1.0, 0.75,
         0.75, 1.0, 1.0, 0.75,
         0.55, 0.75, 0.75, 0.55)


def draw(gen: torch.Generator, counts, clusters: int = 2048, spread: float = 0.5,
         dim: int = 128) -> list[torch.Tensor]:
    """One (count, dim) float32 set on gen's device for each of `counts`,
    all around the same cluster centres, in order."""
    dev = gen.device
    profile = torch.tensor(CELLS, device=dev).repeat_interleave(8)[:dim]
    centers = gamma(gen, (clusters, dim), 1.2, 40.0, dev) * profile

    def chunk(k):
        c = pick(gen, centers, k)
        x = c * lognormal(gen, (k, 1), spread, dev)
        x = x + normal(gen, (k, dim), dev) * (spread * (c + 8.0))
        return torch.clamp(torch.round(x), 0.0, 255.0)

    return [chunked(chunk, n, dim, dev) for n in counts]
