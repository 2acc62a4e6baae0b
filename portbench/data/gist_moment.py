"""GIST1M stand-in drawn on the device: a copy of the port's
`eval/synth.gist_moment_like` (scene-type cluster centres with a smooth
4x4-cell energy envelope over dim / 16 channels a cell, lognormal global
illumination, a lognormal activation a cell shared by its channels, channel
noise, clipped to [0, 1]), drawn with one `torch.Generator` on the card in
chunks of rows: ~50 s on the host for 1M x 960, a fraction of a second
here. The draws are not numpy's."""

from __future__ import annotations

import torch

from portbench.data.common import chunked, gamma, lognormal, normal, pick

CELLS = (0.7, 0.85, 0.85, 0.7,
         0.85, 1.0, 1.0, 0.85,
         0.85, 1.0, 1.0, 0.85,
         0.7, 0.85, 0.85, 0.7)


def draw(gen: torch.Generator, counts, clusters: int = 2048, spread: float = 0.45,
         dim: int = 960) -> list[torch.Tensor]:
    """One (count, dim) float32 set on gen's device for each of `counts`,
    all around the same cluster centres, in order."""
    dev = gen.device
    cells, chans = len(CELLS), dim // len(CELLS)
    profile = torch.tensor(CELLS, device=dev).repeat_interleave(chans)[:dim]
    centers = gamma(gen, (clusters, dim), 1.5, 0.045, dev) * profile

    def chunk(k):
        c = pick(gen, centers, k)
        g = lognormal(gen, (k, 1), spread, dev)
        act = lognormal(gen, (k, cells), spread * 0.8, dev).repeat_interleave(chans, dim=1)
        noise = normal(gen, (k, dim), dev) * (spread * 0.35 * (c + 0.01))
        return torch.clamp(c * g * act[:, :dim] + noise, 0.0, 1.0)

    return [chunked(chunk, n, dim, dev) for n in counts]
