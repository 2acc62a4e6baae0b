"""Seeded synthetic data, numpy only (no download): random indexes at the
bench geometries, and moment-matched vector sets for trained indexes.

`bench_ivf_arrays` draws the index that the JAX package's bench.py
(`_make_ivf`) times, at the reference's published SIFT1M IVF geometry
(README.md:329-330): IVF-256, 16x4 PQ (8-byte codes, 16 per 128-byte row),
dim 128, 3906 real codes per partition padded to 4096, about 1M codes.
`bench_ivf8_arrays` draws bench.py's `_make_ivf8` (the same geometry at 8x8
PQ), and `bench_ivf16_arrays` a 16-bit index of the same geometry (8x16 PQ,
16-byte codes), which bench.py does not time. `bench_flat_arrays` draws a
flat index at the reference's flat SIFT1M size (1M codes, dim 128). Codebooks,
coarse centroids and codes are random, so the same seed gives the same index
in both packages.

`sift_moment_like` and `gist_moment_like` are the port's own copies of the
JAX package's generators (qadc_tpu/eval/synth.py), draw for draw: vector
sets tuned to land trained indexes in the recall regime of SIFT1M / GIST1M,
for recall against true neighbours where the real files cannot be had.
"""

from __future__ import annotations

import numpy as np

from qadc_tpu_torch.core.layout import DEFAULT_BLOCK

DIM, PART_PAD, PART_SIZE = 128, 4096, 3906


def _ivf_arrays(rng, parts: int, m: int, sq_bits: int):
    """Draw codebooks, coarse centroids and codes in bench.py's order."""
    code_size = m * sq_bits // 8
    arrays = {
        "pq_centroids": rng.normal(size=(m, 1 << sq_bits, DIM // m)).astype(np.float32),
        "coarse_centroids": rng.normal(size=(parts, DIM)).astype(np.float32),
        "codes": rng.integers(0, 256, size=(parts, PART_PAD * code_size // 128, 128),
                              dtype=np.uint8),
        "labels": np.arange(parts * PART_PAD, dtype=np.int32).reshape(parts, PART_PAD),
        "part_sizes": np.full((parts,), PART_SIZE, np.int32),
    }
    manifest = {"n": parts * PART_SIZE, "max_part_size": PART_SIZE,
                "pq": {"sq_bits": sq_bits, "type": "pq"}}
    return arrays, manifest


def bench_ivf_arrays(rng: np.random.Generator, parts: int = 256):
    """Checkpoint-shaped (arrays, manifest) of the bench IVF index (16x4).

    The draws are bench.py:_make_ivf's, in its order. `parts` below 256
    keeps every width and cuts only the partition count.
    """
    return _ivf_arrays(rng, parts, 16, 4)


def bench_ivf8_arrays(rng: np.random.Generator, parts: int = 256):
    """(arrays, manifest) of bench.py:_make_ivf8's index (8x8), its draws in
    its order; `parts` cuts the partition count only."""
    return _ivf_arrays(rng, parts, 8, 8)


def bench_ivf16_arrays(rng: np.random.Generator, parts: int = 256):
    """(arrays, manifest) of a 16-bit index at the bench geometry: 8x16 PQ
    (65536 centroids a sub-quantizer, 16-byte codes, 8 per row)."""
    return _ivf_arrays(rng, parts, 8, 16)


def bench_flat_arrays(rng: np.random.Generator, m: int, sq_bits: int, n: int = 1_000_000):
    """Checkpoint-shaped (arrays, manifest) of a flat index of n codes at
    m x sq_bits PQ, dim 128, padded as FlatBuilder pads (to a multiple of
    DEFAULT_BLOCK codes: 1,000,448 at n = 1M), but with random codes past n,
    as the bench IVF indexes are, so every padded code differs from the
    real ones. `n` cuts the code count only."""
    code_size = m * sq_bits // 8
    n_pad = -(-n // DEFAULT_BLOCK) * DEFAULT_BLOCK
    arrays = {
        "pq_centroids": rng.normal(size=(m, 1 << sq_bits, DIM // m)).astype(np.float32),
        "codes": rng.integers(0, 256, size=(n_pad * code_size // 128, 128), dtype=np.uint8),
    }
    return arrays, {"n": n, "pq": {"sq_bits": sq_bits, "type": "pq"}}


def sift_moment_like(rng, n, nq=256, clusters=2048, spread=0.5, dim=128):
    """SIFT-moment-matched (base (n, dim), queries (nq, dim)) float32.

    Gamma marginals with SIFT's 4x4x8 cell-energy profile (corner and edge
    cells carry less gradient energy), hierarchical clusters, per-sample
    illumination scaling, uint8 quantization.
    """
    cell_w = np.array([
        0.55, 0.75, 0.75, 0.55,
        0.75, 1.0, 1.0, 0.75,
        0.75, 1.0, 1.0, 0.75,
        0.55, 0.75, 0.75, 0.55,
    ])
    profile = np.repeat(cell_w, 8)[:dim]
    centers = rng.gamma(1.2, 40.0, size=(clusters, dim)).astype(np.float32)
    centers *= profile[None, :]

    def draw(k):
        c = centers[rng.integers(0, clusters, k)]
        x = c * rng.lognormal(0.0, spread, size=(k, 1)).astype(np.float32)
        x = x + rng.normal(scale=spread * (c + 8.0)).astype(np.float32)
        return np.clip(np.rint(x), 0, 255).astype(np.float32)

    return draw(n), draw(nq)


def gist_moment_like(rng, n, nq=256, clusters=2048, spread=0.45, dim=960):
    """GIST-moment-matched (base (n, dim), queries (nq, dim)) float32.

    Scene-type cluster centers with a smooth per-cell energy envelope over a
    4x4 grid of dim/16 channels, per-sample global illumination (lognormal),
    per-cell activation jitter shared by a cell's channels, plus channel
    noise; small positive floats, no rounding.
    """
    cells, chans = 16, dim // 16
    cell_w = np.array([
        0.7, 0.85, 0.85, 0.7,
        0.85, 1.0, 1.0, 0.85,
        0.85, 1.0, 1.0, 0.85,
        0.7, 0.85, 0.85, 0.7,
    ])
    profile = np.repeat(cell_w, chans)[:dim]
    centers = rng.gamma(1.5, 0.045, size=(clusters, dim)).astype(np.float32)
    centers *= profile[None, :]

    def draw(k):
        c = centers[rng.integers(0, clusters, k)]
        g = rng.lognormal(0.0, spread, size=(k, 1)).astype(np.float32)
        cell_act = rng.lognormal(0.0, spread * 0.8, size=(k, cells)).astype(np.float32)
        act = np.repeat(cell_act, chans, axis=1)[:, :dim]
        x = c * g * act + rng.normal(scale=spread * 0.35 * (c + 0.01)).astype(np.float32)
        return np.clip(x, 0.0, 1.0).astype(np.float32)

    return draw(n), draw(nq)
