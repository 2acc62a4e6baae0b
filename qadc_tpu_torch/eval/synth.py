"""Seeded synthetic IVF indexes, numpy only (no download, no training).

`bench_ivf_arrays` draws the index that the JAX package's bench.py
(`_make_ivf`) times, at the reference's published SIFT1M IVF geometry
(README.md:329-330): IVF-256, 16x4 PQ (8-byte codes, 16 per 128-byte row),
dim 128, 3906 real codes per partition padded to 4096, about 1M codes.
Codebooks, coarse centroids and codes are random, so the same seed gives the
same index in both packages. The moment-matched generators of
qadc_tpu/eval/synth.py feed trained indexes and wait for the port's build
path.
"""

from __future__ import annotations

import numpy as np


def bench_ivf_arrays(rng: np.random.Generator, parts: int = 256):
    """Checkpoint-shaped (arrays, manifest) of the bench IVF index.

    The draws are bench.py:_make_ivf's, in its order. `parts` below 256
    keeps every width and cuts only the partition count.
    """
    dim, part_pad, m, size = 128, 4096, 16, 3906
    arrays = {
        "pq_centroids": rng.normal(size=(m, 16, dim // m)).astype(np.float32),
        "coarse_centroids": rng.normal(size=(parts, dim)).astype(np.float32),
        "codes": rng.integers(0, 256, size=(parts, part_pad // 16, 128), dtype=np.uint8),
        "labels": np.arange(parts * part_pad, dtype=np.int32).reshape(parts, part_pad),
        "part_sizes": np.full((parts,), size, np.int32),
    }
    manifest = {"n": parts * size, "max_part_size": size,
                "pq": {"sq_bits": 4, "type": "pq"}}
    return arrays, manifest
