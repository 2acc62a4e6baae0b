"""Shared fixtures for the tests that hold qadc_tpu_torch to qadc_tpu.

Both packages get the same inputs, made with numpy from a seed: the JAX side
runs on the CPU (Pallas kernels in interpret mode), the port on CPU tensors
(the plain versions of its kernels).

  trained_index(): the trained small index of tests/test_ivf_grouped.py
    (dim 32, 16x4 PQ, 16 partitions, 30k vectors). part_pad is not a
    multiple of 2048, so the JAX grouped path runs the row128 kernel
    (lut_scan_grouped_prefetch); planes are dropped to make sure.
  synthetic_index(): a numpy-made index in the manner of bench.py:_make_ivf
    (8 partitions, part_pad 2048, random sizes with one empty and one tiny
    partition) carrying tq planes, so the JAX grouped path runs
    lut_scan_grouped_tq (lut_scan8_grouped_tq at 8 bits); other code widths
    by m and sq_bits.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from qadc_tpu.index import ivf as jivf
from qadc_tpu.ops.knn import assign_nearest, exact_knn
from qadc_tpu.quantizers.pq import ProductQuantizer, train_pq
from qadc_tpu_torch.convert import ivf_index_from_arrays

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps these small tensors from crowding the others.
torch.set_num_threads(1)

EMPTY_PART = 3   # synthetic_index: partition with no codes
TINY_PART = 5    # synthetic_index: partition with TINY_SIZE codes
TINY_SIZE = 5


def index_arrays(index) -> tuple[dict, dict]:
    """The (arrays, manifest) that qadc_tpu's save_index would write."""
    arrays = {
        "codes": np.asarray(index.codes),
        "labels": np.asarray(index.labels),
        "part_sizes": np.asarray(index.part_sizes),
        "coarse_centroids": np.asarray(index.coarse_centroids, np.float32),
        "pq_centroids": np.asarray(index.pq.centroids, np.float32),
    }
    if getattr(index.pq, "rotation", None) is not None:
        arrays["pq_rotation"] = np.asarray(index.pq.rotation, np.float32)
    meta = {"n": index.n, "max_part_size": index.max_part_size,
            "pq": {"sq_bits": index.pq.sq_bits}}
    return arrays, meta


def to_port(index, device="cpu"):
    """The port's IVFIndex holding the same arrays as a qadc_tpu IVFIndex."""
    arrays, meta = index_arrays(index)
    return ivf_index_from_arrays(arrays, meta, torch.device(device))


@functools.cache
def trained_index():
    """(jax index without planes, queries (32, 32), ground truth (32, 1))."""
    rng = np.random.default_rng(5)
    dim, n = 32, 30000
    centers = rng.normal(scale=3.0, size=(16, dim)).astype(np.float32)
    base = (centers[rng.integers(0, 16, n)] + rng.normal(size=(n, dim))).astype(np.float32)
    queries = (centers[rng.integers(0, 16, 32)] + rng.normal(size=(32, dim))).astype(np.float32)
    coarse = jivf.train_coarse(jax.random.PRNGKey(0), base[:6000], 16, iters=10)
    a = np.asarray(assign_nearest(base[:6000], coarse))
    pq = train_pq(jax.random.PRNGKey(1), base[:6000] - np.asarray(coarse)[a], 16, 4, iters=10)
    index = jivf.add(jivf.IVFIndex.create(pq, coarse), base)
    if index.planes is not None:
        index = dataclasses.replace(index, planes=None)
    _, gt = exact_knn(queries, base, 1)
    return index, queries, np.asarray(gt)


@functools.cache
def synthetic_index(seed: int = 11, m: int = 16, sq_bits: int = 4):
    """(jax index with planes where its geometry has them, queries (16, 32)):
    the last query sits on the tiny partition, so ma=1 probes fewer codes
    than r. m x sq_bits PQ, dim 32."""
    rng = np.random.default_rng(seed)
    parts, part_pad, dim = 8, 2048, 32
    code_size = m * sq_bits // 8
    sizes = rng.integers(1, part_pad + 1, size=parts).astype(np.int32)
    sizes[0] = part_pad
    sizes[EMPTY_PART] = 0
    sizes[TINY_PART] = TINY_SIZE
    codes = rng.integers(0, 256, size=(parts, part_pad, code_size), dtype=np.uint8)
    labels = rng.permutation(parts * part_pad).astype(np.int32).reshape(parts, part_pad)
    for p, s in enumerate(sizes):  # tail padding repeats the last code / label
        if s == 0:
            codes[p] = 0
            labels[p] = 0
        else:
            codes[p, s:] = codes[p, s - 1]
            labels[p, s:] = labels[p, s - 1]
    coarse = rng.normal(scale=3.0, size=(parts, dim)).astype(np.float32)
    pq = ProductQuantizer(
        centroids=jnp.asarray(
            rng.normal(size=(m, 1 << sq_bits, dim // m)).astype(np.float32)),
        sq_bits=sq_bits,
    )
    index = jivf.IVFIndex(
        pq=pq,
        coarse_centroids=jnp.asarray(coarse),
        codes=jnp.asarray(codes.reshape(parts, part_pad * code_size // 128, 128)),
        labels=jnp.asarray(labels),
        part_sizes=jnp.asarray(sizes),
        n=int(sizes.sum()),
        max_part_size=int(sizes.max()),
    ).with_planes()
    queries = coarse[rng.integers(0, parts, 16)] + rng.normal(size=(16, dim))
    queries[-1] = coarse[TINY_PART] + 0.01 * rng.normal(size=dim)
    return index, queries.astype(np.float32)


def as_np(x) -> np.ndarray:
    """numpy view of a jax array or a tensor."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
