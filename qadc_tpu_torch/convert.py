"""Carry an index across from the JAX package's arrays.

`ivf_index_from_arrays` and `flat_index_from_arrays` take exactly what
qadc_tpu.io.checkpoint.save_index writes for an IVF or a flat index: its
arrays (as numpy) and its manifest.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from qadc_tpu_torch.core.layout import codes_per_row
from qadc_tpu_torch.core.packing import SUPPORTED_BITS
from qadc_tpu_torch.index.flat import FlatIndex
from qadc_tpu_torch.index.ivf import IVFIndex
from qadc_tpu_torch.quantizers.opq import OPQQuantizer
from qadc_tpu_torch.quantizers.pq import ProductQuantizer


def _tensor(a, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(device=device, dtype=dtype)


def _quantizer(arrays: Mapping[str, np.ndarray], meta: Mapping, device):
    """(PQ or OPQ quantizer, codes per storage row) of checkpoint arrays;
    ValueError for a code geometry the port cannot search."""
    sq_bits = int(meta.get("pq", {}).get("sq_bits", 4))
    m, k, _ = np.shape(arrays["pq_centroids"])
    if sq_bits not in SUPPORTED_BITS or k != 1 << sq_bits or (m * sq_bits) % 8:
        raise ValueError(f"cannot search {m}x{sq_bits}-bit PQ codes with {k} centroids")
    cpr = codes_per_row(m * sq_bits // 8)
    centroids = _tensor(arrays["pq_centroids"], torch.float32, device)
    if "pq_rotation" in arrays:
        return OPQQuantizer(centroids=centroids, sq_bits=sq_bits,
                            rotation=_tensor(arrays["pq_rotation"], torch.float32, device)), cpr
    return ProductQuantizer(centroids=centroids, sq_bits=sq_bits), cpr


def ivf_index_from_arrays(arrays: Mapping[str, np.ndarray], meta: Mapping,
                          device) -> IVFIndex:
    """Build the port's IVFIndex on `device` from checkpoint arrays.

    Args:
      arrays: `codes` (P, rpp, 128) uint8, `labels` (P, part_pad) int32,
        `part_sizes` (P,) int32, `coarse_centroids` (P, dim) float32,
        `pq_centroids` (M, K, dsq) float32 and, for OPQ, `pq_rotation`.
      meta: the checkpoint manifest: `n`, `max_part_size` and
        `pq: {"sq_bits": ..}`.
      device: where the index lives (a CUDA device runs the kernels).

    Raises ValueError for a code geometry the port cannot search: sq_bits
    outside SUPPORTED_BITS, codebooks of other than 2**sq_bits centroids,
    codes that do not tile a 128-byte row, or labels that disagree with the
    codes' padded partition size.
    """
    pq, cpr = _quantizer(arrays, meta, device)
    codes = _tensor(arrays["codes"], torch.uint8, device)
    if codes.dim() != 3 or codes.shape[2] != 128:
        raise ValueError(f"codes must be (P, rpp, 128) row128 storage, got {tuple(codes.shape)}")
    if np.shape(arrays["labels"]) != (codes.shape[0], codes.shape[1] * cpr):
        raise ValueError(f"labels {np.shape(arrays['labels'])} do not match codes "
                         f"{tuple(codes.shape)} at {cpr} codes per row")
    return IVFIndex(
        pq=pq,
        coarse_centroids=_tensor(arrays["coarse_centroids"], torch.float32, device),
        codes=codes,
        labels=_tensor(arrays["labels"], torch.int32, device),
        part_sizes=_tensor(arrays["part_sizes"], torch.int32, device),
        n=int(meta["n"]),
        max_part_size=int(meta["max_part_size"]),
    )


def flat_index_from_arrays(arrays: Mapping[str, np.ndarray], meta: Mapping,
                           device) -> FlatIndex:
    """Build the port's FlatIndex on `device` from checkpoint arrays.

    Args:
      arrays: `codes` (N_pad/cpr, 128) uint8, `pq_centroids` (M, K, dsq)
        float32 and, for OPQ, `pq_rotation`. (The JAX package's byte-planes
        are derived storage and are not carried across.)
      meta: the checkpoint manifest: `n` and `pq: {"sq_bits": ..}`.
      device: where the index lives (a CUDA device runs the kernels).

    Raises ValueError for a code geometry the port cannot search (as
    ivf_index_from_arrays), or an `n` outside [0, N_pad].
    """
    pq, cpr = _quantizer(arrays, meta, device)
    codes = _tensor(arrays["codes"], torch.uint8, device)
    if codes.dim() != 2 or codes.shape[1] != 128:
        raise ValueError(f"codes must be (N_pad/cpr, 128) row128 storage, "
                         f"got {tuple(codes.shape)}")
    n = int(meta["n"])
    if not 0 <= n <= codes.shape[0] * cpr:
        raise ValueError(f"n={n} does not fit {codes.shape[0] * cpr} stored codes")
    return FlatIndex(pq=pq, codes=codes, n=n)
