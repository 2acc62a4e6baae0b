""".pq.data / .opq.data quantizer files (counterpart of
qadc_tpu/io/quantizer_files.py).

The reference's binary layout (README.md "Product quantizer file formats",
quantizers.cpp:27-33, 89-103):

    int32 dim; int32 m; int32 b;
    float32 codebooks[m * 2^b * (dim/m)];
    float32 rotation[dim*dim];            // OPQ only

The suffix chooses the type (parse_data_filename, quantizers.cpp:54-87).
Quantizers trained elsewhere load onto the port's ProductQuantizer /
OPQQuantizer; the port's save the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from qadc_tpu_torch.core.tensors import DEFAULT_DEVICE
from qadc_tpu_torch.quantizers.opq import OPQQuantizer
from qadc_tpu_torch.quantizers.pq import ProductQuantizer


def _parse_kind(path: str) -> str:
    if path.endswith(".opq.data"):
        return "opq"
    if path.endswith(".pq.data"):
        return "pq"
    raise ValueError(f"{path}: expected .pq.data or .opq.data suffix")


def load_quantizer_file(path: str, device=DEFAULT_DEVICE) -> ProductQuantizer:
    """The ProductQuantizer / OPQQuantizer of a .pq.data / .opq.data file,
    on `device` (the card unless the caller asks for the CPU)."""
    kind = _parse_kind(path)
    with open(path, "rb") as f:
        dim, m, b = (int(v) for v in np.fromfile(f, np.int32, 3))
        dsq = dim // m
        centroids = np.fromfile(f, np.float32, m * (1 << b) * dsq).reshape(m, 1 << b, dsq)
        rotation = np.fromfile(f, np.float32, dim * dim).reshape(dim, dim) if kind == "opq" else None
    c = torch.from_numpy(centroids).to(device)
    if rotation is not None:
        return OPQQuantizer(centroids=c, sq_bits=b,
                            rotation=torch.from_numpy(rotation).to(device)).validate()
    return ProductQuantizer(centroids=c, sq_bits=b).validate()


def save_quantizer_file(path: str, pq: ProductQuantizer) -> None:
    """Write a quantizer in the reference's binary layout."""
    kind = _parse_kind(path)
    is_opq = isinstance(pq, OPQQuantizer)
    if kind == "opq" and not is_opq:
        raise ValueError("OPQ filename but plain PQ quantizer")
    if kind == "pq" and is_opq:
        raise ValueError("PQ filename but OPQ quantizer (use .opq.data)")
    with open(path, "wb") as f:
        np.array([pq.dim, pq.sq_count, pq.sq_bits], np.int32).tofile(f)
        pq.centroids.detach().cpu().numpy().astype(np.float32, copy=False).tofile(f)
        if is_opq:
            pq.rotation.detach().cpu().numpy().astype(np.float32, copy=False).tofile(f)
