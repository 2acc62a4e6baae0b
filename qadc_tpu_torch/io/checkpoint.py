"""Save and load flat and IVF checkpoints (counterpart of
qadc_tpu/io/checkpoint.py, less its sharded functions).

The format is the JAX package's: `arrays.npz` (one entry per field) plus
`manifest.json` (type and static metadata), so an index built by either
package loads in the other unchanged.
"""

from __future__ import annotations

import json
import os

import numpy as np

from qadc_tpu_torch.convert import (FORMAT_VERSION, flat_index_from_arrays, index_to_arrays,
                                    ivf_index_from_arrays)
from qadc_tpu_torch.core.tensors import DEFAULT_DEVICE
from qadc_tpu_torch.index.flat import FlatIndex
from qadc_tpu_torch.index.ivf import IVFIndex

_LOADERS = {"flat": flat_index_from_arrays, "ivf": ivf_index_from_arrays}


def save_index(path: str, index: FlatIndex | IVFIndex) -> None:
    """Save a FlatIndex or IVFIndex to directory `path`."""
    arrays, manifest = index_to_arrays(index)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, "arrays.npz"), **arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def load_index(path: str, device=DEFAULT_DEVICE) -> FlatIndex | IVFIndex:
    """Load the flat or IVF index saved in directory `path` onto `device`
    (the card unless the caller asks for the CPU)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {manifest['format']}")
    if manifest["type"] not in _LOADERS:
        raise ValueError(f"only flat and IVF checkpoints load in the port, "
                         f"got {manifest['type']}")
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        return _LOADERS[manifest["type"]](dict(arrays), manifest, device)
