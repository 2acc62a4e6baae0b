"""Load a flat or IVF checkpoint written by qadc_tpu.io.checkpoint.save_index
(counterpart of qadc_tpu/io/checkpoint.py; loading only).

The format is `arrays.npz` (one entry per field) plus `manifest.json`
(type and static metadata), so an index built by the JAX package loads
here unchanged.
"""

from __future__ import annotations

import json
import os

import numpy as np

from qadc_tpu_torch.convert import flat_index_from_arrays, ivf_index_from_arrays
from qadc_tpu_torch.index.flat import FlatIndex
from qadc_tpu_torch.index.ivf import IVFIndex

FORMAT_VERSION = 1
_LOADERS = {"flat": flat_index_from_arrays, "ivf": ivf_index_from_arrays}


def load_index(path: str, device="cpu") -> FlatIndex | IVFIndex:
    """Load the flat or IVF index saved in directory `path` onto `device`."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    if manifest["format"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {manifest['format']}")
    if manifest["type"] not in _LOADERS:
        raise ValueError(f"only flat and IVF checkpoints load in the port, "
                         f"got {manifest['type']}")
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        return _LOADERS[manifest["type"]](dict(arrays), manifest, device)
