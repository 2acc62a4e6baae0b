"""Save and load flat and IVF checkpoints, whole or sharded by partition
(counterpart of qadc_tpu/io/checkpoint.py).

The format is the JAX package's, so an index saved by either package loads
in the other unchanged:
  - whole: `arrays.npz` (one entry per field) plus `manifest.json` (type
    and static metadata);
  - sharded (IVF only): `manifest.json` of type "ivf_sharded" with
    `num_shards` and `parts_per_shard`, `shared.npz` (the coarse centroids
    and the quantizer, replicated) and one `shard_{s:05d}.npz` a shard
    holding its `codes`, `labels` and `part_sizes`. The partition count is
    padded to a shard multiple with empty partitions whose coarse centroids
    sit at 1e30, so no query is assigned to them.
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

# Coarse centroid of a padded (empty) partition: far from every query.
FAR_CENTROID = 1e30


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
    manifest = _manifest(path)
    if manifest["format"] != FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {manifest['format']}")
    if manifest["type"] not in _LOADERS:
        raise ValueError(f"only flat and IVF checkpoints load in the port, "
                         f"got {manifest['type']}")
    with np.load(os.path.join(path, "arrays.npz")) as arrays:
        return _LOADERS[manifest["type"]](dict(arrays), manifest, device)


def pad_partitions(arrays: dict, p_pad: int) -> dict:
    """The IVF arrays (`codes`, `labels`, `part_sizes`, and
    `coarse_centroids` where present) padded with empty partitions to
    p_pad: zero codes, labels and sizes, far coarse centroids."""
    out = dict(arrays)
    extra = p_pad - arrays["part_sizes"].shape[0]
    if extra > 0:
        for key in ("codes", "labels", "part_sizes"):
            a = arrays[key]
            out[key] = np.concatenate([a, np.zeros((extra, *a.shape[1:]), a.dtype)])
        if "coarse_centroids" in arrays:
            c = arrays["coarse_centroids"]
            out["coarse_centroids"] = np.concatenate(
                [c, np.full((extra, c.shape[1]), FAR_CENTROID, np.float32)])
    return out


def save_index_sharded(path: str, index: IVFIndex, num_shards: int) -> None:
    """Save an IVFIndex as `num_shards` files of contiguous partitions plus
    the shared coarse centroids and quantizer, so a process can load only
    its own partitions (load_index_shard, load_index_rows). The partition
    count is padded to a shard multiple with empty partitions."""
    if not isinstance(index, IVFIndex):
        raise TypeError("sharded checkpoints are for IVFIndex")
    arrays, whole = index_to_arrays(index)
    p = index.part_count
    p_pad = -(-p // num_shards) * num_shards
    arrays = pad_partitions(arrays, p_pad)
    per = p_pad // num_shards
    manifest = {
        "format": FORMAT_VERSION,
        "type": "ivf_sharded",
        "n": whole["n"],
        "max_part_size": whole["max_part_size"],
        "num_shards": num_shards,
        "parts_per_shard": per,
        "pq": whole["pq"],
    }
    os.makedirs(path, exist_ok=True)
    shared = {k: v for k, v in arrays.items() if k == "coarse_centroids" or k.startswith("pq_")}
    np.savez(os.path.join(path, "shared.npz"), **shared)
    for s in range(num_shards):
        sl = slice(s * per, (s + 1) * per)
        np.savez(os.path.join(path, f"shard_{s:05d}.npz"), codes=arrays["codes"][sl],
                 labels=arrays["labels"][sl], part_sizes=arrays["part_sizes"][sl])
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def _manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def sharded_manifest(path: str) -> dict:
    """The manifest of a sharded checkpoint; ValueError for another kind."""
    manifest = _manifest(path)
    if manifest["type"] != "ivf_sharded":
        raise ValueError(f"not a sharded checkpoint: {manifest['type']}")
    return manifest


def _rows_index(path: str, manifest: dict, rows: dict, device) -> IVFIndex:
    """An IVFIndex of the given partition rows with the checkpoint's shared
    (global) coarse centroids and quantizer."""
    with np.load(os.path.join(path, "shared.npz")) as shared:
        return ivf_index_from_arrays({**dict(shared), **rows}, manifest, device)


def load_index_shard(path: str, shard_id: int, device=DEFAULT_DEVICE):
    """Load one shard file of a sharded IVF checkpoint onto `device`.

    Returns (IVFIndex holding only this shard's partitions, manifest). The
    coarse centroids stay GLOBAL (replicated): partition i of the slice is
    global partition shard_id * parts_per_shard + i.
    """
    manifest = sharded_manifest(path)
    with np.load(os.path.join(path, f"shard_{shard_id:05d}.npz")) as arr:
        rows = dict(arr)
    return _rows_index(path, manifest, rows, device), manifest


def load_index_rows(path: str, lo: int, hi: int, device=DEFAULT_DEVICE):
    """Load global partition rows [lo, hi) of a sharded IVF checkpoint onto
    `device`: the reshard-on-load primitive.

    The range may span several shard files (a checkpoint written for k
    processes served by p != k) and may run past the stored partition count,
    into a tail of zero-filled empty partitions. Returns (IVFIndex slice,
    manifest); the coarse centroids stay GLOBAL and are not padded here:
    callers pad them to their own global partition count.
    """
    manifest = sharded_manifest(path)
    if not 0 <= lo <= hi:
        raise ValueError(f"bad row range [{lo}, {hi})")
    per = int(manifest["parts_per_shard"])
    stored = per * int(manifest["num_shards"])
    keys = ("codes", "labels", "part_sizes")
    parts = {k: [] for k in keys}
    row = lo
    while row < min(hi, stored):
        s = row // per
        s_lo, s_hi = row - s * per, min(hi - s * per, per)
        with np.load(os.path.join(path, f"shard_{s:05d}.npz")) as arr:
            for k in keys:
                parts[k].append(arr[k][s_lo:s_hi])
        row = s * per + s_hi
    if not parts["codes"]:  # the range lies wholly in the zero-filled tail
        with np.load(os.path.join(path, "shard_00000.npz")) as arr:
            for k in keys:
                parts[k].append(arr[k][:0])
    rows = {k: np.concatenate(v) for k, v in parts.items()}
    rows = pad_partitions(rows, hi - lo)
    return _rows_index(path, manifest, rows, device), manifest
