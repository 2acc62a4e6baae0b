"""TexMex .fvecs / .ivecs / .bvecs files (counterpart of qadc_tpu/io/vecs.py).

Each vector is an int32 dimension prefix followed by dim elements (float32,
int32 or uint8); the count follows from the file size. The extension picks
the element type. Arrays come back as numpy: callers move them to a device.

Every function reads or writes through the C++ library of `io/native.py`
(mmap and threads) when it built, and through numpy otherwise; `native=False`
takes the numpy path whatever the library. Both paths give the same bytes.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from qadc_tpu_torch.io.native import get_lib

_KINDS = {".fvecs": (0, np.float32), ".ivecs": (1, np.int32), ".bvecs": (2, np.uint8)}


def _kind_of(path: str):
    ext = os.path.splitext(path)[1]
    if ext not in _KINDS:
        raise ValueError(f"unsupported vecs extension: {path} (want .fvecs/.ivecs/.bvecs)")
    return _KINDS[ext]


def _lib(native: bool):
    return get_lib() if native else None


def vecs_info(path: str, native: bool = True) -> tuple[int, int]:
    """(dim, count) of a vecs file."""
    kind, dtype = _kind_of(path)
    lib = _lib(native)
    if lib is not None:
        dim, count = ctypes.c_int64(), ctypes.c_int64()
        rc = lib.qadc_vecs_info(path.encode(), kind, ctypes.byref(dim), ctypes.byref(count))
        if rc != 0:
            raise IOError(f"qadc_vecs_info({path}) failed: {rc}")
        return int(dim.value), int(count.value)
    size = os.path.getsize(path)
    if size == 0:
        return 0, 0
    with open(path, "rb") as f:
        d = int(np.fromfile(f, np.int32, 1)[0])
    stride = 4 + d * np.dtype(dtype).itemsize
    if size % stride != 0:
        raise IOError(f"{path}: size {size} not a multiple of vector stride {stride}")
    return d, size // stride


def load_vectors(path: str, offset: int = 0, count: int | None = None, to_float: bool = True,
                 native: bool = True) -> np.ndarray:
    """Vectors [offset, offset + count) as a (count, dim) numpy array.

    count=None reads to the end. to_float converts to float32 (the
    reference's load_vectors_convert); ground truth .ivecs passes False.
    """
    kind, dtype = _kind_of(path)
    dim, total = vecs_info(path, native)
    if count is None:
        count = total - offset
    if offset < 0 or count < 0 or offset + count > total:
        raise ValueError(f"range [{offset}, {offset + count}) outside file with {total} vectors")
    out = np.empty((count, dim), np.float32 if to_float else dtype)
    if count == 0:
        return out
    lib = _lib(native)
    if lib is not None:
        rc = lib.qadc_vecs_read(path.encode(), kind, offset, count, int(to_float), 0,
                                out.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IOError(f"qadc_vecs_read({path}) failed: {rc}")
        return out
    stride = 4 + dim * np.dtype(dtype).itemsize
    with open(path, "rb") as f:
        f.seek(offset * stride)
        raw = np.fromfile(f, np.uint8, count * stride).reshape(count, stride)
    out[:] = raw[:, 4:].copy().view(dtype).reshape(count, dim)
    return out


def save_vectors(path: str, vectors, native: bool = True) -> None:
    """Write a (N, dim) array as a vecs file, in the extension's type."""
    kind, dtype = _kind_of(path)
    vectors = np.ascontiguousarray(vectors, dtype=dtype)
    n, dim = vectors.shape
    lib = _lib(native)
    if lib is not None:
        rc = lib.qadc_vecs_write(path.encode(), kind, dim, n,
                                 vectors.ctypes.data_as(ctypes.c_void_p))
        if rc != 0:
            raise IOError(f"qadc_vecs_write({path}) failed: {rc}")
        return
    prefix = np.full((n, 1), dim, np.int32)
    rows = np.concatenate([prefix.view(np.uint8).reshape(n, 4),
                           vectors.view(np.uint8).reshape(n, -1)], axis=1)
    with open(path, "wb") as f:
        rows.tofile(f)


def split_vecs(in_path: str, out_path: str, chunk_id: int, chunk_size: int,
               native: bool = True) -> None:
    """Copy vectors [chunk_id * chunk_size, + chunk_size) of in_path to
    out_path (the last chunk is cut at the end of the file); the reference's
    split_vecs, by sendfile on the native path."""
    kind, _ = _kind_of(in_path)
    lib = _lib(native)
    if lib is not None:
        rc = lib.qadc_vecs_split(in_path.encode(), out_path.encode(), kind, chunk_id, chunk_size)
        if rc != 0:
            raise IOError(f"qadc_vecs_split({in_path}) failed: {rc}")
        return
    start = chunk_id * chunk_size
    total = vecs_info(in_path, native)[1]
    if start >= total:
        raise IOError(f"chunk {chunk_id} of {chunk_size} starts past {total} vectors")
    vecs = load_vectors(in_path, start, min(chunk_size, total - start), to_float=False,
                        native=native)
    save_vectors(out_path, vecs, native=native)
