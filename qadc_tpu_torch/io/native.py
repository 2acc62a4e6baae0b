"""ctypes binding of the C++ vecs library (counterpart of qadc_tpu/io/native.py).

The source is the repository's `native/qadc_io.cpp`, bound as it is. `g++`
builds it at first use into `build/native/` at the root of the checkout,
under a lock (one build per process; a temporary file and an atomic rename
keep concurrent processes from loading a partial library). If the source or
the compiler is missing, or the build fails, `get_lib()` returns None and
the callers in `io/vecs.py` read and write through numpy.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "native" / "qadc_io.cpp"
BUILD_DIR = ROOT / "build" / "native"

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> Path | None:
    """Compile the library unless an up-to-date one exists; None on failure."""
    if not SOURCE.exists():
        return None
    so = BUILD_DIR / "libqadc_io.so"
    if so.exists() and so.stat().st_mtime >= SOURCE.stat().st_mtime:
        return so
    tmp = so.with_name(f"{so.name}.tmp.{os.getpid()}")
    try:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(["g++", "-O3", "-std=c++17", "-fPIC", "-shared", "-o", str(tmp),
                        str(SOURCE), "-lpthread"],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return None
    return so


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    i64, p = ctypes.c_int64, ctypes.c_void_p
    signatures = {
        "qadc_vecs_info": [ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(i64),
                           ctypes.POINTER(i64)],
        "qadc_vecs_read": [ctypes.c_char_p, ctypes.c_int, i64, i64, ctypes.c_int,
                           ctypes.c_int, p],
        "qadc_vecs_write": [ctypes.c_char_p, ctypes.c_int, i64, i64, p],
        "qadc_vecs_split": [ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, i64, i64],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def get_lib() -> ctypes.CDLL | None:
    """The loaded library, built on first call, or None (numpy path)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            so = _build()
            if so is not None:
                try:
                    _lib = _bind(ctypes.CDLL(str(so)))
                except OSError:
                    _lib = None
        return _lib
