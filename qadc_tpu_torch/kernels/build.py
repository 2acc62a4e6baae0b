"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

`nvcc` compiles each `qadc_tpu_torch/csrc/*.cu` for sm_90a into an object
file, one compiler process per source, all started together, and links the
objects into one shared library with a plain C interface, under
`build/kernels/` at the root of the checkout. The library's name carries a
hash of the sources and flags, so an edited source builds anew and an
unchanged one is reused. Nothing is built when the package is imported: only
the first launch on a CUDA tensor (or an explicit `build()`) runs the
compiler.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argument types; every pointer and the stream are c_void_p.
SIGNATURES = {
    # codes, row_ids, pair_ids, tlo, thi, out, a_count, cb, stream
    "qadc_rows_adc": (_P, _P, _P, _P, _P, _P, _I, _I, _P),
    # codes, pair_part, tlo, thi, sizes, out, mins, qa, part_pad, cb, rounds, stream
    "qadc_direct_scan": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # codes, tables, out, rows_out (or null), r_count, q_count, n, cb, stream
    "qadc_flat_scan": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # codes, tables, out_min, out_idx, n_blocks, q_count, n, m, stream
    "qadc_flat_scan8": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    # codes, tables, out, rows_out (or null), n_pad, q_count, n, block_n, window,
    # cb, transpose_out, stream
    "qadc_flat_scan_window": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # codes, tables, out, n_pad, q_count, n, block_n, window, cb, stream
    "qadc_flat_scan_window_regs": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # codes, tables, out, rows_out (or null), n_pad, q_count, n, block_n, window,
    # cb, chunk, transpose_out, stream
    "qadc_flat_scan_window_qm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
    # codes, tables, out, rows_out (or null), n_pad, q_count, n, block_n, window,
    # cb, transpose_out, stream
    "qadc_flat_scan_window_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # codes, tables, out, rows_out (or null), r_count, q_count, n, cb, stream
    "qadc_flat_scan_mma": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "qadc_flat_scan_wgmma": (_P, _P, _P, _P, _I, _I, _I, _I, _P),  # as qadc_flat_scan_mma
    # codes, tables, group_part, slot_pair, group_sizes, out, tile_min (or null),
    # live_pairs, live, base, gcap, group_size, rpp, cb, tiles, stream
    "qadc_grouped_scan_mma": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # codes, tables, out, r_count, q_count, n, mode, mt, stream
    "qadc_scan_lab": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # codes, tables, out, r_count, q_count, n, mode, stream
    "qadc_scan_lab_wgmma": (_P, _P, _P, _I, _I, _I, _I, _P),
    # x, out, rows, cb, stream
    "qadc_selector_sum": (_P, _P, _I, _I, _P),
    # codes, tables, out, rows_out (or null), r_count, q_count, n, cb, chunk, stream
    "qadc_flat_scan_qm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # codes, tables, out_min, out_idx, n_blocks, q_count, n, m, chunk, stream
    "qadc_flat_scan8_qm": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # codes, tables, out, r_count, q_count, n, chunk, mode, stream
    "qadc_flat_scan_qm_lab": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    # codes, tables, out_min, out_idx, n_blocks, q_count, n, chunk, mode, stream
    "qadc_flat_scan8_qm_lab": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # codes, tables, out_min, out_idx, n_blocks, q_count, n, stream
    "qadc_flat_scan8_const_code": (_P, _P, _P, _P, _I, _I, _I, _P),
    "qadc_empty_kernel": (_P,),  # stream
    # codes, tables, group_part, slot_pair, group_sizes, out,
    # gcap, group_size, rpp, cb, stream
    "qadc_grouped_scan_sm": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # codes, tables, group_part, slot_pair, group_sizes, out_min, out_idx,
    # gcap, group_size, rpp, m, stream
    "qadc_grouped_scan8_sm": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # the lab entries: as above with the mode in place of cb / m
    "qadc_grouped_scan_sm_lab": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "qadc_grouped_scan8_sm_lab": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libqadc_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the kernels unless an up-to-date library exists.

    Returns (library path, compiler output; empty when nothing was built).
    """
    lib = _library_path()
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{lib.stem}.{os.getpid()}"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((obj, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(out)
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}) on {obj.name}:\n{out}")
    objs = [str(obj) for obj, _ in jobs]
    try:
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = lib.with_name(f"{tag}.tmp")
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True, check=False)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build never loads a partial file
    finally:
        for obj in objs:
            Path(obj).unlink(missing_ok=True)
    return lib, "".join(log)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


_lock = threading.Lock()
_library: ctypes.CDLL | None = None


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call. Threads that reach
    it together build once: the others wait on the lock."""
    global _library
    if _library is not None:  # set once, never reset: no lock on a launch
        return _library
    with _lock:
        if _library is None:
            _library = _load(build()[0])
        return _library
