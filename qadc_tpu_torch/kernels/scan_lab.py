"""The scan lab: instruments for designing the 4-bit int8 scans on Hopper
(counterpart of the JAX package's benchmark-only Pallas kernels).

The JAX package designed its TPU scans with four scratch scripts; each has
its counterpart here, over the tensor-core scan of csrc/scan_mma.cuh:

  benchmarks/ab_tq.py:lut_scan_tq       A/B of two formulations of one scan
      -> `ab_scans`: lut_scan.flat_scan (int8 one-hot x table mma.sync or
         wgmma, by batch) against flat_scan_window (wgmma over window-major
         columns) and the register engine flat_scan_window_regs (four
         lookups a byte permute), minima equal bit for bit
  benchmarks/ab_tq_ablate.py:scan       where the time outside the matrix unit goes
      -> `scan_lab` modes full / const_onehot / no_mma / no_min, of the
         mma.sync kernel and (wg_*) of the warpgroup kernel
  benchmarks/kernel_lab.py:run_variant  cost components of the scan
      -> `scan_lab` modes copy / expand_only / acc_only / min_only (and
         wg_skeleton / wg_expand_only / wg_acc_only / wg_min_only)
  benchmarks/diag_direct.py:main        is a selector product in a kernel exact
      -> `exactness_probe` (the int8 product against the plain version over
         adversarial tables) and `selector_sum` (the float32 0/1 selector sum)

Every mode is one launch of a kernel of csrc/scan_lab.cu; `check` holds each
instrument to what defines it, `times` times them with the timer it is given. No search path calls
anything here.

The query-minor flat scans (csrc/flat_scan_qm.cuh, flat_scan8_qm.cuh) have
their modes in QM_LAB_MODES (`query_minor_lab`, kernels of csrc/scan_lab_qm.cu),
`query_minor_by_chunk` runs either at a forced chunk of queries, and
`empty_kernel` gives the device time of a launch. `sass_loops` counts
the instructions of a compiled kernel's innermost loops by pipe (the register
engine's instructions a lookup), `sass_loop_ops` over the built library.

The slot-minor grouped scans (csrc/grouped_scan_sm.cu, grouped_scan8_sm.cu)
have theirs in GROUPED_LAB_MODES (`grouped_lab`, held to what defines them by
`check_grouped`).
"""

from __future__ import annotations

import re
import subprocess
from collections import Counter
from pathlib import Path
from typing import Callable

import torch

from qadc_tpu_torch.kernels import lut_scan
from qadc_tpu_torch.kernels.lut_scan import TRIM_SENTINEL, _check, _launch, _require_cuda, launches

# name -> (parts kept: expand 1 | mma 2 | min 4, m-tiles a warp, the variant
# of the JAX package's lab that asks the same question).
LAB_MODES = {
    "full": (7, 4, "ab_tq_ablate.py full"),
    "const_onehot": (6, 4, "ab_tq_ablate.py consthot"),
    "no_mma": (5, 4, "ab_tq_ablate.py nomm"),
    "no_min": (3, 4, "ab_tq_ablate.py nocmp: the other non-matrix part"),
    "copy": (0, 4, "kernel_lab.py copy"),
    "expand_only": (1, 4, "kernel_lab.py expand_only"),
    "acc_only": (2, 4, "kernel_lab.py acc_only"),
    "min_only": (4, 4, "kernel_lab.py min_only"),
    "full_mt2": (7, 2, "ab_tq_ablate.py full, 32 queries a warp"),
    "full_mt1": (7, 1, "ab_tq_ablate.py full, 16 queries a warp"),
    # m-tiles 0: the warpgroup kernel (csrc/scan_wgmma.cu) in place of the mma.sync one.
    "wg_full": (7, 0, "ab_tq_ablate.py full"),
    "wg_const_onehot": (6, 0, "ab_tq_ablate.py consthot"),
    "wg_no_mma": (5, 0, "ab_tq_ablate.py nomm"),
    "wg_no_min": (3, 0, "ab_tq_ablate.py nocmp: the other non-matrix part"),
    "wg_skeleton": (0, 0, "kernel_lab.py copy: barriers and stores, no codes read"),
    "wg_expand_only": (1, 0, "kernel_lab.py expand_only"),
    "wg_acc_only": (2, 0, "kernel_lab.py acc_only"),
    "wg_min_only": (4, 0, "kernel_lab.py min_only"),
}


def scan_lab(codes_rows, tables, n: int, mode: str = "full"):
    """The flat tensor-core scan at 16 sub-quantizers with parts removed.

    Args:
      codes_rows: (R, 128) uint8 row128 storage of 8-byte codes.
      tables: (Q, 16, 16) int8.
      n: real code count.
      mode: a key of LAB_MODES.

    Returns:
      (Q, R) int32. The full modes ("full", "full_mt2", "full_mt1",
      "wg_full") return flat_scan's minima and "copy" the trim sentinel for
      every row with a real code; the other modes return values that only
      keep the compiler from dropping what the mode keeps. On the CPU those
      five run their plain version and the others raise: they exist to be
      timed on the card.
    """
    bits, mt, _ = LAB_MODES[mode]
    dev = codes_rows.device
    _check(codes_rows, "codes_rows", torch.uint8, 2, dev)
    _check(tables, "tables", torch.int8, 3, dev)
    if codes_rows.shape[1] != 128 or tuple(tables.shape[1:]) != (16, 16):
        raise ValueError(f"need (R, 128) codes and (Q, 16, 16) tables, got "
                         f"{tuple(codes_rows.shape)} and {tuple(tables.shape)}")
    q, r_count = tables.shape[0], codes_rows.shape[0]
    n = max(0, min(int(n), r_count * 16))
    if dev.type == "cpu":
        return scan_lab_plain(codes_rows, tables, n, mode)
    _require_cuda(dev, codes_rows, tables)
    out = torch.empty((q, r_count), dtype=torch.int32, device=dev)
    if q and r_count:
        ptrs = (codes_rows.data_ptr(), tables.data_ptr(), out.data_ptr())
        if mt == 0:
            _launch("qadc_scan_lab_wgmma", dev, *ptrs, r_count, q, n, bits)
        else:
            _launch("qadc_scan_lab", dev, *ptrs, r_count, q, n, bits, mt)
        launches["scan_lab"] += 1
    return out


def scan_lab_plain(codes_rows, tables, n: int, mode: str = "full"):
    """Plain PyTorch version of the lab modes whose output is defined."""
    bits, mt, _ = LAB_MODES[mode]
    if bits == 7:
        return lut_scan.flat_scan_plain(codes_rows, tables, n)[0]
    if bits == 0 and mt:
        out = torch.full((tables.shape[0], codes_rows.shape[0]), TRIM_SENTINEL,
                         dtype=torch.int32, device=codes_rows.device)
        return out
    raise RuntimeError(f"lab mode {mode!r} has no plain version: it is timed on the card")


# name -> (scan: "f32" the float 4-bit scan at 16 sub-quantizers, "u8" the 8-bit
# scan at 8, "u8_lookup" the code-a-thread kernel of csrc/flat_scan8.cu; the
# kernels' mode number; what the mode keeps).
QM_LAB_MODES = {
    "f32_copy": ("f32", 1, "codes in, sentinel out"),
    "f32_no_min": ("f32", 2, "lookups and sums, no minimum"),
    "f32_const_code": ("f32", 3, "lookups at a fixed code byte"),
    "u8_copy": ("u8", 1, "codes in, sentinel out"),
    "u8_no_min": ("u8", 2, "lookups and sums, no minimum"),
    "u8_const_code": ("u8", 3, "lookups at a fixed code byte: no two lane groups collide"),
    "u8_lookup_const_code": ("u8_lookup", 3, "the replaced kernel with every lane on one "
                                             "entry: its time less its bank conflicts"),
}


def _check_query_minor_lab(codes_rows, tables, n: int, f32: bool) -> int:
    dev = codes_rows.device
    _check(codes_rows, "codes_rows", torch.uint8, 2, dev)
    _check(tables, "tables", torch.float32 if f32 else torch.bfloat16, 3, dev)
    want = (16, 16) if f32 else (8, 256)
    if codes_rows.shape[1] != 128 or tuple(tables.shape[1:]) != want:
        raise ValueError(f"need (R, 128) codes and (Q, {want[0]}, {want[1]}) tables, got "
                         f"{tuple(codes_rows.shape)} and {tuple(tables.shape)}")
    if not f32 and (codes_rows.shape[0] * 16) % lut_scan.FLAT8_BLOCK:
        raise ValueError(f"need a multiple of {lut_scan.FLAT8_BLOCK} codes")
    return max(0, min(int(n), codes_rows.shape[0] * 16))


def _launch_query_minor(codes_rows, tables, n: int, chunk: int, mode: int, lookup: bool = False):
    """One launch of a query-minor scan (mode 0: the production entry) or of a
    lab mode of it, at a chunk of queries, counted under scan_lab."""
    f32 = tables.dtype == torch.float32
    dev = codes_rows.device
    _require_cuda(dev, codes_rows, tables)
    q, r_count = tables.shape[0], codes_rows.shape[0]
    if f32:
        out = torch.empty((q, r_count), dtype=torch.float32, device=dev)
        args = (codes_rows.data_ptr(), tables.data_ptr(), out.data_ptr())
        if mode == 0:
            _launch("qadc_flat_scan_qm", dev, *args, None, r_count, q, n, 8, chunk)
        else:
            _launch("qadc_flat_scan_qm_lab", dev, *args, r_count, q, n, chunk, mode)
    else:
        out = (torch.empty((q, r_count), dtype=torch.float32, device=dev),
               torch.empty((q, r_count), dtype=torch.int32, device=dev))
        args = (codes_rows.data_ptr(), tables.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
                r_count // 16, q, n)
        if lookup:
            _launch("qadc_flat_scan8_const_code", dev, *args)
        elif mode == 0:
            _launch("qadc_flat_scan8_qm", dev, *args, 8, chunk)
        else:
            _launch("qadc_flat_scan8_qm_lab", dev, *args, chunk, mode)
    launches["scan_lab"] += 1
    return out


def query_minor_lab(codes_rows, tables, n: int, mode: str):
    """A query-minor flat scan (or, "u8_lookup_const_code", the kernel one
    replaced) with parts removed, at the chunk the wrapper would pick.

    Args:
      codes_rows: (R, 128) uint8 row128 storage of 8-byte codes (R * 16 a
        multiple of 256 for the 8-bit modes).
      tables: (Q, 16, 16) float32 for the f32 modes, (Q, 8, 256) bfloat16 for
        the others.
      n: real code count.
      mode: a key of QM_LAB_MODES.

    Returns:
      (Q, R) float32 for the f32 modes, ((Q, R) float32, (Q, R) int32) for the
      others. The copy modes return +inf (and -1) everywhere; the other modes
      return values that only keep the compiler from dropping what the mode
      keeps. On the CPU the copy modes run their plain version and the others
      raise: they exist to be timed on the card.
    """
    scan, number, _ = QM_LAB_MODES[mode]
    f32 = scan == "f32"
    n = _check_query_minor_lab(codes_rows, tables, n, f32)
    q, r_count = tables.shape[0], codes_rows.shape[0]
    if codes_rows.device.type == "cpu":
        if number != 1:
            raise RuntimeError(f"lab mode {mode!r} has no plain version: it is timed on the card")
        mins = torch.full((q, r_count), torch.inf, dtype=torch.float32)
        return mins if f32 else (mins, torch.full((q, r_count), -1, dtype=torch.int32))
    chunk = lut_scan.flat_scan_chunk(q, 16) if f32 else lut_scan.flat_scan8_chunk(q, 8)
    return _launch_query_minor(codes_rows, tables, n, chunk, number, lookup=scan == "u8_lookup")


def query_minor_by_chunk(codes_rows, tables, n: int, chunk: int):
    """The production query-minor scan at a forced chunk of queries (float
    tables (Q, 16, 16): 32, 64 or 128, a lane holding 1, 2 or 4 queries; bf16
    tables (Q, 8, 256): 8, 16 or 32, a warp holding 8, 4 or 2 codes). The
    result is flat_scan's minima / flat_scan8's (minima, indices) at every
    chunk. On the CPU the plain version runs (it has no chunk to force)."""
    f32 = tables.dtype == torch.float32
    n = _check_query_minor_lab(codes_rows, tables, n, f32)
    if codes_rows.device.type == "cpu":
        if f32:
            return lut_scan.flat_scan_plain(codes_rows, tables, n)[0]
        return lut_scan.flat_scan8_plain(codes_rows, tables, n)
    if chunk not in ((32, 64, 128) if f32 else (8, 16, 32)):
        raise ValueError(f"no query-minor kernel at a chunk of {chunk} queries")
    return _launch_query_minor(codes_rows, tables, n, chunk, 0)


def empty_kernel(device) -> None:
    """Launch one block of one thread that does nothing: its device time is
    what a launch costs, the floor under the kernels of a few microseconds."""
    device = torch.device(device)
    _require_cuda(device)
    _launch("qadc_empty_kernel", device)
    launches["empty_kernel"] += 1


def check_query_minor(codes_rows, tables_f32, tables_bf16, n: int) -> None:
    """One launch of every instrument of the query-minor scans, each held to
    what defines it: every chunk equal to the replaced kernel bit for bit,
    the copy modes to their sentinels; the other modes only launch."""
    want = lut_scan.flat_scan_f32_lookup(codes_rows, tables_f32, n)[0]
    for chunk in (32, 64, 128):
        if not torch.equal(query_minor_by_chunk(codes_rows, tables_f32, n, chunk), want):
            raise AssertionError(f"float flat_scan at chunk {chunk} differs from the lookup kernel")
    want = lut_scan.flat_scan8_lookup(codes_rows, tables_bf16, n)
    for chunk in (8, 16, 32):
        got = query_minor_by_chunk(codes_rows, tables_bf16, n, chunk)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"flat_scan8 at chunk {chunk} differs from the lookup kernel")
    for mode, (scan, number, _) in QM_LAB_MODES.items():
        got = query_minor_lab(codes_rows, tables_f32 if scan == "f32" else tables_bf16, n, mode)
        if number == 1:
            mins = got if scan == "f32" else got[0]
            if not bool(torch.isinf(mins).all()) or (scan != "f32" and not bool((got[1] == -1).all())):
                raise AssertionError(f"lab mode {mode} did not write the sentinel")
    empty_kernel(codes_rows.device)


def selector_sum(x, cb: int):
    """Sum a (rows, 128) float32 block against the 0/1 selector that compacts
    a 128-lane row to its 128 / cb code sums (sel[k, c] = (k // cb == c)), as
    float32 multiply-adds in a kernel. Returns (rows, 128 / cb) float32."""
    dev = x.device
    _check(x, "x", torch.float32, 2, dev)
    if x.shape[1] != 128 or cb not in (8, 16):
        raise ValueError(f"need (rows, 128) values and cb in (8, 16), got {tuple(x.shape)}, {cb}")
    if dev.type == "cpu":
        return selector_sum_plain(x, cb)
    _require_cuda(dev, x)
    out = torch.empty((x.shape[0], 128 // cb), dtype=torch.float32, device=dev)
    if x.shape[0]:
        _launch("qadc_selector_sum", dev, x.data_ptr(), out.data_ptr(), x.shape[0], cb)
        launches["selector_sum"] += 1
    return out


def selector_sum_plain(x, cb: int):
    """Plain PyTorch version of selector_sum: the matmul with the selector."""
    sel = (torch.arange(128, device=x.device)[:, None] // cb
           == torch.arange(128 // cb, device=x.device)[None, :]).to(x.dtype)
    return x @ sel


def adversarial_tables(m: int, q: int, seed: int, device) -> dict[str, torch.Tensor]:
    """(q, m, 16) int8 table sets that would show a product that is not exact:
    every entry 127 (the largest sum, 127 * m), every entry 0, one entry 127
    a table and zeros elsewhere, and random entries in [0, 127]."""
    gen = torch.Generator().manual_seed(seed)
    hot = torch.zeros((q, m, 16), dtype=torch.int8)
    at = torch.randint(0, 16, (q, m, 1), generator=gen)
    hot.scatter_(2, at, 127)
    sets = {
        "all_127": torch.full((q, m, 16), 127, dtype=torch.int8),
        "all_0": torch.zeros((q, m, 16), dtype=torch.int8),
        "one_hot_rows": hot,
        "random": torch.randint(0, 128, (q, m, 16), generator=gen).to(torch.int8),
    }
    return {name: t.to(device) for name, t in sets.items()}


def exactness_probe(codes_rows, n: int, m: int, q: int = 128, seed: int = 0,
                    scan: Callable = lut_scan.flat_scan,
                    reference: Callable = lut_scan.flat_scan_plain) -> dict[str, int]:
    """Entries of `scan`'s minima that differ from `reference`'s, for each
    set of adversarial_tables (0 everywhere means the product is exact)."""
    out = {}
    for name, tables in adversarial_tables(m, q, seed, codes_rows.device).items():
        got, want = scan(codes_rows, tables, n)[0], reference(codes_rows, tables, n)[0]
        out[name] = int((got != want).sum())
    return out


def ab_scans(codes_rows, tables, n: int) -> dict[str, Callable]:
    """The engines that compute one flat int8 scan (window = cpr, so a window
    is a storage row), each as a call returning (Q, R) minima: flat_scan and
    flat_scan_window on the tensor cores (the window scan in its
    window-major column order), and the register engine of
    flat_scan_window_regs."""
    cb = tables.shape[1] // 2
    block = 64 * (128 // cb)      # 64 storage rows a code block: windows are rows
    if (codes_rows.shape[0] * (128 // cb)) % block:
        raise ValueError("the A/B needs a multiple of 64 storage rows")
    window = 128 // cb
    return {
        "flat_scan": lambda: lut_scan.flat_scan(codes_rows, tables, n)[0],
        "flat_scan_window": lambda: lut_scan.flat_scan_window(
            codes_rows, tables, n, block, window, transpose_out=True)[0],
        "flat_scan_window_regs": lambda: lut_scan.flat_scan_window_regs(
            codes_rows, tables, n, block, window).T,
    }


# The kernel each A/B engine launches (a profiler's name filter).
# flat_scan launches flat_scan_wgmma_kernel or flat_scan_mma_kernel by its
# batch, flat_scan_window flat_scan_window_wgmma_kernel or _mma_kernel.
AB_KERNELS = {"flat_scan": "mma_kernel", "flat_scan_window": "mma_kernel",
              "flat_scan_window_regs": "flat_scan_window_perm4_kernel"}


def check(codes_rows, tables, n: int) -> dict:
    """One launch of every instrument on 8-byte codes and (Q, 16, 16) int8
    tables, each held to what defines it. Raises if an engine of the A/B
    disagrees with flat_scan_plain, a full mode with the scan, or copy with
    the sentinel.

    Returns {"exactness": {"m16": {set: mismatches}, "m32": {...}},
    "selector_sum_max_rel_err": x} (the caller decides what passes).
    """
    want = lut_scan.flat_scan_plain(codes_rows, tables, n)[0]
    for name, fn in ab_scans(codes_rows, tables, n).items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"A/B: {name} differs from flat_scan_plain")
    live = torch.arange(codes_rows.shape[0], device=codes_rows.device) * 16 < n
    for mode, (bits, mt, _) in LAB_MODES.items():
        got = scan_lab(codes_rows, tables, n, mode)
        if bits == 7 and not torch.equal(got, want):
            raise AssertionError(f"lab mode {mode} differs from the scan")
        if bits == 0 and mt and not bool((got[:, live] == TRIM_SENTINEL).all()):
            raise AssertionError("lab mode copy did not write the sentinel")
    q = tables.shape[0]
    exact = {"m16": exactness_probe(codes_rows, n, 16, q)}
    # The same bytes read as 16-byte codes: half the codes a row, half of n.
    exact["m32"] = exactness_probe(codes_rows, n // 2, 32, q)
    gen = torch.Generator().manual_seed(11)
    x = (torch.rand((512, 128), generator=gen) * 500).to(codes_rows.device)
    got = selector_sum(x, 8).double()
    ref = selector_sum_plain(x.double().cpu(), 8).to(got.device)
    rel = float(((got - ref).abs() / ref.abs().clamp(min=1e-9)).max())
    return {"exactness": exact, "selector_sum_max_rel_err": rel}


def times(codes_rows, tables, n: int, timer: Callable[[Callable, str], float]) -> dict:
    """Device milliseconds of the A/B's engines and of every lab mode:
    timer(fn, kernel_name) gives the named kernel's time in one call of fn.
    Returns {"ab_ms": {engine: ms}, "mode_ms": {mode: ms}}."""
    ab_ms = {name: timer(fn, AB_KERNELS[name])
             for name, fn in ab_scans(codes_rows, tables, n).items()}
    mode_ms = {mode: timer(lambda mode=mode: scan_lab(codes_rows, tables, n, mode), "mma_kernel")
               for mode in LAB_MODES}
    return {"ab_ms": ab_ms, "mode_ms": mode_ms}


def run(codes_rows, tables, n: int, timer: Callable[[Callable, str], float]) -> dict:
    """The whole lab: `check`, then `times`; their results in one dict."""
    return {**check(codes_rows, tables, n), **times(codes_rows, tables, n, timer)}


# name -> (scan: the slot-minor kernel of "f32" M1 with float tables at 16x4
# PQ, "u8" grouped_scan8 at 8x8; the kernels' mode number, None for the
# production kernel over every slot dead; what the mode keeps). f32_quad is
# the M1 kernel with its tables as [entry][4 slots] in place of two slot
# pairs: one 16-byte load a lookup, and rows whose nibbles differ by 8 meet
# on a bank; its output is the scan's.
GROUPED_LAB_MODES = {
    **{f"{scan}_{name}": (scan, number, keeps)
       for scan in ("f32", "u8")
       for name, number, keeps in (
           ("copy", 1, "codes in, sentinel out"),
           ("no_min", 2, "lookups and sums, no minimum"),
           ("const_code", 3, "lookups at a fixed code byte: every lane on one entry"),
           ("empty", None, "the grid with every slot dead: walk, checks and exits alone"),
       )},
    "f32_quad": ("f32", 4, "tables as [entry][4 slots]: 16-byte loads that meet on banks"),
}
# The kernel each scan's lab modes launch (a profiler's name filter).
GROUPED_LAB_KERNELS = {"f32": "grouped_scan_sm_kernel", "u8": "grouped_scan8_sm_kernel"}


def grouped_lab(codes, tables, group_part, slot_pair, group_sizes, mode: str):
    """A slot-minor grouped scan with parts removed, or ("*_empty") with
    every slot of slot_pair dead.

    Args: grouped_scan's (float32 (QA, 16, 16) tables) for the f32 modes,
      grouped_scan8's ((QA, 8, 256) bfloat16 tables) for the u8 modes.

    Returns:
      (QA, rpp) float32 for the f32 modes, ((QA, C) float32, (QA, C) int32)
      for the u8 ones. The copy modes give +inf (and -1) for every live
      pair, quad the scan's minima; the empty modes write nothing; the other
      modes return values that only keep the compiler from dropping what the
      mode keeps. On the CPU copy and quad run their plain versions and the
      others raise: they exist to be timed on the card.
    """
    scan, number, _ = GROUPED_LAB_MODES[mode]
    f32 = scan == "f32"
    lut_scan._check_groups(codes, group_part, slot_pair, group_sizes)
    dev = codes.device
    _check(tables, "tables", torch.float32 if f32 else torch.bfloat16, 3, dev)
    want = (16, 16) if f32 else (8, 256)
    if tuple(tables.shape[1:]) != want:
        raise ValueError(f"need (QA, {want[0]}, {want[1]}) tables, got {tuple(tables.shape)}")
    qa, rpp = tables.shape[0], codes.shape[1]
    c = rpp if f32 else rpp * lut_scan.scan8_windows(8)[1]
    if dev.type == "cpu":
        if number == 4:
            return lut_scan.grouped_scan_plain(codes, tables, group_part, slot_pair, group_sizes)
        if number != 1:
            raise RuntimeError(f"lab mode {mode!r} has no plain version: it is timed on the card")
        mins = torch.full((qa, c), torch.inf, dtype=torch.float32)
        return mins if f32 else (mins, torch.full((qa, c), -1, dtype=torch.int32))
    _require_cuda(dev, codes, tables)
    gcap, g = slot_pair.shape
    if number is None:
        slot_pair = torch.full_like(slot_pair, -1)
    outs = (torch.empty((qa, c), dtype=torch.float32, device=dev),) + (
        () if f32 else (torch.empty((qa, c), dtype=torch.int32, device=dev),))
    ptrs = [t.data_ptr() for t in (codes, tables, group_part, slot_pair, group_sizes, *outs)]
    entry = "qadc_grouped_scan_sm" if f32 else "qadc_grouped_scan8_sm"
    if number is None:
        _launch(entry, dev, *ptrs, gcap, g, rpp, 8)  # cb or m
    else:
        _launch(entry + "_lab", dev, *ptrs, gcap, g, rpp, number)
    launches["scan_lab"] += 1
    return outs[0] if f32 else outs


def check_grouped(f32_args, u8_args) -> None:
    """One launch of every grouped lab mode, each held to what defines it:
    the copy modes to their sentinels over the live pairs, quad to the
    scan's minima; the other modes only launch. f32_args / u8_args:
    grouped_scan's / grouped_scan8's arguments (16x4 float tables, 8x8 bf16
    tables)."""
    for mode, (scan, number, _) in GROUPED_LAB_MODES.items():
        args = f32_args if scan == "f32" else u8_args
        got = grouped_lab(*args, mode)
        if number == 4 and not torch.equal(got, lut_scan.grouped_scan(*args)):
            raise AssertionError("grouped lab mode f32_quad differs from the scan")
        if number == 1:
            live = args[3][args[3] >= 0].long()
            mins = got if scan == "f32" else got[0]
            if not bool(torch.isinf(mins[live]).all()) or (
                    scan == "u8" and not bool((got[1][live] == -1).all())):
                raise AssertionError(f"grouped lab mode {mode} did not write the sentinel")


# SASS opcodes that run on the FMA pipe (integer multiply-adds included);
# the uniform datapath's (U*), memory, barrier and control opcodes are
# counted apart; every other opcode is counted on the integer ALU pipe.
SASS_FMA = ("IMAD", "IMUL", "FFMA", "FADD", "FMUL", "HFMA2", "HADD2", "HMUL2")
SASS_OTHER = ("LD", "ST", "BRA", "BAR", "EXIT", "NOP", "RET", "CALL", "BSSY", "BSYNC", "WARPSYNC",
              "DEPBAR", "S2R", "CS2R", "MEMBAR", "ERRBAR", "CCTL", "YIELD", "ATOM", "RED")


def sass_loops(sass: str, kernel: str, lookups_per_cb: int) -> dict:
    """Instruction counts of the innermost loops that hold byte permutes
    (PRMT), in every compiled instance of `kernel` in cuobjdump -sass text.

    A loop is a branch back to an earlier address; it is `nested` where
    another loop encloses it. Its ops are counted along one pass through its
    body: the path, over the body's forward branches, that runs the most
    PRMTs and, among those, the fewest integer-pipe instructions. Code that
    a forward branch can skip without losing a PRMT (the register engine's
    funnel shifts for a rank that straddles two plane words, the padding
    masks of a block's last codes) is left out: that is the path of a block
    of real codes whose ranks start on a plane word.

    A pass of the kernel's source loop looks up lookups_per_cb * CB entries
    with one PRMT each (the register engine: 8 a sub-quantizer word of 8
    slots); the passes that the compiler unrolled into one loop are the
    path's PRMTs over a pass's, rounded. CB is the first template argument.

    Returns {CB: [{"start": address, "nested": bool, "ops": {opcode: n},
    "alu": n, "fma": n, "other": n, "prmt": n, "lookups": n,
    "alu_per_lookup": x, "fma_per_lookup": x}, ...]}, in address order.
    """
    out = {}
    for block in re.split(r"\n\s*Function : ", sass)[1:]:
        name = block.split("\n", 1)[0].strip()
        if kernel not in name:
            continue
        instrs = []  # (address, opcode, predicated, branch target or None)
        for line in block.split("\n"):
            ins = re.match(
                r"\s*/\*([0-9a-f]+)\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)(.*?);", line)
            if ins:
                target = re.match(r"\s*(?:!?U?P[T0-9]+,\s*)?0x([0-9a-f]+)", ins.group(4))
                instrs.append((int(ins.group(1), 16), ins.group(3).split(".")[0],
                               ins.group(2) is not None,
                               int(target.group(1), 16) if target else None))
        loops = [(t, a) for a, op, _, t in instrs if op == "BRA" and t is not None and t <= a]
        cb = int(re.search(r"kernelILi(\d+)E", name).group(1))
        per_pass = lookups_per_cb * cb
        found = []
        for t, a in loops:
            if any(t <= t2 and a2 <= a and (t2, a2) != (t, a) for t2, a2 in loops):
                continue  # encloses another loop
            ops = _hot_path([ins for ins in instrs if t <= ins[0] <= a], a)
            if not ops["PRMT"]:
                continue
            fma = sum(c for o, c in ops.items() if o.startswith(SASS_FMA))
            other = sum(c for o, c in ops.items()
                        if o.startswith("U") or o.startswith(SASS_OTHER))
            alu = sum(ops.values()) - fma - other
            lookups = max(1, round(ops["PRMT"] / per_pass)) * per_pass
            found.append({"start": t, "nested": any(t2 <= t and a <= a2 and (t2, a2) != (t, a)
                                                    for t2, a2 in loops),
                          "ops": dict(ops.most_common()), "alu": alu, "fma": fma,
                          "other": other, "prmt": ops["PRMT"], "lookups": lookups,
                          "alu_per_lookup": alu / lookups, "fma_per_lookup": fma / lookups})
        out[cb] = found
    return out


def _hot_path(body: list, end: int) -> Counter:
    """Opcode counts along the path from a loop body's first instruction to
    its back branch at address `end` with the most PRMTs and, among those,
    the fewest integer-pipe instructions. body: (address, opcode,
    predicated, target) in address order; its forward branches only."""
    index = {ins[0]: i for i, ins in enumerate(body)}
    best = [None] * len(body)  # (-PRMTs, integer-pipe ops, Counter) on arrival
    best[0] = (0, 0, Counter())

    def arrive(i, key):
        if best[i] is None or key[:2] < best[i][:2]:
            best[i] = key

    for i, (addr, op, predicated, target) in enumerate(body):
        if best[i] is None:
            continue
        prmt, alu, ops = best[i]
        pipe = op.startswith(SASS_FMA) or op.startswith("U") or op.startswith(SASS_OTHER)
        here = (prmt - (op == "PRMT"), alu + (not pipe), ops + Counter([op]))
        if addr == end:
            return here[2]
        jumps = op == "BRA" and target is not None
        if jumps and target in index and target > addr:
            arrive(index[target], here)
        if not (jumps or op == "EXIT") or predicated:
            arrive(i + 1, here)
    raise ValueError("no path reaches the loop's back branch")


def sass_loop_ops(library: Path, kernel: str, lookups_per_cb: int) -> dict:
    """sass_loops over the built kernel library (cuobjdump -sass)."""
    from qadc_tpu_torch.kernels.build import _nvcc

    tool = Path(_nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(library)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    return sass_loops(text, kernel, lookups_per_cb)
