"""The scan lab: instruments for designing the 4-bit int8 scans on Hopper
(counterpart of the JAX package's benchmark-only Pallas kernels).

The JAX package designed its TPU scans with four scratch scripts; each has
its counterpart here, over the tensor-core scan of csrc/scan_mma.cuh:

  benchmarks/ab_tq.py:lut_scan_tq       A/B of two formulations of one scan
      -> `ab_scans`: lut_scan.flat_scan (int8 one-hot x table mma) against
         flat_scan_lookup (shared-memory lookups), flat_scan_window and
         flat_scan_window_regs (tables in registers), minima equal bit for bit
  benchmarks/ab_tq_ablate.py:scan       where the time outside the matrix unit goes
      -> `scan_lab` modes full / const_onehot / no_mma / no_min, of the
         mma.sync kernel and (wg_*) of the warpgroup kernel
  benchmarks/kernel_lab.py:run_variant  cost components of the scan
      -> `scan_lab` modes copy / expand_only / acc_only / min_only (and
         wg_skeleton / wg_expand_only / wg_acc_only / wg_min_only)
  benchmarks/diag_direct.py:main        is a selector product in a kernel exact
      -> `exactness_probe` (the int8 product against the lookup kernel over
         adversarial tables) and `selector_sum` (the float32 0/1 selector sum)

Every mode is one launch of a kernel of csrc/scan_lab.cu; `check` holds each
instrument to what defines it, `times` times them with the timer it is given. No search path calls
anything here.
"""

from __future__ import annotations

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
    _require_cuda(dev)
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
                    reference: Callable = lut_scan.flat_scan_lookup) -> dict[str, int]:
    """Entries of `scan`'s minima that differ from `reference`'s, for each
    set of adversarial_tables (0 everywhere means the product is exact)."""
    out = {}
    for name, tables in adversarial_tables(m, q, seed, codes_rows.device).items():
        got, want = scan(codes_rows, tables, n)[0], reference(codes_rows, tables, n)[0]
        out[name] = int((got != want).sum())
    return out


def ab_scans(codes_rows, tables, n: int) -> dict[str, Callable]:
    """The four engines that compute one flat int8 scan (window = cpr, so a
    window is a storage row), each as a call returning (Q, R) minima."""
    cb = tables.shape[1] // 2
    block = 64 * (128 // cb)      # 64 storage rows a code block: windows are rows
    if (codes_rows.shape[0] * (128 // cb)) % block:
        raise ValueError("the A/B needs a multiple of 64 storage rows")
    window = 128 // cb
    return {
        "flat_scan": lambda: lut_scan.flat_scan(codes_rows, tables, n)[0],
        "flat_scan_lookup": lambda: lut_scan.flat_scan_lookup(codes_rows, tables, n)[0],
        "flat_scan_window": lambda: lut_scan.flat_scan_window(
            codes_rows, tables, n, block, window, transpose_out=True)[0],
        "flat_scan_window_regs": lambda: lut_scan.flat_scan_window_regs(
            codes_rows, tables, n, block, window).T,
    }


# The kernel each A/B engine launches (a profiler's name filter).
# flat_scan launches flat_scan_wgmma_kernel or flat_scan_mma_kernel, by its batch.
AB_KERNELS = {"flat_scan": "mma_kernel", "flat_scan_lookup": "flat_scan_kernel",
              "flat_scan_window": "flat_scan_window_kernel",
              "flat_scan_window_regs": "flat_scan_window_regs_kernel"}


def check(codes_rows, tables, n: int) -> dict:
    """One launch of every instrument on 8-byte codes and (Q, 16, 16) int8
    tables, each held to what defines it. Raises if an engine of the A/B
    disagrees with flat_scan_lookup, a full mode with the scan, or copy with
    the sentinel.

    Returns {"exactness": {"m16": {set: mismatches}, "m32": {...}},
    "selector_sum_max_rel_err": x} (the caller decides what passes).
    """
    engines = ab_scans(codes_rows, tables, n)
    want = engines["flat_scan_lookup"]()
    for name, fn in engines.items():
        if not torch.equal(fn(), want):
            raise AssertionError(f"A/B: {name} differs from flat_scan_lookup")
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
