"""The search path's kernels: Hopper CUDA kernels and their plain versions
(counterpart of qadc_tpu/kernels/lut_scan.py).

Four kernels, written by hand in CUDA C++ under `qadc_tpu_torch/csrc/`:

  grouped_scan  (M1)  <- lut_scan_grouped_tq / lut_scan_grouped_prefetch,
                         int8 tables (Quick ADC) or float32 (4-bit ADC)
  grouped_scan8 (5+6) <- lut_scan8_grouped_tq / lut_scan8_grouped_prefetch
  rows_adc      (M2)  <- rows_adc_accumulate (+ ivf.rows_adc's selector matmul)
  direct_scan   (M3)  <- rows_adc_grouped_prefetch (the b=1 direct path)

Each wrapper checks its arguments, then dispatches on the device of the
tensors it was given: on the CPU it runs the plain PyTorch version beside
it, on CUDA it launches the kernel on the current stream (no synchronise)
and adds one to its count in `launches`; on any other device it raises.
There is no fallback from CUDA to the plain version. The plain versions
take the same arguments and return the same results; tests hold them to
the JAX package, and the kernels to them.

Padded codes (at or past a partition's size) never enter a grouped scan's
window minimum: M1 and grouped_scan8 take each group's size in codes.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from qadc_tpu_torch.core.layout import code_view

# Finite sentinel for codes past a partition's size (lut_scan.py:MASK_BIG):
# it flows through the screen when fewer than wq real candidates exist, and
# the direct path turns it back into +inf / label -1 after the final cut.
MASK_BIG = 3.0e38
# Written by grouped_scan for rows it skips (lut_scan.py:_TRIM_SENTINEL_I32);
# the caller's size mask removes those windows.
TRIM_SENTINEL = 1 << 30
# Width of the tiles whose minima direct_scan emits for exact_tile_screen.
TILE = 32
# Sub-quantizer counts grouped_scan8 takes (8-bit codes of m bytes).
SCAN8_SQ_COUNTS = (4, 8, 16)

# Launches of each kernel since the last reset_launch_counts();
# grouped_scan_f32 is M1 with float tables.
launches = {"grouped_scan": 0, "grouped_scan_f32": 0, "grouped_scan8": 0,
            "rows_adc": 0, "direct_scan": 0}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def _check(t: torch.Tensor, what: str, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{what} must have {ndim} dims, got shape {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _table_code_bytes(lanes: int) -> int:
    """Code bytes of a (.., 16*cb) compact table; the kernels take cb 8 or 16."""
    cb = lanes // 16
    if lanes != 16 * cb or cb not in (8, 16):
        raise ValueError(f"tables must be 16*cb wide with cb in (8, 16), got {lanes}")
    return cb


def _launch(name: str, device: torch.device, *args) -> None:
    """Call a C launcher on the current stream of `device`; raise on error."""
    from qadc_tpu_torch.kernels.build import library

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(library(), name)(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def _require_cuda(device: torch.device, *vector_read: torch.Tensor) -> None:
    """Raise unless on CUDA with the vector-read tensors 16-byte aligned."""
    if device.type != "cuda":
        raise RuntimeError(f"no kernel for device {device}")
    for t in vector_read:
        if t.data_ptr() % 16:
            raise ValueError("kernel inputs read as 16-byte vectors must be 16-byte aligned")


# ---------------------------------------------------------------- M1


def _check_groups(codes, group_part, slot_pair, group_sizes) -> None:
    dev = codes.device
    _check(codes, "codes", torch.uint8, 3, dev)
    _check(group_part, "group_part", torch.int32, 1, dev)
    _check(slot_pair, "slot_pair", torch.int32, 2, dev)
    _check(group_sizes, "group_sizes", torch.int32, 1, dev)
    if codes.shape[2] != 128:
        raise ValueError(f"need (P, rpp, 128) row128 codes, got {tuple(codes.shape)}")
    gcap, g = slot_pair.shape
    if g < 1 or group_part.shape[0] != gcap or group_sizes.shape[0] != gcap:
        raise ValueError("group_part, slot_pair and group_sizes disagree on gcap")


def _live_slots(slot_pair, group_part, group_sizes):
    """(pair, partition, size) of every live slot, group-major."""
    gcap, g = slot_pair.shape
    flat = slot_pair.reshape(-1)
    live = flat >= 0
    grp = torch.arange(gcap, device=flat.device).repeat_interleave(g)[live]
    return flat[live].long(), group_part[grp].long(), group_sizes[grp]


def grouped_scan(codes, tables, group_part, slot_pair, group_sizes):
    """Grouped 4-bit ADC scan to per-(pair, row) window minima.

    Args:
      codes: (P, rpp, 128) uint8 row128 storage.
      tables: (QA, M, 16) per-pair tables, M in (16, 32): int8 with entries
        in [0, 127] (Quick ADC), or float32 (conventional ADC).
      group_part: (gcap,) int32 partition scanned by each group.
      slot_pair: (gcap, G) int32 pair id in each slot, -1 when empty.
      group_sizes: (gcap,) int32 real code count of each group's partition.

    Returns:
      (QA, rpp) int32 (int8 tables) or float32: out[p, i] = min over the
      real codes of row i of pair p's partition of sum_m tables[p, m,
      nibble_m], summed over b = 0..cb-1, low nibble then high (no 127
      saturation); TRIM_SENTINEL (int32) or +inf (float32) for rows at or
      past ceil(size / cpr).
    """
    dev = codes.device
    _check_groups(codes, group_part, slot_pair, group_sizes)
    f32 = getattr(tables, "dtype", None) == torch.float32
    _check(tables, "tables", torch.float32 if f32 else torch.int8, 3, dev)
    qa, m, k = tables.shape
    if k != 16 or m not in (16, 32):
        raise ValueError(f"need (QA, 16|32, 16) tables, got {tuple(tables.shape)}")
    if dev.type == "cpu":
        return grouped_scan_plain(codes, tables, group_part, slot_pair, group_sizes)
    _require_cuda(dev, codes, tables)
    gcap, g = slot_pair.shape
    rpp = codes.shape[1]
    out = torch.empty((qa, rpp), dtype=tables.dtype if f32 else torch.int32, device=dev)
    if qa and rpp and gcap:
        ptrs = [t.data_ptr() for t in (codes, tables, group_part, slot_pair, group_sizes, out)]
        _launch("qadc_grouped_scan", dev, *ptrs, gcap, g, rpp, m // 2, int(f32))
        launches["grouped_scan_f32" if f32 else "grouped_scan"] += 1
    return out


def grouped_scan_plain(codes, tables, group_part, slot_pair, group_sizes):
    """Plain PyTorch version of grouped_scan (same arguments and result)."""
    _, rpp, _ = codes.shape
    qa, m, _ = tables.shape
    cb = m // 2
    cpr = 128 // cb
    f32 = tables.dtype == torch.float32
    acc_dtype = torch.float32 if f32 else torch.int32
    dev = codes.device
    pair, part, size = _live_slots(slot_pair, group_part, group_sizes)
    rows = codes[part].reshape(-1, rpp * cpr, cb)                 # (S, codes, cb)
    tab = tables[pair].to(acc_dtype)                              # (S, M, 16)
    acc = torch.zeros(rows.shape[:2], dtype=acc_dtype, device=dev)
    for b in range(cb):  # rows_adc's order: b = 0..cb-1, low nibble then high
        byte = rows[..., b].long()
        acc = acc + torch.gather(tab[:, 2 * b], 1, byte & 15)
        acc = acc + torch.gather(tab[:, 2 * b + 1], 1, byte >> 4)
    col = torch.arange(rpp * cpr, device=dev)
    none = torch.inf if f32 else torch.iinfo(torch.int32).max
    acc = torch.where(col[None, :] < size[:, None], acc, none)   # padded codes
    mins = acc.reshape(-1, rpp, cpr).amin(dim=-1)
    trim = torch.inf if f32 else TRIM_SENTINEL
    row = torch.arange(rpp, device=dev)
    mins = torch.where(row[None, :] * cpr < size[:, None], mins, trim)
    out = torch.full((qa, rpp), trim, dtype=acc_dtype, device=dev)
    out[pair] = mins
    return out


# ---------------------------------------------------------------- 5 + 6


def scan8_windows(m: int) -> tuple[int, int]:
    """(window, cs) of grouped_scan8 at m code bytes: a window is storage
    row r, in-row positions c0 + k*cs for k < window; its id is r*cs + c0."""
    cpr = 128 // m
    window = min(cpr, 8)
    return window, cpr // window


def grouped_scan8(codes, tables, group_part, slot_pair, group_sizes):
    """Grouped 8-bit conventional-ADC scan to per-(pair, window) minima.

    Args:
      codes: (P, rpp, 128) uint8 row128 storage of m-byte codes.
      tables: (QA, m, 256) bfloat16 per-pair tables, m in SCAN8_SQ_COUNTS.
      group_part: (gcap,) int32 partition scanned by each group.
      slot_pair: (gcap, G) int32 pair id in each slot, -1 when empty.
      group_sizes: (gcap,) int32 real code count of each group's partition.

    Returns:
      (mins (QA, C) float32, idx (QA, C) int32), C = rpp * cs windows
      (scan8_windows): the minimum over the window's real codes of sum_b
      float(tables[p, b, byte_b]), summed in float32 over b = 0..m-1, and
      the partition-local code index of the minimum (ties to the lower
      code); +inf and -1 for a window with no real code.
    """
    dev = codes.device
    _check_groups(codes, group_part, slot_pair, group_sizes)
    _check(tables, "tables", torch.bfloat16, 3, dev)
    qa, m, k = tables.shape
    if k != 256 or m not in SCAN8_SQ_COUNTS:
        raise ValueError(f"need (QA, m, 256) tables with m in {SCAN8_SQ_COUNTS}, "
                         f"got {tuple(tables.shape)}")
    if dev.type == "cpu":
        return grouped_scan8_plain(codes, tables, group_part, slot_pair, group_sizes)
    _require_cuda(dev, codes, tables)
    gcap, g = slot_pair.shape
    rpp = codes.shape[1]
    c = rpp * scan8_windows(m)[1]
    mins = torch.empty((qa, c), dtype=torch.float32, device=dev)
    idx = torch.empty((qa, c), dtype=torch.int32, device=dev)
    if qa and rpp and gcap:
        ptrs = [t.data_ptr() for t in
                (codes, tables, group_part, slot_pair, group_sizes, mins, idx)]
        _launch("qadc_grouped_scan8", dev, *ptrs, gcap, g, rpp, m)
        launches["grouped_scan8"] += 1
    return mins, idx


def grouped_scan8_plain(codes, tables, group_part, slot_pair, group_sizes):
    """Plain PyTorch version of grouped_scan8 (same arguments and result)."""
    _, rpp, _ = codes.shape
    qa, m, _ = tables.shape
    cpr = 128 // m
    window, cs = scan8_windows(m)
    dev = codes.device
    pair, part, size = _live_slots(slot_pair, group_part, group_sizes)
    rows = codes[part].reshape(-1, rpp * cpr, m)                  # (S, codes, m)
    tab = tables[pair].to(torch.float32)                          # (S, m, 256)
    acc = torch.zeros(rows.shape[:2], dtype=torch.float32, device=dev)
    for b in range(m):
        acc = acc + torch.gather(tab[:, b], 1, rows[..., b].long())
    code = torch.arange(rpp * cpr, device=dev)
    acc = torch.where(code[None, :] < size[:, None], acc, torch.inf)
    # Code row*cpr + k*cs + c0 sits at [row, k, c0]: windows reduce over k.
    acc = acc.reshape(-1, rpp, window, cs)
    code = code.reshape(rpp, window, cs)
    best = acc[:, :, 0]
    arg = code[None, :, 0].expand_as(best)
    for k in range(1, window):  # strict: ties keep the lower code
        take = acc[:, :, k] < best
        best = torch.where(take, acc[:, :, k], best)
        arg = torch.where(take, code[None, :, k], arg)
    arg = torch.where(torch.isinf(best), -1, arg)
    out_min = torch.full((qa, rpp * cs), torch.inf, dtype=torch.float32, device=dev)
    out_idx = torch.full((qa, rpp * cs), -1, dtype=torch.int32, device=dev)
    out_min[pair] = best.reshape(-1, rpp * cs)
    out_idx[pair] = arg.reshape(-1, rpp * cs).to(torch.int32)
    return out_min, out_idx


# ---------------------------------------------------------------- M2


def rows_adc(codes_rows, row_ids, pair_ids, tlo, thi):
    """Exact float ADC of whole storage rows, one compact table per row.

    Args:
      codes_rows: (R, 128) uint8, all storage rows (index.codes flattened).
      row_ids: (A,) int32 rows to score.
      pair_ids: (A,) int32 table row of each scored row.
      tlo, thi: (QA, 16*cb) float32 compact tables (ivf.tile_tables_rows):
        lane j*cb + b holds sub-quantizer 2b (tlo) / 2b+1 (thi), centroid j.

    Returns:
      (A, cpr) float32 distances of the cpr codes of each row, summed in
      float32 over b = 0..cb-1, low nibble then high.
    """
    dev = codes_rows.device
    _check(codes_rows, "codes_rows", torch.uint8, 2, dev)
    _check(row_ids, "row_ids", torch.int32, 1, dev)
    _check(pair_ids, "pair_ids", torch.int32, 1, dev)
    _check(tlo, "tlo", torch.float32, 2, dev)
    _check(thi, "thi", torch.float32, 2, dev)
    cb = _table_code_bytes(tlo.shape[1])
    if codes_rows.shape[1] != 128 or thi.shape != tlo.shape:
        raise ValueError("need (R, 128) codes and equal tlo/thi shapes")
    if row_ids.shape != pair_ids.shape:
        raise ValueError("row_ids and pair_ids must have one entry per row")
    if dev.type == "cpu":
        return rows_adc_plain(codes_rows, row_ids, pair_ids, tlo, thi)
    _require_cuda(dev, codes_rows)
    a = row_ids.shape[0]
    out = torch.empty((a, 128 // cb), dtype=torch.float32, device=dev)
    if a:
        ptrs = [t.data_ptr() for t in (codes_rows, row_ids, pair_ids, tlo, thi, out)]
        _launch("qadc_rows_adc", dev, *ptrs, a, cb)
        launches["rows_adc"] += 1
    return out


def _adc_sum(code_bytes, tlo_rows, thi_rows, cb):
    """sum_b tlo[j_lo*cb + b] + thi[j_hi*cb + b] in the kernels' order.

    code_bytes: (N, C, cb) uint8; tlo_rows/thi_rows: (N, 16*cb) float32.
    """
    acc = torch.zeros(code_bytes.shape[:2], dtype=torch.float32,
                      device=code_bytes.device)
    for b in range(cb):
        byte = code_bytes[..., b].long()
        acc = acc + torch.gather(tlo_rows, 1, (byte & 15) * cb + b)
        acc = acc + torch.gather(thi_rows, 1, (byte >> 4) * cb + b)
    return acc


def rows_adc_plain(codes_rows, row_ids, pair_ids, tlo, thi):
    """Plain PyTorch version of rows_adc (same arguments and result)."""
    cb = tlo.shape[1] // 16
    rows = codes_rows[row_ids.long()].reshape(-1, 128 // cb, cb)
    p = pair_ids.long()
    return _adc_sum(rows, tlo[p], thi[p], cb)


# ---------------------------------------------------------------- M3


def direct_scan(codes, pair_part, tlo, thi, sizes):
    """Exact float ADC of every code of each probed partition.

    Args:
      codes: (P, rpp, 128) uint8 row128 storage, part_pad = rpp*cpr a
        multiple of 256.
      pair_part: (QA,) int32 partition of each (query, probe) pair.
      tlo, thi: (QA, 16*cb) float32 compact tables, one per pair.
      sizes: (QA,) int32 real code count of each pair's partition.

    Returns:
      (dists (QA, part_pad) float32 in code order, MASK_BIG at or past the
      size; mins (QA, part_pad / TILE) float32 minima of TILE-code tiles).
    """
    dev = codes.device
    _check(codes, "codes", torch.uint8, 3, dev)
    _check(pair_part, "pair_part", torch.int32, 1, dev)
    _check(tlo, "tlo", torch.float32, 2, dev)
    _check(thi, "thi", torch.float32, 2, dev)
    _check(sizes, "sizes", torch.int32, 1, dev)
    cb = _table_code_bytes(tlo.shape[1])
    part_pad = codes.shape[1] * (128 // cb)
    qa = pair_part.shape[0]
    if codes.shape[2] != 128 or part_pad % 256 != 0:
        raise ValueError(f"need (P, rpp, 128) codes with part_pad % 256 == 0, "
                         f"got {tuple(codes.shape)}")
    if thi.shape != tlo.shape or tlo.shape[0] != qa or sizes.shape[0] != qa:
        raise ValueError("pair_part, tlo, thi and sizes disagree on QA")
    if dev.type == "cpu":
        return direct_scan_plain(codes, pair_part, tlo, thi, sizes)
    _require_cuda(dev, codes)
    out = torch.empty((qa, part_pad), dtype=torch.float32, device=dev)
    mins = torch.empty((qa, part_pad // TILE), dtype=torch.float32, device=dev)
    if qa:
        ptrs = [t.data_ptr() for t in (codes, pair_part, tlo, thi, sizes, out, mins)]
        _launch("qadc_direct_scan", dev, *ptrs, qa, part_pad, cb)
        launches["direct_scan"] += 1
    return out, mins


def direct_scan_plain(codes, pair_part, tlo, thi, sizes):
    """Plain PyTorch version of direct_scan (same arguments and result)."""
    cb = tlo.shape[1] // 16
    pc = code_view(codes, cb)[pair_part.long()]              # (QA, part_pad, cb)
    qa, part_pad, _ = pc.shape
    d = _adc_sum(pc, tlo, thi, cb)
    col = torch.arange(part_pad, device=codes.device)
    d = torch.where(col[None, :] < sizes[:, None], d, MASK_BIG)
    return d, d.reshape(qa, part_pad // TILE, TILE).amin(dim=-1)


class Kernels(NamedTuple):
    """The kernel functions a search runs (see DISPATCH and PLAIN)."""

    grouped_scan: Callable
    rows_adc: Callable
    direct_scan: Callable
    grouped_scan8: Callable


# The search path's default: kernels on CUDA tensors, plain versions on CPU.
DISPATCH = Kernels(grouped_scan, rows_adc, direct_scan, grouped_scan8)
# The plain versions on any device, for comparing a search on the card.
PLAIN = Kernels(grouped_scan_plain, rows_adc_plain, direct_scan_plain, grouped_scan8_plain)
