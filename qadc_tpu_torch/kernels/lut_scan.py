"""The search path's kernels: Hopper CUDA kernels and their plain versions
(counterpart of qadc_tpu/kernels/lut_scan.py).

Six kernels, written by hand in CUDA C++ under `qadc_tpu_torch/csrc/`:

  grouped_scan  (M1)  <- lut_scan_grouped_tq / lut_scan_grouped_prefetch,
                         int8 tables (Quick ADC) or float32 (4-bit ADC)
  grouped_scan8 (5+6) <- lut_scan8_grouped_tq / lut_scan8_grouped_prefetch
  rows_adc      (M2)  <- rows_adc_accumulate (+ ivf.rows_adc's selector matmul)
  direct_scan   (M3)  <- rows_adc_grouped_prefetch (the b=1 direct path)
  flat_scan     (7+8) <- lut_scan_tq / lut_scan_reduce (flat 4-bit), int8 or
                         float32 tables
  flat_scan8    (9)   <- lut_scan8_reduce (flat 8-bit)

Each wrapper checks its arguments, then dispatches on the device of the
tensors it was given: on the CPU it runs the plain PyTorch version beside
it, on CUDA it launches the kernel on the current stream (no synchronise)
and adds one to its count in `launches`; on any other device it raises.
There is no fallback from CUDA to the plain version. The plain versions
take the same arguments and return the same results; tests hold them to
the JAX package, and the kernels to them.

Padded codes (at or past a partition's size, or the flat index's n) never
enter a scan's window minimum: M1 and grouped_scan8 take each group's size
in codes, flat_scan and flat_scan8 the real code count.
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
# Sub-quantizer counts flat_scan8 takes, and its window (the flat index's
# lut_scan8_reduce call: block_n 256, window 16).
FLAT_SCAN8_SQ_COUNTS = (4, 8, 16, 32)
FLAT8_BLOCK, FLAT8_WINDOW = 256, 16

# Launches of each kernel since the last reset_launch_counts();
# grouped_scan_f32 and flat_scan_f32 are M1 and flat_scan with float tables.
launches = {"grouped_scan": 0, "grouped_scan_f32": 0, "grouped_scan8": 0,
            "rows_adc": 0, "direct_scan": 0, "flat_scan": 0, "flat_scan_f32": 0,
            "flat_scan8": 0}


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


def _first_min(vals, ids):
    """Minimum along the last axis and the id of its first occurrence.

    vals: (..., W); ids: (..., W) broadcastable to vals, ascending along W,
    so the strict compare keeps the lower id on ties, as the kernels do.
    """
    ids = ids.expand(vals.shape)
    best, arg = vals[..., 0], ids[..., 0]
    for k in range(1, vals.shape[-1]):
        take = vals[..., k] < best
        best = torch.where(take, vals[..., k], best)
        arg = torch.where(take, ids[..., k], arg)
    return best, arg


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
    acc = acc.reshape(-1, rpp, window, cs).transpose(2, 3)
    code = code.reshape(rpp, window, cs).transpose(1, 2)
    best, arg = _first_min(acc, code)
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


# ---------------------------------------------------------------- 7 + 8


def flat_scan(codes_rows, tables, n: int, with_rows: bool = False):
    """Flat 4-bit ADC scan to per-query row minima.

    Args:
      codes_rows: (R, 128) uint8 row128 storage.
      tables: (Q, M, 16) per-query tables, M in (16, 32): int8 with entries
        in [0, 127] (Quick ADC), or float32 (conventional ADC).
      n: real code count; codes at or past n are padding.
      with_rows: also return the code index of each minimum.

    Returns:
      (mins, idx): mins (Q, R) int32 (int8 tables) or float32, mins[q, i]
      the minimum over the real codes of storage row i of sum_m
      tables[q, m, nibble_m], summed over b = 0..cb-1, low nibble then high
      (no 127 saturation); TRIM_SENTINEL (int32) or +inf (float32) for a row
      with no real code. idx (Q, R) int32 is the code index of the minimum
      (ties to the lower code, -1 for a row with no real code), or None
      without with_rows.
    """
    dev = codes_rows.device
    _check(codes_rows, "codes_rows", torch.uint8, 2, dev)
    f32 = getattr(tables, "dtype", None) == torch.float32
    _check(tables, "tables", torch.float32 if f32 else torch.int8, 3, dev)
    q, m, k = tables.shape
    if codes_rows.shape[1] != 128 or k != 16 or m not in (16, 32):
        raise ValueError(f"need (R, 128) codes and (Q, 16|32, 16) tables, got "
                         f"{tuple(codes_rows.shape)} and {tuple(tables.shape)}")
    r_count = codes_rows.shape[0]
    n = max(0, min(int(n), r_count * (256 // m)))
    if dev.type == "cpu":
        return flat_scan_plain(codes_rows, tables, n, with_rows)
    _require_cuda(dev, codes_rows, tables)
    out = torch.empty((q, r_count), dtype=tables.dtype if f32 else torch.int32, device=dev)
    idx = torch.empty((q, r_count), dtype=torch.int32, device=dev) if with_rows else None
    if q and r_count:
        _launch("qadc_flat_scan", dev, codes_rows.data_ptr(), tables.data_ptr(),
                out.data_ptr(), None if idx is None else idx.data_ptr(), r_count, q, n,
                m // 2, int(f32))
        launches["flat_scan_f32" if f32 else "flat_scan"] += 1
    return out, idx


def flat_scan_plain(codes_rows, tables, n: int, with_rows: bool = False):
    """Plain PyTorch version of flat_scan (same arguments and result)."""
    q, m, _ = tables.shape
    cb = m // 2
    cpr = 128 // cb
    r_count = codes_rows.shape[0]
    f32 = tables.dtype == torch.float32
    acc_dtype = torch.float32 if f32 else torch.int32
    dev = codes_rows.device
    codes = codes_rows.reshape(-1, cb)                            # (N_pad, cb)
    tab = tables.to(acc_dtype)
    acc = torch.zeros((q, codes.shape[0]), dtype=acc_dtype, device=dev)
    for b in range(cb):  # rows_adc's order: b = 0..cb-1, low nibble then high
        byte = codes[:, b].long()
        acc = acc + tab[:, 2 * b][:, byte & 15]
        acc = acc + tab[:, 2 * b + 1][:, byte >> 4]
    code = torch.arange(codes.shape[0], device=dev)
    none = torch.inf if f32 else torch.iinfo(torch.int32).max
    acc = torch.where(code < n, acc, none)                       # padded codes
    best, arg = _first_min(acc.reshape(q, r_count, cpr), code.reshape(r_count, cpr))
    empty = torch.arange(r_count, device=dev) * cpr >= n         # no real code
    best = torch.where(empty, torch.inf if f32 else TRIM_SENTINEL, best)
    if not with_rows:
        return best, None
    return best, torch.where(empty, -1, arg).to(torch.int32)


# ---------------------------------------------------------------- 9


def flat8_members(window_ids: torch.Tensor, m: int) -> torch.Tensor:
    """(..., 16) code indices of flat_scan8's windows, ascending.

    Window b*16 + j of 256-code block b holds the codes of slots {w*16 + j :
    w < 16} (the JAX package's window_slots at block_n 256, window 16,
    mapped by slots_to_rows): storage rows j + 16k (k < 16 / cpr), every
    position, when cpr <= 16; at cpr = 32 (m = 4), the positions of parity
    j // 8 of row j % 8.
    """
    cpr = 128 // m
    blk = window_ids // FLAT8_WINDOW
    j = (window_ids % FLAT8_WINDOW)[..., None]
    rank = torch.arange(FLAT8_WINDOW, device=window_ids.device)
    if cpr == 32:
        local = (j % 8) * 32 + 2 * rank + j // 8
    else:
        local = (j + 16 * (rank // cpr)) * cpr + rank % cpr
    return blk[..., None] * FLAT8_BLOCK + local


def flat_scan8(codes_rows, tables, n: int):
    """Flat 8-bit conventional-ADC scan to per-query window minima.

    Args:
      codes_rows: (R, 128) uint8 row128 storage of m-byte codes, R * cpr a
        multiple of FLAT8_BLOCK.
      tables: (Q, m, 256) bfloat16 per-query tables, m in FLAT_SCAN8_SQ_COUNTS.
      n: real code count; codes at or past n are padding.

    Returns:
      (mins (Q, C) float32, idx (Q, C) int32), C = R * cpr / 16 windows of
      flat8_members: the minimum over the window's real codes of sum_b
      float(tables[q, b, byte_b]), summed in float32 over b = 0..m-1, and
      the code index of the minimum (ties to the lower code); +inf and -1
      for a window with no real code.
    """
    dev = codes_rows.device
    _check(codes_rows, "codes_rows", torch.uint8, 2, dev)
    _check(tables, "tables", torch.bfloat16, 3, dev)
    q, m, k = tables.shape
    if k != 256 or m not in FLAT_SCAN8_SQ_COUNTS:
        raise ValueError(f"need (Q, m, 256) tables with m in {FLAT_SCAN8_SQ_COUNTS}, "
                         f"got {tuple(tables.shape)}")
    n_pad = codes_rows.shape[0] * (128 // m)
    if codes_rows.shape[1] != 128 or n_pad % FLAT8_BLOCK:
        raise ValueError(f"need (R, 128) codes holding a multiple of {FLAT8_BLOCK} codes, "
                         f"got {tuple(codes_rows.shape)}")
    n = max(0, min(int(n), n_pad))
    if dev.type == "cpu":
        return flat_scan8_plain(codes_rows, tables, n)
    _require_cuda(dev, codes_rows, tables)
    c = n_pad // FLAT8_WINDOW
    mins = torch.empty((q, c), dtype=torch.float32, device=dev)
    idx = torch.empty((q, c), dtype=torch.int32, device=dev)
    if q and n_pad:
        _launch("qadc_flat_scan8", dev, codes_rows.data_ptr(), tables.data_ptr(),
                mins.data_ptr(), idx.data_ptr(), n_pad // FLAT8_BLOCK, q, n, m)
        launches["flat_scan8"] += 1
    return mins, idx


def flat_scan8_plain(codes_rows, tables, n: int):
    """Plain PyTorch version of flat_scan8 (same arguments and result)."""
    q, m, _ = tables.shape
    dev = codes_rows.device
    codes = codes_rows.reshape(-1, m)                             # (N_pad, m)
    tab = tables.to(torch.float32)
    acc = torch.zeros((q, codes.shape[0]), dtype=torch.float32, device=dev)
    for b in range(m):
        acc = acc + tab[:, b][:, codes[:, b].long()]
    code = torch.arange(codes.shape[0], device=dev)
    acc = torch.where(code < n, acc, torch.inf)                  # padded codes
    members = flat8_members(torch.arange(codes.shape[0] // FLAT8_WINDOW, device=dev), m)
    best, arg = _first_min(acc[:, members], members)            # (Q, C)
    return best, torch.where(torch.isinf(best), -1, arg).to(torch.int32)


class Kernels(NamedTuple):
    """The kernel functions a search runs (see DISPATCH and PLAIN)."""

    grouped_scan: Callable
    rows_adc: Callable
    direct_scan: Callable
    grouped_scan8: Callable
    flat_scan: Callable
    flat_scan8: Callable


# The search path's default: kernels on CUDA tensors, plain versions on CPU.
DISPATCH = Kernels(grouped_scan, rows_adc, direct_scan, grouped_scan8, flat_scan, flat_scan8)
# The plain versions on any device, for comparing a search on the card.
PLAIN = Kernels(grouped_scan_plain, rows_adc_plain, direct_scan_plain, grouped_scan8_plain,
                flat_scan_plain, flat_scan8_plain)
