"""The search path's kernels: Hopper CUDA kernels and their plain versions
(counterpart of qadc_tpu/kernels/lut_scan.py).

Kernels written by hand in CUDA C++ under `qadc_tpu_torch/csrc/`:

  grouped_scan  (M1)  <- lut_scan_grouped_tq / lut_scan_grouped_prefetch,
                         int8 tables (Quick ADC: the tensor-core kernel of
                         scan_mma.cu) or float32 (4-bit ADC: the slot-minor
                         kernel of grouped_scan_sm.cu)
  grouped_scan8 (5+6) <- lut_scan8_grouped_tq / lut_scan8_grouped_prefetch:
                         the slot-minor kernel of grouped_scan8_sm.cu
  rows_adc      (M2)  <- rows_adc_accumulate (+ ivf.rows_adc's selector matmul):
                         tiles of ROWS_ADC_TILE entries, each run of equal
                         pair ids' tables staged once in shared memory
  direct_scan   (M3)  <- rows_adc_grouped_prefetch (the direct path): items of
                         a pair and a chunk of codes, the tables staged once
                         an item (direct_scan_rounds)
  flat_scan     (7+8) <- lut_scan_tq / lut_scan_reduce (flat 4-bit), int8
                         tables (scan_wgmma.cu from WGMMA_MIN_QUERIES
                         queries, scan_mma.cu below) or float32 (the
                         query-minor kernel of flat_scan_qm.cuh from
                         QUERY_MINOR_MIN_QUERIES queries, flat_scan.cu below)
  flat_scan8    (9)   <- lut_scan8_reduce (flat 8-bit): the query-minor
                         kernel of flat_scan8_qm.cuh from
                         QUERY_MINOR_MIN_QUERIES8 queries, flat_scan8.cu below
  flat_scan_window      (8, 8v, 8w) <- lut_scan_reduce at any (block_n,
                         window), its accumulate variants, and (through
                         lut_scan_topk_int8) its screened top-r: int8
                         tables on the warpgroup product over window-major
                         columns (scan_wgmma.cu, at any batch), float32 on
                         the query-minor kernel of flat_scan_window_qm.cu
                         from WINDOW_QUERY_MINOR_MIN_QUERIES queries on, the
                         lookup kernel of flat_scan_window.cu below
  flat_scan_window_regs (10) <- lut_scan_vpu_reduce: the same minima by
                         another engine, tables in registers, four lookups
                         a byte permute (flat_scan_window_perm4.cu)

flat_scan_f32_lookup, flat_scan8_lookup and flat_scan_window_f32_lookup run
at any batch the kernel that flat_scan (float32 tables), flat_scan8 and
flat_scan_window (float32 tables) run below a query-count threshold
(flat_scan.cu, flat_scan8.cu, flat_scan_window.cu). Each of the two kernels
wins on one side of its threshold, which the dispatch picks from the query
count; these entries are how the thresholds are measured.

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

import functools
from typing import Callable, NamedTuple

import torch

from qadc_tpu_torch.core.layout import code_view
from qadc_tpu_torch.eval.trace import count, recording_open
from qadc_tpu_torch.ops.topk import exact_tile_screen

# Finite sentinel for codes past a partition's size (lut_scan.py:MASK_BIG):
# it flows through the screen when fewer than wq real candidates exist, and
# the direct path turns it back into +inf / label -1 after the final cut.
MASK_BIG = 3.0e38
# Written by grouped_scan for rows it skips (lut_scan.py:_TRIM_SENTINEL_I32);
# the callers read those windows as +inf (above every real sum) or mask them
# by the partitions' sizes.
TRIM_SENTINEL = 1 << 30
# Width of the tiles whose minima direct_scan and grouped_scan (tile_minima)
# emit for exact_tile_screen.
TILE = 32
# Sub-quantizer counts grouped_scan8 takes (8-bit codes of m bytes).
SCAN8_SQ_COUNTS = (4, 8, 16)
# Sub-quantizer counts flat_scan8 takes, and its window (the flat index's
# lut_scan8_reduce call: block_n 256, window 16).
FLAT_SCAN8_SQ_COUNTS = (4, 8, 16, 32)
FLAT8_BLOCK, FLAT8_WINDOW = 256, 16
# The JAX package's flat kernel gates (qadc_tpu/kernels/lut_scan.py): codes
# per scan block, and the window that sets how many candidates a query has.
DEFAULT_BLOCK_N = 1024
DEFAULT_WINDOW = 16
# lut_scan_reduce's accumulate variants. On the TPU they pick how the MXU
# builds the one-hot pre-image; on the H100 all three run the same kernels.
SCAN_VARIANTS = ("int8", "int8c", "bf16")
# Largest code block (block_n * code bytes) the window scans stage in shared
# memory: 8192 codes of 16 bytes, the JAX package's MAX_BLOCK_N at cb = 16.
WINDOW_SCAN_MAX_BLOCK_BYTES = 128 * 1024

# Fewest queries at which flat_scan's int8 kernel is the warpgroup one
# (csrc/scan_wgmma.cu, whose time does not fall below 128 queries) and not the
# mma.sync one (csrc/scan_mma.cu, whose time follows the query count). The
# crossover measured on an NVIDIA H100 80GB HBM3, 700.00 W, over 1M 16x4 codes
# (scripts/torch_scan_lab.py), ms by mma.sync / wgmma: 32 queries 0.038 / 0.067,
# 48: 0.066 / 0.067, 64: 0.074 / 0.067, 128: 0.134 / 0.069.
WGMMA_MIN_QUERIES = 48

# Shared memory one thread block may take on the H100
# (cudaFuncAttributeMaxDynamicSharedMemorySize), and the part of it the
# query-minor flat scans (csrc/flat_scan_qm.cuh, flat_scan8_qm.cuh) fill with
# one chunk of queries' tables; the rest stages their outputs.
SMEM_BLOCK_BYTES = 227 * 1024
QUERY_MINOR_TABLE_BYTES = 128 * 1024
# Fewest queries of a query-minor chunk: a lane is a query of the float scan
# (32 lanes a code), a lane is two queries of the 8-bit scan (4 lanes a code).
QUERY_MINOR_LEAST, QUERY_MINOR_LEAST8 = 32, 8
# Fewest queries at which flat_scan with float tables and flat_scan8 run their
# query-minor kernels; below, most lanes of those would idle and the kernels
# of csrc/flat_scan.cu / flat_scan8.cu run, whose time follows the query count.
# The crossovers measured on an NVIDIA H100 80GB HBM3, 700.00 W, over 1M 8-byte
# codes (scripts/torch_scan_lab.py), ms by query-minor / lookup kernel: float
# 16 queries 0.088 / 0.075, 20: 0.089 / 0.094, 32: 0.089 / 0.147, 128: 0.286 /
# 0.555; 8-bit 3 queries 0.0173 / 0.0150, 4: 0.0175 / 0.0193, 32: 0.053 / 0.168.
QUERY_MINOR_MIN_QUERIES = 20
QUERY_MINOR_MIN_QUERIES8 = 4
# Fewest queries at which flat_scan_window with float tables runs its
# query-minor kernel (csrc/flat_scan_window_qm.cu). That kernel's time stays
# flat up to 32 queries (a lane's queries are staged whatever their number),
# the lookup kernel's grows with them. Measured (scripts/torch_scan_lab.py
# window, 1M random codes, NVIDIA H100 80GB HBM3, 700.00 W), ms by
# query-minor / lookup kernel at 1 / 24 / 26 / 28 / 30 / 32 queries: 16x4
# (1024, 16) 0.1115 / 0.0097, 0.1125 / 0.0994, 0.1124 / 0.1086, 0.1125 /
# 0.1157, 0.1124 / 0.1245, 0.1121 / 0.1351; (512, 8) the lookup kernel ahead
# up to 28 (0.1198 / 0.1108), 32x4 (1024, 16) up to 24 (0.1834 / 0.1742).
WINDOW_QUERY_MINOR_MIN_QUERIES = 28

# Slots of a window, the slot-minor grouped scans' unit of work with a tile of
# rows (csrc/grouped_slot_minor.cuh): a thread holds the window's 4 slots.
GROUPED_WINDOW_SLOTS = 4

# Launches of each kernel since the last reset_launch_counts();
# grouped_scan_f32, flat_scan_f32 and flat_scan_window_f32 are M1, flat_scan
# and flat_scan_window with float tables, the *_lookup keys the entries that
# force the kernel below a threshold, scan_lab, selector_sum and empty_kernel
# the instruments of kernels/scan_lab.py.
launches = {"grouped_scan": 0, "grouped_scan_f32": 0, "grouped_scan8": 0,
            "rows_adc": 0, "direct_scan": 0, "flat_scan": 0, "flat_scan_f32": 0,
            "flat_scan8": 0, "flat_scan_window": 0, "flat_scan_window_f32": 0,
            "flat_scan_window_f32_lookup": 0, "flat_scan_window_regs": 0,
            "flat_scan_f32_lookup": 0, "flat_scan8_lookup": 0, "scan_lab": 0,
            "selector_sum": 0, "empty_kernel": 0}


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


def grouped_scan(codes, tables, group_part, slot_pair, group_sizes, tile_minima: bool = False):
    """Grouped 4-bit ADC scan to per-(pair, row) window minima.

    Args:
      codes: (P, rpp, 128) uint8 row128 storage.
      tables: (QA, M, 16) per-pair tables, M in (16, 32): int8 with entries
        in [0, 127] (Quick ADC), or float32 (conventional ADC).
      group_part: (gcap,) int32 partition scanned by each group.
      slot_pair: (gcap, G) int32 pair id in each slot, -1 when empty.
      group_sizes: (gcap,) int32 real code count of each group's partition.
      tile_minima: int8 tables only, rpp a multiple of TILE: also return the
        rows' minima over each tile of TILE rows, for exact_tile_screen.

    Returns:
      (QA, rpp) int32 (int8 tables) or float32: out[p, i] = min over the
      real codes of row i of pair p's partition of sum_m tables[p, m,
      nibble_m], summed over b = 0..cb-1, low nibble then high (no 127
      saturation); TRIM_SENTINEL (int32) or +inf (float32) for rows at or
      past ceil(size / cpr). With tile_minima, (out, tiles): tiles (QA,
      rpp // TILE) float32, tiles[p, t] = min of out[p, TILE*t:TILE*(t+1)]
      over its rows below TRIM_SENTINEL as float, +inf where none is (M1
      writes them beside the rows, from the minima it holds).

    With int8 tables, in a recording, it counts `scan.rows`: the real
    storage rows the scan walks (grouped_scan_rows summed; on a card the
    kernels' own sum, a 0-d device tensor read when the recording closes).
    """
    _check_groups(codes, group_part, slot_pair, group_sizes)
    dev = codes.device
    f32 = getattr(tables, "dtype", None) == torch.float32
    _check(tables, "tables", torch.float32 if f32 else torch.int8, 3, dev)
    qa, m, k = tables.shape
    if k != 16 or m not in (16, 32):
        raise ValueError(f"need (QA, 16|32, 16) tables, got {tuple(tables.shape)}")
    rpp = codes.shape[1]
    if tile_minima and (f32 or rpp % TILE):
        raise ValueError(f"tile minima need int8 tables and rpp % {TILE} == 0, "
                         f"got {tables.dtype}, rpp={rpp}")
    if dev.type == "cpu":
        if not f32 and recording_open():
            count("scan.rows", grouped_scan_rows(slot_pair, group_sizes, rpp, 256 // m).sum())
        return grouped_scan_plain(codes, tables, group_part, slot_pair, group_sizes, tile_minima)
    _require_cuda(dev, codes, tables)
    gcap, g = slot_pair.shape
    out = torch.empty((qa, rpp), dtype=tables.dtype if f32 else torch.int32, device=dev)
    tiles = torch.empty((qa, rpp // TILE), dtype=torch.float32, device=dev) if tile_minima else None
    if qa and rpp and gcap:
        ptrs = [t.data_ptr() for t in (codes, tables, group_part, slot_pair, group_sizes, out)]
        if f32:
            _launch("qadc_grouped_scan_sm", dev, *ptrs, gcap, g, rpp, m // 2)
        else:
            # The plan's scratch (csrc/scan_mma.cu): packed live pairs, their
            # counts, the prefix of the groups' costs.
            plan = (torch.empty((gcap, g), dtype=torch.int32, device=dev),
                    torch.empty((gcap,), dtype=torch.int32, device=dev),
                    torch.empty((gcap + 2,), dtype=torch.int64, device=dev))
            _launch("qadc_grouped_scan_mma", dev, *ptrs, tiles.data_ptr() if tile_minima else None,
                    *(t.data_ptr() for t in plan), gcap, g, rpp, m // 2,
                    grouped_mma_tiles(m // 2, qa, codes.shape[0]))
            count("scan.rows", plan[2][gcap + 1])
        launches["grouped_scan_f32" if f32 else "grouped_scan"] += 1
    return (out, tiles) if tile_minima else out


# M1's work split with int8 tables (csrc/scan_mma.cu): a group's cost an oct
# of eight storage rows is GROUPED_MMA_ONEHOT_COST a chunk of the N tiles a
# warp holds (grouped_mma_tiles; a one-hot build) plus one a tile of 8 live
# pairs; warp w of W walks the octs whose first cost unit lies in
# [w, w + 1) * total / W of the groups' cost prefix.
GROUPED_MMA_OCT = 8
GROUPED_MMA_ONEHOT_COST = 4


def grouped_mma_tiles(cb: int, qa: int, parts: int) -> int:
    """N tiles of 8 pairs M1's warps hold in registers, from the batch's
    shape: 2 at cb 8 where a probed partition takes more than 8 pairs on
    average (qa > 8 * parts), else 1 (the registers buy occupancy)."""
    return 2 if cb == 8 and qa > 8 * parts else 1


def grouped_scan_rows(slot_pair, group_sizes, rpp: int, cpr: int) -> torch.Tensor:
    """(gcap,) int32 real storage rows M1 walks in each group: ceil(size /
    cpr), at most rpp, for a group with a live slot; 0 otherwise."""
    rows = torch.clamp((group_sizes.long() + cpr - 1) // cpr, 0, rpp)
    return torch.where((slot_pair >= 0).any(dim=1), rows, 0).to(torch.int32)


def grouped_scan_mma_plan(slot_pair, group_sizes, rpp: int, cb: int, held: int):
    """Plain version of M1's plan and prefix kernels, whose warps hold `held`
    N tiles (grouped_mma_tiles): (live_pairs (gcap, G) int32, each group's
    live pairs packed to the front in slot order, -1 after; live (gcap,)
    int32 their counts; base (gcap + 2,) int64 the prefix of the groups'
    costs, then the real rows walked)."""
    gcap, g = slot_pair.shape
    is_live = slot_pair >= 0
    live = is_live.sum(dim=1).to(torch.int32)
    order = torch.argsort((~is_live).to(torch.int8), dim=1, stable=True)
    packed = torch.gather(slot_pair, 1, order)
    octs = (grouped_scan_rows(slot_pair, group_sizes, rpp, 128 // cb).long()
            + GROUPED_MMA_OCT - 1) // GROUPED_MMA_OCT
    tiles = (live.long() + 7) // 8
    chunks = (tiles + held - 1) // held
    cost = octs * (chunks * GROUPED_MMA_ONEHOT_COST + tiles)
    base = torch.zeros(gcap + 2, dtype=torch.int64, device=slot_pair.device)
    base[1:-1] = torch.cumsum(cost, 0)
    base[-1] = grouped_scan_rows(slot_pair, group_sizes, rpp, 128 // cb).sum()
    return packed, live, base


def grouped_scan_mma_walk(slot_pair, group_sizes, rpp: int, cb: int, held: int, warps: int):
    """The (group, oct) pairs each of `warps` warps of M1's scan walks, in
    order, and the (group, first row) of each live group's sentinel rows
    (rows first..rpp-1 of its live pairs): the kernel's walk in Python."""
    _, live, base = grouped_scan_mma_plan(slot_pair, group_sizes, rpp, cb, held)
    rows = grouped_scan_rows(slot_pair, group_sizes, rpp, 128 // cb).tolist()
    base, live = base[:-1].tolist(), live.tolist()
    gcap, total = len(live), base[-1]
    walks = []
    for w in range(warps):
        x, end, walk = total * w // warps, total * (w + 1) // warps, []
        while x < end:
            grp = max(i for i in range(gcap) if base[i] <= x)
            cost = (base[grp + 1] - base[grp]) // -(-rows[grp] // GROUPED_MMA_OCT)
            first = -(-(x - base[grp]) // cost)
            last = min(-(-rows[grp] // GROUPED_MMA_OCT), -(-(end - base[grp]) // cost))
            walk += [(grp, o) for o in range(first, last)]
            x = base[grp + 1]
        walks.append(walk)
    dead = [(grp, min(rpp, -(-rows[grp] // GROUPED_MMA_OCT) * GROUPED_MMA_OCT))
            for grp in range(gcap) if live[grp]]
    return walks, dead


def grouped_scan_plain(codes, tables, group_part, slot_pair, group_sizes,
                       tile_minima: bool = False):
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
    if not tile_minima:
        return out
    real = torch.where(out < TRIM_SENTINEL, out.to(torch.float32), torch.inf)
    return out, real.reshape(qa, rpp // TILE, TILE).amin(dim=-1)


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

    In a recording it counts `scan.rows`: the real storage rows of the
    groups with a live slot (grouped_scan_rows summed, a device tensor on a
    card), the rows whose codes the kernel loads, each counted once. It is
    computed from the routing, not by the kernel, and is not a walk as M1's
    is: the kernel loads a group's rows once for each window of 4 slots that
    holds a live pair, and visits every 128-row tile up to rpp, storing +inf
    minima for the rows past the real ones.
    """
    dev = codes.device
    _check_groups(codes, group_part, slot_pair, group_sizes)
    _check(tables, "tables", torch.bfloat16, 3, dev)
    qa, m, k = tables.shape
    if k != 256 or m not in SCAN8_SQ_COUNTS:
        raise ValueError(f"need (QA, m, 256) tables with m in {SCAN8_SQ_COUNTS}, "
                         f"got {tuple(tables.shape)}")
    if recording_open():
        count("scan.rows", grouped_scan_rows(slot_pair, group_sizes, codes.shape[1],
                                             128 // m).sum())
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
        _launch("qadc_grouped_scan8_sm", dev, *ptrs, gcap, g, rpp, m)
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


# ------------------------------------------- the slot-minor grouped scans' walk


def slot_windows(slot_row: torch.Tensor) -> list[torch.Tensor]:
    """The live slot windows of one group's row of slots: for each window of
    GROUPED_WINDOW_SLOTS consecutive slots holding a live slot, its live pair
    ids in slot order (csrc/grouped_slot_minor.cuh:check_items)."""
    out = []
    for w0 in range(0, slot_row.numel(), GROUPED_WINDOW_SLOTS):
        window = slot_row[w0:w0 + GROUPED_WINDOW_SLOTS]
        live = window[window >= 0].long()
        if live.numel():
            out.append(live)
    return out


def to_slot_minor(tables: torch.Tensor) -> torch.Tensor:
    """(n <= 4, E, K) tables of a slot window -> (E * K, 4), the layout the
    window is staged in: entry e of slot s at [e, s], zeros past n, so a
    thread fetches an entry's 4 slots with one vector load."""
    out = tables.new_zeros((GROUPED_WINDOW_SLOTS,) + tuple(tables.shape[1:]))
    out[:tables.shape[0]] = tables
    return out.reshape(GROUPED_WINDOW_SLOTS, -1).T.contiguous()


def grouped_scan_slot_minor_plain(codes, tables, group_part, slot_pair, group_sizes):
    """grouped_scan's float32 function by the slot-minor kernel's own walk
    (csrc/grouped_scan_sm.cu): the same arguments (float32 tables) and result
    as grouped_scan_plain, bit for bit.

    A group's slots run in windows of GROUPED_WINDOW_SLOTS (slot_windows),
    each window's tables staged slot-minor (to_slot_minor; the kernel keeps
    the 4 slots as two pairs of 8 bytes). A thread is a storage row holding
    all 4 slots: for each code, in code order, it looks up row (m * 16 +
    nibble) of the staged tables, all 4 slots at once, over b = 0..cb-1, low
    nibble then high, and keeps each slot's running minimum with a strict <.
    Used by the tests and chip_smoke.py, by no search path.
    """
    _, rpp, _ = codes.shape
    qa, m, _ = tables.shape
    cb = m // 2
    cpr = 128 // cb
    dev = codes.device
    out = torch.full((qa, rpp), torch.inf, dtype=torch.float32, device=dev)
    sizes = group_sizes.tolist()
    for g, part in enumerate(group_part.tolist()):
        rows = codes[part].reshape(rpp, cpr, cb).long()
        real = sizes[g] - torch.arange(rpp, device=dev) * cpr        # real codes of each row
        for pairs in slot_windows(slot_pair[g]):
            staged = to_slot_minor(tables[pairs])                     # (M * 16, 4)
            best = torch.full((rpp, GROUPED_WINDOW_SLOTS), torch.inf, dtype=torch.float32,
                              device=dev)
            for c in range(cpr):
                acc = torch.zeros_like(best)
                for b in range(cb):
                    byte = rows[:, c, b]
                    acc = acc + staged[(2 * b) * 16 + (byte & 15)]
                    acc = acc + staged[(2 * b + 1) * 16 + (byte >> 4)]
                take = (c < real)[:, None] & (acc < best)            # strict minimum
                best = torch.where(take, acc, best)
            out[pairs] = best[:, :pairs.numel()].T
    return out


def grouped_scan8_slot_minor_plain(codes, tables, group_part, slot_pair, group_sizes):
    """grouped_scan8's function by the slot-minor kernel's own walk
    (csrc/grouped_scan8_sm.cu): the same arguments and result as
    grouped_scan8_plain, bit for bit.

    A group's slots run in windows of GROUPED_WINDOW_SLOTS, each window's
    tables staged slot-minor. A thread is a storage row holding all 4 slots:
    for each of its cs scan windows it takes the codes c0 + k * cs in code
    order, looks up row b * 256 + byte of the staged tables, all 4 slots at
    once, sums in float32 over b = 0..m-1 and keeps each slot's running
    minimum and code index with a strict <. Used by the tests and
    chip_smoke.py, by no search path.
    """
    _, rpp, _ = codes.shape
    qa, m, _ = tables.shape
    cpr = 128 // m
    window, cs = scan8_windows(m)
    dev = codes.device
    windows = rpp * cs
    out_min = torch.full((qa, windows), torch.inf, dtype=torch.float32, device=dev)
    out_idx = torch.full((qa, windows), -1, dtype=torch.int32, device=dev)
    win = torch.arange(windows, device=dev)
    row, c0 = win // cs, win % cs
    sizes = group_sizes.tolist()
    for g, part in enumerate(group_part.tolist()):
        part_codes = codes[part].reshape(rpp * cpr, m).long()
        real = sizes[g] - row * cpr                                  # real codes of each row
        for pairs in slot_windows(slot_pair[g]):
            staged = to_slot_minor(tables[pairs]).to(torch.float32)   # (m * 256, 4)
            best = torch.full((windows, GROUPED_WINDOW_SLOTS), torch.inf, dtype=torch.float32,
                              device=dev)
            arg = torch.full(best.shape, -1, dtype=torch.int64, device=dev)
            for k in range(window):
                c = c0 + k * cs
                code = part_codes[row * cpr + c]                     # (windows, m)
                acc = torch.zeros_like(best)
                for b in range(m):
                    acc = acc + staged[b * 256 + code[:, b]]
                take = (c < real)[:, None] & (acc < best)            # strict: the lower code stays
                best = torch.where(take, acc, best)
                arg = torch.where(take, (row * cpr + c)[:, None], arg)
            n = pairs.numel()
            out_min[pairs] = best[:, :n].T
            out_idx[pairs] = arg[:, :n].T.to(torch.int32)
    return out_min, out_idx


# ---------------------------------------------------------------- M2


# Entries (storage rows) of one rows_adc tile: a thread block, one ballot.
ROWS_ADC_TILE = 16


def rows_adc(codes_rows, row_ids, pair_ids, tlo, thi):
    """Exact float ADC of whole storage rows, one compact table per row.

    Args:
      codes_rows: (R, 128) uint8, all storage rows (index.codes flattened).
      row_ids: (A,) int32 rows to score.
      pair_ids: (A,) int32 table row of each scored row, in any order (runs
        of equal ids share their tables' staging).
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
    _require_cuda(dev, codes_rows, tlo, thi)
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


def rows_adc_layout(cb: int) -> tuple[int, int]:
    """(words from a slot's lo table to its hi table, words a slot) of the
    staged M2's shared memory: a slot is lo, hi and 16 words of padding, so
    consecutive slots fall 16 banks apart."""
    return 16 * cb, 32 * cb + 16


def rows_adc_word(b, j):
    """Word of (byte position b, centroid j) in a staged table (csrc/
    rows_adc.cu:staged_word): rows of 16 words by byte position, rows b >= 4
    of each group of 8 swapped in pairs, centroids of bytes 8-15 flipped by 8
    (works on ints and integer tensors)."""
    return (b ^ ((b >> 2) & 1)) * 16 + (j ^ (((b >> 3) & 1) * 8))


def rows_adc_runs(pair_ids: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The staged M2's tile bookkeeping: (starts (tiles, ROWS_ADC_TILE) bool,
    where an entry starts a run of equal pair ids inside its tile; slot
    (tiles, ROWS_ADC_TILE) int64, the run's index in the tile, -1 past A).
    A tile's first entry always starts a run: a run cut by a tile boundary
    is staged once in each tile."""
    a, t = pair_ids.shape[0], ROWS_ADC_TILE
    tiles = -(-a // t)
    pad = torch.full((tiles * t,), -1, dtype=torch.int64, device=pair_ids.device)
    pad[:a] = pair_ids.long()
    p = pad.reshape(tiles, t)
    live = (torch.arange(tiles * t, device=p.device) < a).reshape(tiles, t)
    starts = live.clone()
    starts[:, 1:] &= p[:, 1:] != p[:, :-1]
    slot = torch.where(live, starts.long().cumsum(1) - 1, -1)
    return starts, slot


def rows_adc_staged_plain(codes_rows, row_ids, pair_ids, tlo, thi):
    """The staged M2's walk in PyTorch (same arguments and result as
    rows_adc): each tile stages its runs' tables into a model of its shared
    memory by rows_adc_layout, and each code looks its bytes up in its run's
    slot, summed in rows_adc's order. It holds the kernel's index arithmetic
    to rows_adc_plain where no card is."""
    cb = tlo.shape[1] // 16
    cpr = 128 // cb
    a, t = row_ids.shape[0], ROWS_ADC_TILE
    dev = codes_rows.device
    if a == 0:
        return torch.empty((0, cpr), dtype=torch.float32, device=dev)
    hi_off, slot_words = rows_adc_layout(cb)
    starts, slot = rows_adc_runs(pair_ids)
    tiles = starts.shape[0]
    smem = torch.zeros((tiles, t * slot_words), dtype=torch.float32, device=dev)
    tile_of, pos = torch.nonzero(starts, as_tuple=True)            # run starts
    p = pair_ids.long()[tile_of * t + pos]
    u = slot[tile_of, pos]
    lane = torch.arange(16 * cb, device=dev)                        # the global j*cb + b
    word = rows_adc_word(lane % cb, lane // cb)
    for off, tab in ((0, tlo), (hi_off, thi)):
        smem[tile_of[:, None], u[:, None] * slot_words + off + word[None, :]] = tab[p]
    e = torch.arange(a, device=dev)
    base = (e // t) * (t * slot_words) + slot.reshape(-1)[:a] * slot_words  # the row's slot
    byte = codes_rows[row_ids.long()].reshape(a, cpr, cb).long()           # (A, cpr, cb)
    flat = smem.reshape(-1)
    acc = torch.zeros((a, cpr), dtype=torch.float32, device=dev)
    for bb in range(cb):
        acc = acc + flat[base[:, None] + rows_adc_word(bb, byte[..., bb] & 15)]
        acc = acc + flat[base[:, None] + hi_off + rows_adc_word(bb, byte[..., bb] >> 4)]
    return acc


# ---------------------------------------------------------------- M3


# Codes one round of a direct_scan block covers (256 threads, 4 codes a
# lane), and the most rounds a block takes (direct_scan_rounds).
DIRECT_ROUND, DIRECT_MAX_ROUNDS = 1024, 4


def direct_scan_rounds(qa: int, part_pad: int, sms: int) -> int:
    """Rounds of DIRECT_ROUND codes a block of direct_scan takes: up to
    DIRECT_MAX_ROUNDS (a pair's rounds at most) where the grid then still has
    a block for each of the `sms` SMs, else 1, as at b=1, where the kernel is
    a chain of loads and more, smaller blocks spread it over the card. From
    chip_smoke.py's sweep of fixed rounds at the direct path's six shapes
    (PERF.md): 1 is fastest at both b=1 shapes, 4 from b=32 on."""
    per_pair = -(-part_pad // DIRECT_ROUND)
    rounds = min(DIRECT_MAX_ROUNDS, per_pair)
    return rounds if qa * -(-per_pair // rounds) >= sms else 1


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
    if qa and part_pad:
        ptrs = [t.data_ptr() for t in (codes, pair_part, tlo, thi, sizes, out, mins)]
        rounds = direct_scan_rounds(qa, part_pad, _sm_count(dev))
        _launch("qadc_direct_scan", dev, *ptrs, qa, part_pad, cb, rounds)
        launches["direct_scan"] += 1
    return out, mins


def _sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return _sm_count_of(device.index if device.index is not None else torch.cuda.current_device())


@functools.cache
def _sm_count_of(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def direct_scan_plain(codes, pair_part, tlo, thi, sizes):
    """Plain PyTorch version of direct_scan (same arguments and result)."""
    cb = tlo.shape[1] // 16
    pc = code_view(codes, cb)[pair_part.long()]              # (QA, part_pad, cb)
    qa, part_pad, _ = pc.shape
    d = _adc_sum(pc, tlo, thi, cb)
    col = torch.arange(part_pad, device=codes.device)
    d = torch.where(col[None, :] < sizes[:, None], d, MASK_BIG)
    return d, d.reshape(qa, part_pad // TILE, TILE).amin(dim=-1)


def direct_scan_items_plain(codes, pair_part, tlo, thi, sizes, rounds: int):
    """direct_scan's walk in PyTorch (same arguments and result as
    direct_scan_plain, bit for bit), at `rounds` rounds a block.

    Block i is item (pair i // chunks, chunk i % chunks) of rounds *
    DIRECT_ROUND codes; it stages its pair's tables transposed to [byte]
    [centroid] (entry j*cb + b of a table to word b*16 + j). Lane l of warp w
    takes codes chunk*rounds*1024 + r*1024 + w*128 + 4l .. +3 in round r,
    sums each in rows_adc's order from the staged words, writes MASK_BIG at
    or past the size, and the 8 lanes of a 32-code tile give its minimum.
    Every code of every pair must be written exactly once: the walk starts
    from NaN and fails if any is left. Used by the tests, by no search path.
    """
    cb = tlo.shape[1] // 16
    cpr = 128 // cb
    qa = pair_part.shape[0]
    part_pad = codes.shape[1] * cpr
    dev = codes.device
    chunks = -(-part_pad // (rounds * DIRECT_ROUND))
    item = torch.arange(qa * chunks, device=dev)
    pair, chunk = item // chunks, item % chunks
    # The staged words: smem[pair, tab * 16cb + b * 16 + j] = table[tab][j * cb + b].
    i = torch.arange(2 * 16 * cb, device=dev)
    tab, k = i // (16 * cb), i % (16 * cb)
    word = tab * 16 * cb + (k % cb) * 16 + k // cb
    smem = torch.empty((qa, 2 * 16 * cb), dtype=torch.float32, device=dev)
    smem[:, word] = torch.cat([tlo, thi], dim=1)[:, i]
    # Code of (item, round, warp, lane, k): (items, rounds, 8, 32, 4).
    r = torch.arange(rounds, device=dev)[:, None, None, None]
    w = torch.arange(8, device=dev)[:, None, None]
    lane = torch.arange(32, device=dev)[:, None]
    kk = torch.arange(4, device=dev)
    code = (chunk[:, None, None, None, None] * rounds * DIRECT_ROUND + r * DIRECT_ROUND
            + w * 128 + lane * 4 + kk)
    pair_of = pair[:, None, None, None, None].expand_as(code)
    keep = code < part_pad
    code, pair_of = code[keep], pair_of[keep]                      # every (pair, code) once
    byte = code_view(codes, cb)[pair_part.long()[pair_of], code].long()  # (N, cb)
    words = smem[pair_of]
    acc = torch.zeros(code.shape, dtype=torch.float32, device=dev)
    for b in range(cb):
        acc = acc + torch.gather(words, 1, (b * 16 + (byte[:, b] & 15))[:, None])[:, 0]
        acc = acc + torch.gather(words, 1, (16 * cb + b * 16 + (byte[:, b] >> 4))[:, None])[:, 0]
    d = torch.where(code < sizes[pair_of], acc, MASK_BIG)
    out = torch.full((qa, part_pad), torch.nan, dtype=torch.float32, device=dev)
    out[pair_of, code] = d
    if torch.isnan(out).any() or (pair_of * part_pad + code).unique().numel() != code.numel():
        raise AssertionError("direct_scan's walk does not write every code exactly once")
    # A tile's 8 lanes: 4 sums each, then the three xor-shuffles (any order: a minimum).
    lane_min = out.reshape(qa, part_pad // 4, 4).amin(dim=-1)
    return out, lane_min.reshape(qa, part_pad // TILE, 8).amin(dim=-1)


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
    f32, n = _check_flat_scan(codes_rows, tables, n)
    if codes_rows.device.type == "cpu":
        return flat_scan_plain(codes_rows, tables, n, with_rows)
    return _launch_flat_scan(codes_rows, tables, n, with_rows,
                             "flat_scan_f32" if f32 else "flat_scan")


def flat_scan_f32_lookup(codes_rows, tables, n: int, with_rows: bool = False):
    """flat_scan's float32 result by the row-a-thread kernel (flat_scan.cu) at
    any batch: the same arguments (float32 tables only) and the same minima
    and indices, bit for bit. flat_scan runs that kernel below
    QUERY_MINOR_MIN_QUERIES queries; this entry measures that threshold."""
    f32, n = _check_flat_scan(codes_rows, tables, n)
    if not f32:
        raise TypeError(f"tables must be torch.float32, got {tables.dtype}")
    if codes_rows.device.type == "cpu":
        return flat_scan_plain(codes_rows, tables, n, with_rows)
    return _launch_flat_scan(codes_rows, tables, n, with_rows, "flat_scan_f32_lookup")


def _check_flat_scan(codes_rows, tables, n) -> tuple[bool, int]:
    """Argument checks of flat_scan. Returns (float32 tables, n clipped)."""
    dev = codes_rows.device
    _check(codes_rows, "codes_rows", torch.uint8, 2, dev)
    f32 = getattr(tables, "dtype", None) == torch.float32
    _check(tables, "tables", torch.float32 if f32 else torch.int8, 3, dev)
    _, m, k = tables.shape
    if codes_rows.shape[1] != 128 or k != 16 or m not in (16, 32):
        raise ValueError(f"need (R, 128) codes and (Q, 16|32, 16) tables, got "
                         f"{tuple(codes_rows.shape)} and {tuple(tables.shape)}")
    return f32, max(0, min(int(n), codes_rows.shape[0] * (256 // m)))


def _launch_flat_scan(codes_rows, tables, n: int, with_rows: bool, kernel: str):
    """Launch flat_scan on checked CUDA tensors. `kernel` is its key in
    `launches`: flat_scan runs a tensor-core kernel, chosen by the batch
    (with_rows too: they take the minimum of (sum << 4) | code_in_row),
    flat_scan_f32 the query-minor kernel from QUERY_MINOR_MIN_QUERIES queries
    on and the lookup kernel below, flat_scan_f32_lookup the lookup kernel."""
    dev = codes_rows.device
    _require_cuda(dev, codes_rows, tables)
    q, m, _ = tables.shape
    r_count = codes_rows.shape[0]
    f32 = tables.dtype == torch.float32
    out = torch.empty((q, r_count), dtype=tables.dtype if f32 else torch.int32, device=dev)
    idx = torch.empty((q, r_count), dtype=torch.int32, device=dev) if with_rows else None
    if q and r_count:
        ptrs = (codes_rows.data_ptr(), tables.data_ptr(), out.data_ptr(),
                None if idx is None else idx.data_ptr())
        if kernel == "flat_scan":
            entry = "qadc_flat_scan_wgmma" if q >= WGMMA_MIN_QUERIES else "qadc_flat_scan_mma"
            _launch(entry, dev, *ptrs, r_count, q, n, m // 2)
        elif kernel == "flat_scan_f32" and q >= QUERY_MINOR_MIN_QUERIES:
            _launch("qadc_flat_scan_qm", dev, *ptrs, r_count, q, n, m // 2,
                    flat_scan_chunk(q, m))
        else:
            _launch("qadc_flat_scan", dev, *ptrs, r_count, q, n, m // 2)
        launches[kernel] += 1
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


def query_minor_chunk(q: int, query_bytes: int, least: int) -> int:
    """Queries a block of a query-minor scan stages at a batch of q: the
    power of two that covers q, at least `least` (what fills a warp's lanes)
    and at most what QUERY_MINOR_TABLE_BYTES hold at query_bytes a query."""
    cap = QUERY_MINOR_TABLE_BYTES // query_bytes
    if cap < least:
        raise ValueError(f"a table of {query_bytes} bytes a query does not fit a chunk")
    return min(cap, max(least, 1 << max(0, int(q) - 1).bit_length()))


def flat_scan_chunk(q: int, m: int) -> int:
    """query_minor_chunk of flat_scan's float tables at m sub-quantizers:
    32, 64 or (m = 16 only) 128 queries, a lane holding 1, 2 or 4 of them."""
    return query_minor_chunk(q, m * 16 * 4, QUERY_MINOR_LEAST)


def flat_scan8_chunk(q: int, m: int) -> int:
    """query_minor_chunk of flat_scan8's bf16 tables at m sub-quantizers: 8 to
    256 / m queries, a lane holding two of them."""
    return query_minor_chunk(q, m * 256 * 2, QUERY_MINOR_LEAST8)


def flat_scan_smem_bytes(m: int, chunk: int, with_rows: bool) -> int:
    """Shared memory csrc/flat_scan_qm.cuh asks for: the chunk's tables, their
    alignment slack (one sub-quantizer's entries), and two staged tiles of 32
    rows (padded to 33) of minima, and of indices with rows."""
    return 16 * chunk * 4 + m * 16 * chunk * 4 + 2 * chunk * 33 * 4 * (2 if with_rows else 1)


def flat_scan8_smem_bytes(m: int, chunk: int) -> int:
    """Shared memory csrc/flat_scan8_qm.cuh asks for: the chunk's tables, their
    alignment slack (one sub-quantizer's entries), and two staged tiles of
    4 * 64 / chunk blocks' windows (padded by one) of minima and indices."""
    tile_windows = 16 * 4 * (64 // chunk)
    return 256 * chunk * 2 + m * 256 * chunk * 2 + 2 * 2 * chunk * (tile_windows + 1) * 4


def to_query_minor(tables, chunk: int):
    """(Q, M, K) tables -> (chunks, M, K, chunk), the layout a query-minor scan
    stages in shared memory: chunk c holds queries c*chunk .., query-minor,
    zeros past Q."""
    q, m, k = tables.shape
    count = -(-q // chunk)
    out = tables.new_zeros((count * chunk, m, k))
    out[:q] = tables
    return out.reshape(count, chunk, m, k).permute(0, 2, 3, 1).contiguous()


def from_query_minor(qm, q: int):
    """The inverse of to_query_minor: (chunks, M, K, chunk) -> (q, M, K)."""
    count, m, k, chunk = qm.shape
    return qm.permute(0, 3, 1, 2).reshape(count * chunk, m, k)[:q].contiguous()


def flat_scan_query_minor_plain(codes_rows, tables, n: int, with_rows: bool = False):
    """flat_scan's float32 function by the query-minor kernel's own walk
    (csrc/flat_scan_qm.cuh): the same arguments (float32 tables) and result as
    flat_scan_plain, bit for bit.

    The tables go query-minor in flat_scan_chunk's chunks; a chunk's queries
    take a row's codes in code order, each code's sum running over b =
    0..cb-1, low nibble then high, against an entry's row of queries, and keep
    a running minimum with a strict <. Used by the tests and chip_smoke.py,
    by no search path.
    """
    q, m, _ = tables.shape
    cb = m // 2
    cpr = 128 // cb
    r_count = codes_rows.shape[0]
    n = max(0, min(int(n), r_count * cpr))
    dev = codes_rows.device
    chunk = flat_scan_chunk(q, m)
    rows = codes_rows.reshape(r_count, cpr, cb).long()
    real = n - torch.arange(r_count, device=dev) * cpr            # real codes of each row
    mins, args = [], []
    for tab in to_query_minor(tables, chunk):                     # (M, 16, chunk)
        best = torch.full((r_count, chunk), torch.inf, dtype=torch.float32, device=dev)
        arg = torch.zeros((r_count, chunk), dtype=torch.int64, device=dev)
        for c in range(cpr):
            acc = torch.zeros((r_count, chunk), dtype=torch.float32, device=dev)
            for b in range(cb):
                byte = rows[:, c, b]
                acc = acc + tab[2 * b][byte & 15]
                acc = acc + tab[2 * b + 1][byte >> 4]
            take = (c < real)[:, None] & (acc < best)             # strict: the lower code stays
            best = torch.where(take, acc, best)
            arg = torch.where(take, c, arg)
        mins.append(best.T)
        args.append(arg.T)
    empty = real <= 0
    best = torch.cat(mins)[:q].contiguous()
    if not with_rows:
        return best, None
    code = torch.arange(r_count, device=dev)[None, :] * cpr + torch.cat(args)[:q]
    return best, torch.where(empty, -1, code).to(torch.int32)


def flat_scan8_query_minor_plain(codes_rows, tables, n: int):
    """flat_scan8's function by the query-minor kernel's own walk
    (csrc/flat_scan8_qm.cuh): the same arguments and result as
    flat_scan8_plain, bit for bit.

    The tables go query-minor in flat_scan8_chunk's chunks; a chunk's queries
    take a window's 16 members in flat8_members' order, each code's sum
    running in float32 over b = 0..m-1 against an entry's row of queries, and
    keep a running minimum with a strict <. Used by the tests and
    chip_smoke.py, by no search path.
    """
    q, m, _ = tables.shape
    dev = codes_rows.device
    codes = codes_rows.reshape(-1, m).long()                      # (N_pad, m)
    n = max(0, min(int(n), codes.shape[0]))
    members = flat8_members(torch.arange(codes.shape[0] // FLAT8_WINDOW, device=dev), m)
    chunk = flat_scan8_chunk(q, m)
    mins, args = [], []
    for tab in to_query_minor(tables, chunk).to(torch.float32):   # (m, 256, chunk)
        best = torch.full((members.shape[0], chunk), torch.inf, dtype=torch.float32, device=dev)
        arg = torch.zeros((members.shape[0], chunk), dtype=torch.int64, device=dev)
        for rank in range(FLAT8_WINDOW):
            code = members[:, rank]
            acc = torch.zeros_like(best)
            for b in range(m):
                acc = acc + tab[b][codes[code, b]]
            take = (code < n)[:, None] & (acc < best)             # strict: the lower code stays
            best = torch.where(take, acc, best)
            arg = torch.where(take, code[:, None], arg)
        mins.append(best.T)
        args.append(arg.T)
    best = torch.cat(mins)[:q].contiguous()
    arg = torch.cat(args)[:q]
    return best, torch.where(torch.isinf(best), -1, arg).to(torch.int32)


def scan_onehot_plain(codes_rows, tables, n: int, with_rows: bool = False,
                      chunk_rows: int = 4096):
    """flat_scan's int8 function in the tensor-core kernel's own arithmetic
    (csrc/scan_mma.cuh): the same arguments and result as flat_scan_plain.

    Every code becomes a 0/1 one-hot column of 32*cb entries (k = 32*b +
    nibble for the low nibble of code byte b, 32*b + 16 + nibble for the
    high one); a query's (M, 16) int8 tables are one row in the same k order,
    and the sums are their product. The product runs as a float32 matmul of
    integers below 2**24, which is exact in any order and runs on every
    device, and is cast to int32. A storage row's 16 bytes at offset 16*g
    are column g of its 8-code tiles (position g*tiles + tile in the row);
    minima are taken per tile, then over the row's tiles. With rows the
    minimum is taken over (sum << 4) | position, which carries the lowest
    tied code. Used by the tests and chip_smoke.py, by no search path.
    """
    q, m, _ = tables.shape
    cb = m // 2
    cpr = 128 // cb
    tiles = cpr // 8
    r_count = codes_rows.shape[0]
    n = max(0, min(int(n), r_count * cpr))
    dev = codes_rows.device
    a = tables.reshape(q, 16 * m).to(torch.float32)                  # (Q, 32*cb)
    k0 = 32 * torch.arange(cb, device=dev)                          # k of (byte b, entry 0)
    pos = (torch.arange(8, device=dev)[:, None] * tiles
           + torch.arange(tiles, device=dev)[None, :])[None, :, :, None]  # (1, 8, tiles, 1)
    none = torch.iinfo(torch.int32).max
    out = torch.empty((q, r_count), dtype=torch.int32, device=dev)
    idx = torch.empty((q, r_count), dtype=torch.int32, device=dev) if with_rows else None
    for r0 in range(0, r_count, chunk_rows):
        byte = codes_rows[r0:r0 + chunk_rows].reshape(-1, 8, tiles, cb).long()   # (C, g, tile, b)
        c = byte.shape[0]
        onehot = torch.zeros((c, 8, tiles, 32 * cb), dtype=torch.int8, device=dev)
        onehot.scatter_(3, k0 + (byte & 15), 1)
        onehot.scatter_(3, k0 + 16 + (byte >> 4), 1)
        sums = (onehot.reshape(-1, 32 * cb).to(torch.float32) @ a.T).to(torch.int32)
        x = sums.reshape(c, 8, tiles, q)
        if with_rows:
            x = (x << 4) | pos.to(torch.int32)
        row = r0 + torch.arange(c, device=dev)
        real = (n - row * cpr)[:, None, None, None]                  # real codes of each row
        x = torch.where(pos < real, x, none)                        # padded codes
        best = x.amin(dim=1).amin(dim=1)                             # tile minima, then the row's
        empty = (row * cpr >= n)[:, None]
        if with_rows:
            idx[:, r0:r0 + c] = torch.where(empty, -1, row[:, None] * cpr + (best & 15)).T
            best = best >> 4
        out[:, r0:r0 + c] = torch.where(empty, TRIM_SENTINEL, best).T
    return out, idx


def grouped_scan_onehot_plain(codes, tables, group_part, slot_pair, group_sizes):
    """grouped_scan's int8 function by scan_onehot_plain, a group at a time
    (same arguments and result as grouped_scan_plain)."""
    out = torch.full((tables.shape[0], codes.shape[1]), TRIM_SENTINEL, dtype=torch.int32,
                     device=codes.device)
    for g, (part, size) in enumerate(zip(group_part.tolist(), group_sizes.tolist())):
        pairs = slot_pair[g]
        pairs = pairs[pairs >= 0].long()
        if pairs.numel():
            out[pairs] = scan_onehot_plain(codes[part], tables[pairs], size)[0]
    return out


# ---------------------------------------------------------------- 8, 8v, 8w, 10


def slots_to_rows(slots: torch.Tensor, block_n: int, cb: int) -> torch.Tensor:
    """Map window-scan SLOT ids to code ids (the JAX package's slots_to_rows).

    Within each block of block_n codes (R = block_n / cpr storage rows), slot
    s = c*R + r holds the code at in-block position r*cpr + c. Works on any
    integer tensor of slot ids (block-local or global).
    """
    cpr = 128 // cb
    r = block_n // cpr
    s = slots % block_n
    return slots // block_n * block_n + s % r * cpr + s // r


def window_slots(window_ids: torch.Tensor, block_n: int, window: int) -> torch.Tensor:
    """(..., window) SLOTS of each window id, ascending (the JAX package's
    window_slots): window g of a block is slots {g, g + G, 2G + g, ...},
    G = block_n / window. Map them to code ids with slots_to_rows."""
    g = block_n // window
    w = torch.arange(window, device=window_ids.device)
    return (window_ids // g * block_n)[..., None] + w * g + (window_ids % g)[..., None]


def _check_window_scan(codes_rows, tables, n, block_n: int, window: int, f32_ok: bool):
    """Argument checks of the window scans. Returns (cb, n clipped, N_pad)."""
    dev = codes_rows.device
    _check(codes_rows, "codes_rows", torch.uint8, 2, dev)
    f32 = f32_ok and getattr(tables, "dtype", None) == torch.float32
    _check(tables, "tables", torch.float32 if f32 else torch.int8, 3, dev)
    _, m, k = tables.shape
    if codes_rows.shape[1] != 128 or k != 16 or m not in (16, 32):
        raise ValueError(f"need (R, 128) codes and (Q, 16|32, 16) tables, got "
                         f"{tuple(codes_rows.shape)} and {tuple(tables.shape)}")
    cb = m // 2
    n_pad = codes_rows.shape[0] * (128 // cb)
    if block_n < 1 or n_pad % block_n != 0:
        raise ValueError(f"N_pad {n_pad} not a multiple of block_n {block_n}")
    if window < 1 or block_n % window != 0:
        raise ValueError(f"block_n {block_n} not a multiple of window {window}")
    if block_n % (128 // cb) != 0:
        raise ValueError(f"block_n {block_n} must hold whole {128 // cb}-code storage rows")
    if block_n * cb > WINDOW_SCAN_MAX_BLOCK_BYTES:
        raise ValueError(f"block_n {block_n} x {cb} code bytes exceeds the "
                         f"{WINDOW_SCAN_MAX_BLOCK_BYTES}-byte block the scan stages")
    return cb, max(0, min(int(n), n_pad)), n_pad


def flat_scan_window(codes_rows, tables, n: int, block_n: int = DEFAULT_BLOCK_N,
                     window: int = DEFAULT_WINDOW, with_rows: bool = False,
                     transpose_out: bool = False, variant: str = "int8"):
    """Flat 4-bit ADC scan to window minima at any (block_n, window): the
    whole contract of the JAX package's lut_scan_reduce.

    Args:
      codes_rows: (N_pad/cpr, 128) uint8 row128 storage, N_pad % block_n == 0.
      tables: (Q, M, 16) per-query tables, M in (16, 32): int8 (int32 sums,
        no 127 saturation), or float32 (summed over b = 0..cb-1, low nibble
        then high, as rows_adc sums).
      n: real code count; codes at or past n are padding and enter no minimum.
      block_n, window: window g of a block of block_n codes holds the codes
        of slots {g, g + G, ...} (window_slots, slots_to_rows), G = block_n /
        window; block_n % window == 0.
      with_rows: also return the code id of each minimum. Ties go to the
        lowest SLOT (the first in window_slots order), not the lowest code id.
      transpose_out: minima as (Q, N_pad/W); min-only.
      variant: one of SCAN_VARIANTS; all run the same kernel.

    Returns:
      (mins, idx): mins (N_pad/W, Q) int32 or float32, or (Q, N_pad/W) with
      transpose_out; TRIM_SENTINEL (int32) or +inf (float32) for a window
      with no real code. idx (N_pad/W, Q) int32 code ids, -1 for such a
      window; None without with_rows.

    With int8 tables it runs the warpgroup kernel over the window-major
    columns of window_column_codes (csrc/scan_wgmma.cu, at any batch: a
    partial group of 128 queries is masked); with float32 tables the
    query-minor kernel of csrc/flat_scan_window_qm.cu from
    WINDOW_QUERY_MINOR_MIN_QUERIES queries on, the lookup kernel of
    csrc/flat_scan_window.cu below.
    """
    f32, cb, n, n_pad = _check_flat_scan_window(codes_rows, tables, n, block_n, window,
                                                with_rows, transpose_out, variant)
    if codes_rows.device.type == "cpu":
        return flat_scan_window_plain(codes_rows, tables, n, block_n, window, with_rows,
                                      transpose_out)
    return _launch_flat_scan_window(codes_rows, tables, n, n_pad, cb, block_n, window,
                                    with_rows, transpose_out,
                                    "flat_scan_window_f32" if f32 else "flat_scan_window")


def flat_scan_window_f32_lookup(codes_rows, tables, n: int, block_n: int = DEFAULT_BLOCK_N,
                                window: int = DEFAULT_WINDOW, with_rows: bool = False,
                                transpose_out: bool = False, variant: str = "int8"):
    """flat_scan_window's float32 result by the lookup kernel of
    csrc/flat_scan_window.cu at any batch: the same arguments (float32 tables
    only) and the same minima and ids, bit for bit. flat_scan_window runs that
    kernel below WINDOW_QUERY_MINOR_MIN_QUERIES queries; this entry measures
    that threshold."""
    f32, cb, n, n_pad = _check_flat_scan_window(codes_rows, tables, n, block_n, window,
                                                with_rows, transpose_out, variant)
    if not f32:
        raise TypeError(f"tables must be torch.float32, got {tables.dtype}")
    if codes_rows.device.type == "cpu":
        return flat_scan_window_plain(codes_rows, tables, n, block_n, window, with_rows,
                                      transpose_out)
    return _launch_flat_scan_window(codes_rows, tables, n, n_pad, cb, block_n, window,
                                    with_rows, transpose_out, "flat_scan_window_f32_lookup")


def _check_flat_scan_window(codes_rows, tables, n, block_n, window, with_rows, transpose_out,
                            variant) -> tuple[bool, int, int, int]:
    """Argument checks of flat_scan_window. Returns (float32 tables, cb, n
    clipped, N_pad)."""
    if variant not in SCAN_VARIANTS:
        raise KeyError(variant)
    if with_rows and transpose_out:
        raise ValueError("transpose_out supports the min-only variant")
    cb, n, n_pad = _check_window_scan(codes_rows, tables, n, block_n, window, f32_ok=True)
    return tables.dtype == torch.float32, cb, n, n_pad


def _launch_flat_scan_window(codes_rows, tables, n: int, n_pad: int, cb: int, block_n: int,
                             window: int, with_rows: bool, transpose_out: bool, kernel: str):
    """Launch a window scan on checked CUDA tensors. `kernel` is its key in
    `launches`: flat_scan_window runs the warpgroup kernel of scan_wgmma.cu,
    flat_scan_window_f32 the query-minor kernel of flat_scan_window_qm.cu from
    WINDOW_QUERY_MINOR_MIN_QUERIES queries on and the lookup kernel of
    flat_scan_window.cu below, flat_scan_window_f32_lookup that lookup
    kernel."""
    dev = codes_rows.device
    _require_cuda(dev, codes_rows, tables)
    f32 = tables.dtype == torch.float32
    q, c = tables.shape[0], n_pad // window
    out = torch.empty((q, c) if transpose_out else (c, q),
                      dtype=tables.dtype if f32 else torch.int32, device=dev)
    idx = torch.empty((c, q), dtype=torch.int32, device=dev) if with_rows else None
    if q and c:
        ptrs = (codes_rows.data_ptr(), tables.data_ptr(), out.data_ptr(),
                None if idx is None else idx.data_ptr())
        if kernel == "flat_scan_window":
            _launch("qadc_flat_scan_window_wgmma", dev, *ptrs, n_pad, q, n, block_n, window, cb,
                    int(transpose_out))
        elif kernel == "flat_scan_window_f32" and q >= WINDOW_QUERY_MINOR_MIN_QUERIES:
            _launch("qadc_flat_scan_window_qm", dev, *ptrs, n_pad, q, n, block_n, window, cb,
                    flat_scan_chunk(q, 2 * cb), int(transpose_out))
        else:
            _launch("qadc_flat_scan_window", dev, *ptrs, n_pad, q, n, block_n, window, cb,
                    int(transpose_out))
        launches[kernel] += 1
    return out, idx


def flat_scan_window_plain(codes_rows, tables, n: int, block_n: int = DEFAULT_BLOCK_N,
                           window: int = DEFAULT_WINDOW, with_rows: bool = False,
                           transpose_out: bool = False):
    """Plain PyTorch version of flat_scan_window (same arguments and result)."""
    q, m, _ = tables.shape
    cb = m // 2
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
    members = slots_to_rows(window_slots(torch.arange(codes.shape[0] // window, device=dev),
                                         block_n, window), block_n, cb)    # (C, W), slot order
    best, arg = _first_min(acc[:, members], members)             # ties: the lowest slot
    empty = (members >= n).all(dim=-1)                           # no real code
    best = torch.where(empty, torch.inf if f32 else TRIM_SENTINEL, best)
    if transpose_out:
        return best.contiguous(), None
    if not with_rows:
        return best.T.contiguous(), None
    return best.T.contiguous(), torch.where(empty, -1, arg).to(torch.int32).T.contiguous()


def fast_div(x, d: int):
    """x // d for 0 <= x < 2**31 as csrc/window_columns.cuh:FastDiv computes
    it: (umulhi(x, m) + x) >> s with s = ceil(log2 d), m = 2**32 (2**s - d)
    / d + 1 (x an int or an int64 tensor)."""
    s = (d - 1).bit_length()
    m = ((1 << 32) * ((1 << s) - d)) // d + 1
    return (((x * m) >> 32) + x) >> s


def window_columns(n_pad: int, window: int) -> tuple[int, int]:
    """(lw, columns) of the window-major order: each window takes W' = 2**lw
    >= window columns, N_pad / window windows in all."""
    lw = (window - 1).bit_length()
    return lw, (n_pad // window) << lw


def window_column_codes(gc: torch.Tensor, n_pad: int, block_n: int, window: int,
                        cb: int) -> torch.Tensor:
    """Code id of each global column gc of the window-major order (csrc/
    window_columns.cuh:column_code), -1 for a dead column (rank >= window)
    or one past the last window: column gc is rank k = gc % W' of window
    w = gc // W', and for k < window it holds slot (w % G) + k*G of block
    w // G (G = block_n / window), mapped by slots_to_rows."""
    lw, total = window_columns(n_pad, window)
    groups, rows = block_n // window, block_n // (128 // cb)
    win, k = gc >> lw, gc & ((1 << lw) - 1)
    blk = fast_div(win, groups)
    slot = win - blk * groups + k * groups
    c = fast_div(slot, rows)
    code = blk * block_n + (slot - c * rows) * (128 // cb) + c
    return torch.where((gc < total) & (k < window), code, -1)


def flat_scan_window_tiles_plain(codes_rows, tables, n: int, block_n: int = DEFAULT_BLOCK_N,
                                 window: int = DEFAULT_WINDOW, with_rows: bool = False,
                                 transpose_out: bool = False, chunk_cols: int = 1 << 16):
    """flat_scan_window's int8 function by the warpgroup kernel's own walk
    (csrc/scan_wgmma.cu:flat_scan_window_wgmma_kernel): the same arguments
    (int8 tables) and result as flat_scan_window_plain, bit for bit.

    Columns run in the window-major order of window_column_codes, in tiles of
    128; a column's sum is the product of the query's tables with its code's
    one-hot (as scan_onehot_plain), its key the sum, with_rows (sum << lw) |
    rank, and INT_MAX where the column holds no real code. A window's minimum
    key is a minimum over a run of W' = 2**lw columns inside a tile, carried
    over W' / 128 consecutive tiles for W' > 128; the key's low bits give the
    rank, and window_column_codes the code id. Used by the tests and
    chip_smoke.py, by no search path.
    """
    q, m, _ = tables.shape
    cb = m // 2
    n_pad = codes_rows.shape[0] * (128 // cb)
    n = max(0, min(int(n), n_pad))
    dev = codes_rows.device
    lw, total = window_columns(n_pad, window)
    wp, c_total = 1 << lw, n_pad // window
    cols = -(-total // 128) * 128                                  # whole tiles
    a = tables.reshape(q, 16 * m).to(torch.float32)                # (Q, 32*cb)
    k0 = 32 * torch.arange(cb, device=dev)
    codes = codes_rows.reshape(-1, cb)
    none = torch.iinfo(torch.int32).max
    keys = torch.empty((q, cols), dtype=torch.int32, device=dev)
    for c0 in range(0, cols, chunk_cols):
        gc = torch.arange(c0, min(cols, c0 + chunk_cols), device=dev)
        code = window_column_codes(gc, n_pad, block_n, window, cb)
        byte = codes[code.clamp(min=0)].long()                     # (cols, cb)
        onehot = torch.zeros((gc.shape[0], 32 * cb), dtype=torch.int8, device=dev)
        onehot.scatter_(1, k0 + (byte & 15), 1)
        onehot.scatter_(1, k0 + 16 + (byte >> 4), 1)
        sums = (onehot.to(torch.float32) @ a.T).to(torch.int32).T  # (Q, cols)
        key = (sums << lw) | (gc & (wp - 1)).to(torch.int32) if with_rows else sums
        keys[:, c0:c0 + gc.shape[0]] = torch.where((code >= 0) & (code < n), key, none)
    run = min(wp, 128)
    best = keys.reshape(q, cols // run, run).amin(dim=-1)          # runs inside a tile
    best = best.reshape(q, c_total, wp // run).amin(dim=-1) if wp > 128 else best[:, :c_total]
    empty = best == none
    vals = torch.where(empty, TRIM_SENTINEL, best >> lw if with_rows else best)
    if transpose_out:
        return vals.contiguous(), None
    if not with_rows:
        return vals.T.contiguous(), None
    win = torch.arange(c_total, device=dev)
    ids = window_column_codes((win << lw)[None, :] | (best & (wp - 1)), n_pad, block_n, window, cb)
    return vals.T.contiguous(), torch.where(empty, -1, ids).to(torch.int32).T.contiguous()


def flat_scan_window_regs(codes_rows, tables, n: int, block_n: int = DEFAULT_BLOCK_N,
                          window: int = DEFAULT_WINDOW):
    """flat_scan_window's min-only int8 result by another engine: the same
    arguments (int8 tables only) and the same (N_pad/W, Q) int32 minima, bit
    for bit. Each thread keeps one query's tables in registers and looks up
    four nibbles with three byte permutes, eight windows a lane, sums in
    16-bit lanes (csrc/flat_scan_window_perm4.cu; its walk is
    flat_scan_window_planes_plain), where flat_scan_window reads shared
    memory or runs a product (the counterpart of the JAX package's
    lut_scan_vpu_reduce: an A/B instrument). Its plain version is
    flat_scan_window_plain.
    """
    cb, n, n_pad = _check_window_scan(codes_rows, tables, n, block_n, window, f32_ok=False)
    dev = codes_rows.device
    if dev.type == "cpu":
        return flat_scan_window_plain(codes_rows, tables, n, block_n, window)[0]
    _require_cuda(dev, codes_rows, tables)
    q, c = tables.shape[0], n_pad // window
    out = torch.empty((c, q), dtype=torch.int32, device=dev)
    if q and c:
        _launch("qadc_flat_scan_window_regs", dev, codes_rows.data_ptr(), tables.data_ptr(),
                out.data_ptr(), n_pad, q, n, block_n, window, cb)
        launches["flat_scan_window_regs"] += 1
    return out


def flat_scan_window_query_minor_plain(codes_rows, tables, n: int,
                                       block_n: int = DEFAULT_BLOCK_N,
                                       window: int = DEFAULT_WINDOW, with_rows: bool = False,
                                       transpose_out: bool = False):
    """flat_scan_window's float32 function by the query-minor kernel's own
    walk (csrc/flat_scan_window_qm.cu): the same arguments (float32 tables)
    and result as flat_scan_window_plain, bit for bit.

    The tables go query-minor in flat_scan_chunk's chunks; a chunk's queries
    take each window's slots in rank order (window_slots, slots_to_rows),
    each code's sum running over b = 0..cb-1, low nibble then high, against
    an entry's row of queries, and keep a running minimum with a strict <
    over the real codes and the rank of that minimum. Used by the tests and
    chip_smoke.py, by no search path.
    """
    q, m, _ = tables.shape
    cb = m // 2
    n_pad = codes_rows.shape[0] * (128 // cb)
    n = max(0, min(int(n), n_pad))
    dev = codes_rows.device
    c_total = n_pad // window
    wins = torch.arange(c_total, device=dev)
    members = slots_to_rows(window_slots(wins, block_n, window), block_n, cb)  # (C, W)
    codes = codes_rows.reshape(-1, cb).long()
    mins, args = [], []
    for tab in to_query_minor(tables, flat_scan_chunk(q, m)):   # (M, 16, chunk)
        chunk = tab.shape[-1]
        best = torch.full((c_total, chunk), torch.inf, dtype=torch.float32, device=dev)
        arg = torch.full((c_total, chunk), -1, dtype=torch.int64, device=dev)
        for k in range(window):
            code = members[:, k]
            byte = codes[code]                                    # (C, cb)
            acc = torch.zeros_like(best)
            for b in range(cb):
                acc = acc + tab[2 * b][byte[:, b] & 15]
                acc = acc + tab[2 * b + 1][byte[:, b] >> 4]
            take = (code < n)[:, None] & (acc < best)             # strict: the lower slot stays
            best = torch.where(take, acc, best)
            arg = torch.where(take, k, arg)
        mins.append(best.T)
        args.append(arg.T)
    best = torch.cat(mins)[:q].contiguous()                       # (Q, C)
    if transpose_out:
        return best, None
    if not with_rows:
        return best.T.contiguous(), None
    arg = torch.cat(args)[:q]
    ids = members[wins[None, :], arg.clamp(min=0)]
    return best.T.contiguous(), torch.where(arg < 0, -1, ids).to(torch.int32).T.contiguous()


def prmt(x, y, s):
    """PTX prmt.b32 in its default mode (csrc/flat_scan_window_perm4.cu:prmt)
    on uint32 values held in int64 tensors: byte k of the result is byte
    (s >> 4k) & 7 of the eight bytes of (y:x), or that byte's sign (0x00 or
    0xFF) where bit 4k + 3 of s is set; bits 16-31 of s are not read."""
    x, y, s = torch.broadcast_tensors(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(s))
    src = torch.stack([(x >> (8 * i)) & 0xFF for i in range(4)]
                      + [(y >> (8 * i)) & 0xFF for i in range(4)], dim=-1)
    out = torch.zeros_like(x)
    for k in range(4):
        nib = (s >> (4 * k)) & 15
        v = torch.gather(src, -1, (nib & 7)[..., None]).squeeze(-1)
        v = torch.where((nib & 8) != 0, torch.where((v & 0x80) != 0, 0xFF, 0), v)
        out = out | (v << (8 * k))
    return out


def vminu2(a, b):
    """CUDA's __vminu2: the minimum of each unsigned 16-bit lane."""
    return torch.minimum(a & 0xFFFF, b & 0xFFFF) | (torch.minimum(a >> 16, b >> 16) << 16)


def nibble_planes(codes_rows, block_n: int, cb: int):
    """(blocks, block_n/8 + 1, 2*cb) int64: the nibble planes the register
    engine stages a block as (csrc/flat_scan_window_perm4.cu:stage_planes).
    Word (j, m) holds sub-quantizer m's nibbles of slots 8j .. 8j + 7 of the
    block, slot 8j + i at bits 4i (slot s = c*R + r is the code at in-block
    position r*cpr + c); the last row is zeros."""
    codes = codes_rows.reshape(-1, block_n, cb).long()
    blocks = codes.shape[0]
    nib = torch.stack([codes & 15, codes >> 4], dim=-1).reshape(blocks, block_n, 2 * cb)
    slots = torch.arange(block_n, device=codes.device)
    by_slot = nib[:, slots_to_rows(slots, block_n, cb)]          # (blocks, slot, m)
    shift = 4 * torch.arange(8, device=codes.device)[:, None]
    words = (by_slot.reshape(blocks, block_n // 8, 8, 2 * cb) << shift).sum(dim=2)
    return torch.cat([words, words.new_zeros((blocks, 1, 2 * cb))], dim=1)


def _perm4_lookup8(tab, x):
    """The register engine's lookup8: biased sums of the 8 slots of plane
    words x (..., 2*cb) for the biased table registers tab (Q, 2*cb, 4), as
    four words of two 16-bit lanes (slots (0, 2), (1, 3), (4, 6), (5, 7)):
    (..., Q, 4) int64 holding uint32. For each half of a word: entries 0-7 by
    prmt with the nibbles as selector, 8-15 with bit 3 flipped, kept byte by
    byte by the sign-replicating prmt of (x << 4, x)."""
    x = x[..., None, :]                                           # (..., 1, 2*cb)
    acc = [0, 0, 0, 0]
    for m in range(tab.shape[1]):
        t = [tab[:, m, i] for i in range(4)]                      # (Q,) each
        xm = x[..., m]
        hi_sel = xm ^ 0x88888888
        signs = (xm << 4) & 0xFFFFFFFF
        for h, (sh, pick) in enumerate(((0, 0xD9C8), (16, 0xFBEA))):
            mask = prmt(signs, xm, pick)
            lo, hi = prmt(t[0], t[1], xm >> sh), prmt(t[2], t[3], hi_sel >> sh)
            r = (hi & mask) | (lo & ~mask & 0xFFFFFFFF)
            acc[2 * h] = (acc[2 * h] + (r & 0x00FF00FF)) & 0xFFFFFFFF
            acc[2 * h + 1] = (acc[2 * h + 1] + prmt(r, 0, 0x4341)) & 0xFFFFFFFF
    return torch.stack(acc, dim=-1)


def _lane_slots_mask(dead, shape):
    """(..., 4) words with 0xFFFF in the 16-bit lanes of the slots i (0..7)
    where dead[..., i] holds, in _perm4_lookup8's lane order."""
    mask = torch.zeros((*shape, 4), dtype=torch.int64, device=dead.device)
    for i in range(8):
        word = (i >> 2) * 2 + (i & 1)
        mask[..., word] |= torch.where(dead[..., i], 0xFFFF << (16 * ((i >> 1) & 1)), 0)
    return mask


def flat_scan_window_planes_plain(codes_rows, tables, n: int, block_n: int = DEFAULT_BLOCK_N,
                                  window: int = DEFAULT_WINDOW):
    """flat_scan_window_regs' function by its kernel's own arithmetic
    (csrc/flat_scan_window_perm4.cu): the same arguments (int8 tables) and
    (N_pad/W, Q) int32 minima as flat_scan_window_plain, bit for bit.

    The blocks are staged as nibble_planes; the table entries are biased to
    unsigned (XOR 0x80); four nibbles are looked up by three prmt calls and
    a select, and their sums kept in 16-bit lanes of 32-bit words
    (_perm4_lookup8).
    With G = block_n / W windows a block, a step is 8 slots: for G in (1, 2,
    4) the plane words in order, lane i folding into window i % G at the end;
    otherwise rank k of windows g0 .. g0 + 7 (slots kG + g0 ..), a funnel
    shift of two plane words where 8 does not divide kG + g0, lanes past the
    block's last window dead. A lane whose code is padding is 0xFFFF before
    the packed minimum (vminu2); 0xFFFF at the end is a window with no real
    code (TRIM_SENTINEL), any other lane less 128 * 2*cb is the minimum.
    Used by the tests, by no search path.
    """
    q, m, _ = tables.shape
    cb = m // 2
    cpr = 128 // cb
    n_pad = codes_rows.shape[0] * cpr
    n = max(0, min(int(n), n_pad))
    dev = codes_rows.device
    groups = block_n // window
    blocks = n_pad // block_n
    planes = nibble_planes(codes_rows, block_n, cb)               # (blocks, J + 1, 2*cb)
    tab = (tables.contiguous().view(torch.uint8).long() ^ 0x80).reshape(q, m, 4, 4)
    tab = (tab << (8 * torch.arange(4, device=dev))).sum(dim=-1)  # (Q, 2*cb, 4) registers
    real = n - torch.arange(blocks, device=dev) * block_n         # real codes of each block
    lane = torch.arange(8, device=dev)
    if groups in (1, 2, 4):
        steps = torch.arange(0, block_n, 8, device=dev)           # (S,) first slots
    else:
        g0 = torch.arange(0, groups, 8, device=dev)
        ranks = torch.arange(window, device=dev)
        steps = ranks[None, :] * groups + g0[:, None]             # (groups / 8, W)
    j, off = steps >> 3, (steps & 7) * 4
    blk = torch.arange(blocks, device=dev).reshape(-1, *([1] * steps.dim()))
    lo, hi = planes[blk, j], planes[blk, j + 1]                   # (blocks, *steps, 2*cb)
    off = off[..., None]
    x = torch.where(off > 0, ((lo >> off) | (hi << (32 - off))) & 0xFFFFFFFF, lo)
    acc = _perm4_lookup8(tab, x)                                  # (blocks, *steps, Q, 4)
    slot = steps[..., None] + lane                                # (*steps, 8)
    dead = slots_to_rows(slot, block_n, cb) >= real.reshape(-1, *([1] * slot.dim()))
    if groups not in (1, 2, 4):
        dead = dead | (g0[:, None, None] + lane >= groups)       # lanes past the last window
    acc = acc | _lane_slots_mask(dead, dead.shape[:-1])[..., None, :]
    best = acc.new_full((*acc.shape[:-3], q, 4), 0xFFFFFFFF)
    for k in range(acc.shape[-3]):                                # over steps (fold) or ranks
        best = vminu2(best, acc[..., k, :, :])
    empty, bias = 0xFFFF, 128 * m
    if groups in (1, 2, 4):
        even = vminu2(best[..., 0], best[..., 2])                 # (blocks, Q)
        odd = vminu2(best[..., 1], best[..., 3])
        if groups == 4:
            lanes = torch.stack([even & 0xFFFF, odd & 0xFFFF, even >> 16, odd >> 16], dim=1)
        else:
            e = torch.minimum(even & 0xFFFF, even >> 16)
            o = torch.minimum(odd & 0xFFFF, odd >> 16)
            lanes = torch.stack([e, o], dim=1) if groups == 2 else \
                torch.minimum(e, o)[:, None]
    else:                                                         # (blocks, groups / 8, Q, 4)
        per = torch.stack([(best[..., (i >> 2) * 2 + (i & 1)] >> (16 * ((i >> 1) & 1))) & 0xFFFF
                           for i in range(8)], dim=2)             # (blocks, groups / 8, 8, Q)
        lanes = per.reshape(blocks, -1, q)[:, :groups]
    out = torch.where(lanes == empty, TRIM_SENTINEL, lanes - bias)
    return out.reshape(blocks * groups, q).to(torch.int32)


def lut_scan_topk_int8(codes_rows, qtables, r: int, num_valid: int,
                       block_n: int = DEFAULT_BLOCK_N, window: int = DEFAULT_WINDOW):
    """Quick-ADC scan to the r best window candidates (the JAX package's
    lut_scan_topk_int8): flat_scan_window with argmin ids, then the exact
    tile screen over each query's window minima.

    Args:
      codes_rows: (N_pad/cpr, 128) uint8 row128 storage.
      qtables: (Q, M, 16) int8.
      r: results per query (at most one per window).
      num_valid: real code count. Padded codes enter no window minimum, so a
        window's real codes stay candidates (the JAX version masks a window
        whose argmin is padding, and with it the window's real codes).

    Returns:
      (vals (Q, r) float32 quantized distances ascending, +inf for absent
      slots; ids (Q, r) int32 code ids, each < num_valid where finite).
    """
    vals, rows = flat_scan_window(codes_rows, qtables, num_valid, block_n, window,
                                  with_rows=True)
    vals_t = torch.where(rows >= 0, vals.to(torch.float32), torch.inf).T
    out_v, sel = exact_tile_screen(vals_t, min(r, vals_t.shape[1]))
    return out_v, torch.gather(rows.T, 1, sel.long())


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
    return _flat_scan8(codes_rows, tables, n, "flat_scan8")


def flat_scan8_lookup(codes_rows, tables, n: int):
    """flat_scan8's result by the code-a-thread kernel (flat_scan8.cu) at any
    batch: the same arguments and the same minima and indices, bit for bit.
    flat_scan8 runs that kernel below QUERY_MINOR_MIN_QUERIES8 queries; this
    entry measures that threshold."""
    return _flat_scan8(codes_rows, tables, n, "flat_scan8_lookup")


def _flat_scan8(codes_rows, tables, n: int, kernel: str):
    """flat_scan8 by `kernel`, its key in `launches`: flat_scan8 runs the
    query-minor kernel from QUERY_MINOR_MIN_QUERIES8 queries on,
    flat_scan8_lookup (and flat_scan8 below that) the code-a-thread kernel."""
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
        args = (codes_rows.data_ptr(), tables.data_ptr(), mins.data_ptr(), idx.data_ptr(),
                n_pad // FLAT8_BLOCK, q, n, m)
        if kernel == "flat_scan8" and q >= QUERY_MINOR_MIN_QUERIES8:
            _launch("qadc_flat_scan8_qm", dev, *args, flat_scan8_chunk(q, m))
        else:
            _launch("qadc_flat_scan8", dev, *args)
        launches[kernel] += 1
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
