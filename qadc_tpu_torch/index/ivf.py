"""IVF index and Quick-ADC search (counterpart of qadc_tpu/index/ivf.py).

A query probes its `ma` nearest partitions, each with its own residual
table. Partitions are a uniform (P, part_pad/cpr, 128) row128 array, padded
by repeating each partition's last code (labels clamp to its last label).

Search paths, as in the reference:
  - direct (small batches): exact float ADC over every probed code
    (kernel M3, direct_scan), then an exact tile screen;
  - grouped: keep-prefix bound (M2, rows_adc) and int8 tables, pairs grouped
    by partition (routing), one int8 scan per group (M1, grouped_scan) to
    per-window minima, an exact window screen, and a float rerank of the
    winning windows (M2 again).
At window == cpr, the port's only window, window i of a partition is
storage row i, so the kernels read row128 storage in place and no block
size or slot permutation enters the results.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from qadc_tpu_torch.core.layout import codes_per_row
from qadc_tpu_torch.index.routing import group_capacity, route_queries
from qadc_tpu_torch.kernels.lut_scan import DISPATCH, MASK_BIG, TILE, Kernels
from qadc_tpu_torch.ops.knn import exact_knn
from qadc_tpu_torch.ops.quantization import (
    clamp_bound_to_max_distance,
    keep_prefix_bound,
    quantize_tables_int8,
)
from qadc_tpu_torch.ops.tables import adc_tables
from qadc_tpu_torch.ops.topk import exact_tile_screen, topk_smallest
from qadc_tpu_torch.quantizers.pq import ProductQuantizer


@dataclasses.dataclass(frozen=True)
class IVFIndex:
    """IVF index (the reference's fields without the TPU-only `planes`).

    Attributes:
      pq: ProductQuantizer / OPQQuantizer (trained on residuals).
      coarse_centroids: (P, dim) float32.
      codes: (P, part_pad/cpr, 128) uint8 row128 storage.
      labels: (P, part_pad) int32.
      part_sizes: (P,) int32 real sizes.
      n: total real vector count.
      max_part_size: largest real partition size.
    """

    pq: ProductQuantizer
    coarse_centroids: torch.Tensor
    codes: torch.Tensor
    labels: torch.Tensor
    part_sizes: torch.Tensor
    n: int
    max_part_size: int

    @property
    def part_count(self) -> int:
        return self.coarse_centroids.shape[0]

    @property
    def cpr(self) -> int:
        return codes_per_row(self.pq.code_size)

    @property
    def part_pad(self) -> int:
        return self.codes.shape[1] * self.cpr

    @property
    def device(self) -> torch.device:
        return self.codes.device


def assign_queries(index: IVFIndex, queries: torch.Tensor, ma: int):
    """(Q, ma) int32 nearest partitions + (Q, ma, dim) rotated residuals."""
    _, parts = exact_knn(queries, index.coarse_centroids, ma)
    residuals = queries[:, None, :] - index.coarse_centroids[parts.long()]
    q, _, dim = residuals.shape
    rot = index.pq.rotate(residuals.reshape(q * ma, dim)).reshape(q, ma, dim)
    return parts, rot


def tile_tables_rows(tables_qa3: torch.Tensor):
    """(QA, M, 16) float tables -> compact (tlo_c, thi_c), each (QA, 16*cb):
    lane j*cb + b holds table[sq 2b (lo) / 2b+1 (hi), centroid j]."""
    qa, m, k = tables_qa3.shape
    if k != 16:
        raise ValueError(f"4-bit tables have 16 centroids, got {k}")
    cb = m // 2
    tev = tables_qa3[:, 0::2, :].transpose(1, 2)    # (QA, 16, cb) even sqs
    tod = tables_qa3[:, 1::2, :].transpose(1, 2)
    return (tev.reshape(qa, 16 * cb).contiguous(),
            tod.reshape(qa, 16 * cb).contiguous())


def _quantized_tables(index: IVFIndex, queries, r: int, ma: int, keep: float,
                      prefix_pad: int, kernels: Kernels, bound_override=None):
    """Shared front half: assign, tables, keep-prefix bound, int8 quantize.

    bound_override: optional (Q,) per-query quantization bound used instead
    of the keep-prefix estimate (the prefix scan is skipped).

    Returns (parts (Q, ma) int32, tables (Q, ma, M, 16) float32, qtables
    int8 of the same shape, (tlo, thi) compact float tables for the rerank).
    """
    parts, rot = assign_queries(index, queries, ma)
    tables = adc_tables(rot, index.pq.centroids)
    m = index.pq.sq_count
    q = queries.shape[0]
    qa = q * ma
    dev = index.device
    tlo, thi = tile_tables_rows(tables.reshape(qa, m, 16))

    if bound_override is None:
        sizes = index.part_sizes[parts.long()]
        starts = torch.clamp((sizes.to(torch.float32) * keep).to(torch.int32), min=1)
        starts = torch.where(sizes > 0, starts, 0)
        cpr = index.cpr
        ppr = -(-prefix_pad // cpr)                     # prefix rows per partition
        rpp = index.codes.shape[1]
        prow = (parts.reshape(qa, 1) * rpp
                + torch.arange(ppr, dtype=torch.int32, device=dev)).reshape(qa * ppr)
        pair_of_row = torch.arange(qa, dtype=torch.int32, device=dev).repeat_interleave(ppr)
        pd = kernels.rows_adc(index.codes.reshape(-1, 128), prow, pair_of_row, tlo, thi)
        pd = pd.reshape(q, ma, ppr * cpr)
        col = torch.arange(ppr * cpr, dtype=torch.int32, device=dev)
        valid = col[None, None, :] < starts[:, :, None]
        bound = keep_prefix_bound(pd.reshape(q, -1), r, valid.reshape(q, -1))
    else:
        bound = torch.as_tensor(bound_override, dtype=torch.float32, device=dev).reshape(q)

    tables_nn = torch.clamp(tables, min=0.0)
    max_possible = tables_nn.amax(dim=-1).sum(dim=-1).amax(dim=-1)
    bound = clamp_bound_to_max_distance(bound, max_possible)
    qmin = tables_nn.amin(dim=(-3, -2, -1))
    qtables = quantize_tables_int8(
        tables, bound[:, None, None, None], qmin[:, None, None, None]
    )
    return parts, tables, qtables, (tlo, thi)


# Largest probed-code volume (qa * part_pad) routed to the direct path, and
# the probe density (pairs per probed partition) at or below which direct
# wins regardless of volume. Both are the TPU v5e crossovers of the JAX
# package, kept as they are: they have not been measured on the H100.
DIRECT_MAX_CODES = 600_000
DIRECT_MAX_DENSITY = 1.5

# Memory governor: query batches whose scan transients would exceed the
# budget run in chunks (the reference's TABLES_BUFFER_SIZE batch sizing,
# query_common.hpp:147,171-175). Floor of the device-derived budget.
SCAN_BUDGET_BYTES = 2 << 30


@functools.cache
def _default_scan_budget(device: torch.device) -> int:
    """35% of the card's memory, floored at SCAN_BUDGET_BYTES (the floor on
    the CPU)."""
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return max(SCAN_BUDGET_BYTES, int(total * 0.35))
    return SCAN_BUDGET_BYTES


def _grouped_scan_bytes(q: int, ma: int, part_count: int, part_pad: int, cb: int,
                        group_size: int, r: int, prefix_pad: int) -> int:
    """Estimated transient device bytes of one grouped search call: the
    reference's estimate (int32 window minima, per-pair gather, int8 table
    slabs) plus the rerank's and the keep-prefix bound's row and table
    reads, at the port's window (cpr)."""
    qa = q * ma
    cpr = 128 // cb
    gcap = group_capacity(q, ma, part_count, group_size)
    c = part_pad // cpr
    lanes = 16 * cb
    total = gcap * group_size * c * 4 + qa * c * 4 + 2 * gcap * lanes * group_size
    table_row = 2 * 16 * cb * 4
    a = q * min(r, ma * c)                  # selected windows (wq = r)
    total += a * (128 + cpr * 4 + table_row + cpr * 4)
    pre = qa * (-(-prefix_pad // cpr))      # prefix rows scanned
    total += pre * (128 + table_row + cpr * 4)
    return total


def _governed_query_chunk(bytes_fn, q: int, budget: int) -> int:
    """Largest power-of-two chunk <= q whose scan transients fit the budget."""
    chunk = 1 << max(0, (q - 1).bit_length())
    while chunk > 1 and bytes_fn(min(chunk, q)) > budget:
        chunk //= 2
    return min(chunk, q)


def _run_query_chunks(search_one, queries: torch.Tensor, chunk: int, bound=None):
    """Run the search over query chunks; eager, so the tail needs no padding."""
    q = queries.shape[0]
    if chunk >= q:
        return search_one(queries, bound)
    outs = [
        search_one(queries[s:s + chunk], None if bound is None else bound[s:s + chunk])
        for s in range(0, q, chunk)
    ]
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


def _search_qadc_direct_impl(index: IVFIndex, queries, r: int, ma: int,
                             kernels: Kernels):
    """Small-batch path: exact float ADC over every probed code (M3), then
    the exact tile screen, whose output is already the final ranking."""
    parts, rot = assign_queries(index, queries, ma)
    tables = adc_tables(rot, index.pq.centroids)            # (Q, ma, M, 16)
    m = index.pq.sq_count
    q = queries.shape[0]
    qa = q * ma
    part_pad = index.part_pad
    tlo, thi = tile_tables_rows(tables.reshape(qa, m, 16))
    pflat = parts.reshape(qa)
    sizes = index.part_sizes[pflat.long()]
    # Code-order distances with MASK_BIG past each size, and 32-code minima.
    d, dmins = kernels.direct_scan(index.codes, pflat, tlo, thi, sizes)
    width = ma * part_pad
    wq = min(r, width)
    sv, col = exact_tile_screen(d.reshape(q, width), wq,
                                mins=dmins.reshape(q, width // TILE))
    if r > wq:  # tiny probed volume: pad to the (Q, r) contract
        sv = F.pad(sv, (0, r - wq), value=MASK_BIG)
        col = F.pad(col, (0, r - wq))
    col = col.long()
    part_sel = torch.gather(parts.long(), 1, col // part_pad)
    fl = index.labels.reshape(-1)[part_sel * part_pad + col % part_pad]
    # Dead slots (fewer real candidates than r) return +inf and label -1.
    dead = sv >= MASK_BIG
    return (torch.where(dead, torch.inf, sv),
            torch.where(dead, -1, fl))


def _window_valid_mask(sz: torch.Tensor, c: int, cpr: int) -> torch.Tensor:
    """(QA, C) bool: window (storage row) i holds a real code, i*cpr < size."""
    rows = torch.arange(c, dtype=torch.int32, device=sz.device)
    return rows[None, :] * cpr < sz[:, None]


def _search_qadc_grouped_impl(
    index: IVFIndex, queries, r: int, ma: int, keep: float, prefix_pad: int,
    rerank: bool, group_size: int, kernels: Kernels, saturate: bool = False,
    bound=None, screen_windows: int = 0,
):
    """Partition-grouped Quick-ADC search: one int8 scan per group (M1)."""
    parts, tables, qtables, tiles = _quantized_tables(
        index, queries, r, ma, keep, prefix_pad, kernels, bound_override=bound,
    )
    q = queries.shape[0]
    m = index.pq.sq_count
    qa = q * ma
    cpr = index.cpr
    c = index.codes.shape[1]                     # windows per partition = rows

    routed = route_queries(parts, index.part_count, group_size)
    g_sz = index.part_sizes[routed.group_part.long()]
    group_rows = torch.where(routed.group_valid, (g_sz + cpr - 1) // cpr, 0)
    vals = kernels.grouped_scan(
        index.codes, qtables.reshape(qa, m, 16), routed.group_part,
        routed.slot_pairs(), group_rows.to(torch.int32),
    )                                            # (QA, C) int32
    cv = vals.to(torch.float32)
    if saturate:
        # Entries are >= 0, so the window min of saturating sums == min(., 127).
        cv = torch.clamp(cv, max=127.0)
    sz = index.part_sizes[parts.reshape(qa).long()]
    cv = torch.where(_window_valid_mask(sz, c, cpr), cv, torch.inf)

    # Exact screen of the query's ma*C windows: with wq >= r windows by true
    # window minimum, every top-r code's window is provably kept.
    wq = min(screen_windows or r, ma * c)
    screen_v, selq = exact_tile_screen(cv.reshape(q, ma * c), wq)
    selq = selq.long()
    sel_ai = selq // c
    sel_wi = selq % c
    sel_pair = torch.arange(q, device=index.device)[:, None] * ma + sel_ai
    sel_part = torch.gather(parts.long(), 1, sel_ai)
    sel_sz = torch.gather(sz.reshape(q, ma), 1, sel_ai)

    tw_src = tables if rerank else qtables.to(torch.float32)
    return window_rerank(
        index, tw_src, screen_v, sel_part, sel_pair, sel_wi, sel_sz, r, kernels,
        tiles=tiles if rerank else None, clamp127=saturate and not rerank,
    )


def window_rerank(
    index: IVFIndex, tables_qa, screen_v, sel_part, sel_pair, sel_wi, sel_sz,
    r: int, kernels: Kernels, tiles=None, clamp127: bool = False,
):
    """Expand the winning windows (storage rows) to their codes and rank them
    by exact float distance (M2 over the selected rows).

    Args:
      tables_qa: (Q, ma, M, 16) float tables to rank with (float tables, or
        the int8 tables as float for reference-style ranking).
      screen_v: (Q, wq) screened window minima (inf = dead window).
      sel_part/sel_pair/sel_wi/sel_sz: (Q, wq) selected windows' partition,
        flat pair id (q*ma + a), window (= row) id and partition size.
      tiles: optional (tlo, thi) compact tables already built from tables_qa.

    Returns (dists (Q, r), labels (Q, r)).
    """
    q, wq = screen_v.shape
    m = tables_qa.shape[2]
    cpr = index.cpr
    a = q * wq
    rpp = index.codes.shape[1]
    grow = sel_part.reshape(a) * rpp + sel_wi.reshape(a)
    lab = index.labels.reshape(-1, cpr)[grow]                      # (A, cpr)
    if tiles is None:
        tiles = tile_tables_rows(tables_qa.reshape(-1, m, 16))
    tlo, thi = tiles
    cvf = kernels.rows_adc(index.codes.reshape(-1, 128), grow.to(torch.int32),
                           sel_pair.reshape(a).to(torch.int32), tlo, thi)
    if clamp127:
        # Saturating-int8 reference semantics: entries >= 0, so min(sum, 127).
        cvf = torch.clamp(cvf, max=127.0)
    c_iota = torch.arange(cpr, device=index.device)
    alive = (
        (sel_wi.reshape(a)[:, None] * cpr + c_iota[None, :]) < sel_sz.reshape(a)[:, None]
    ) & torch.isfinite(screen_v).reshape(a)[:, None]
    cvf = torch.where(alive, cvf, torch.inf).reshape(q, wq * cpr)
    labq = lab.reshape(q, wq * cpr)
    if r > wq * cpr:  # tiny probed volume: pad to the (Q, r) contract
        cvf = F.pad(cvf, (0, r - wq * cpr), value=torch.inf)
        labq = F.pad(labq, (0, r - wq * cpr))
    return topk_smallest(cvf, labq, r)


def search_qadc(
    index: IVFIndex, queries, r: int = 100, ma: int = 1, keep: float = 0.01,
    rerank: bool = True, grouped: bool | None = None, group_size: int = 128,
    saturate: bool = False, direct: bool | None = None,
    scan_budget_bytes: int | None = None, bound=None, screen_windows: int = 0,
    kernels: Kernels = DISPATCH,
):
    """Quick-ADC IVF search (reference: db_query_4.cpp; requires sq_bits == 4).

    The arguments are the JAX package's (ivf.search_qadc), less the TPU
    knobs: windows are always whole storage rows (grouped_window = cpr), so
    block_n does not exist here, and nothing is autotuned.

    rerank: float-rerank the int8-screened windows (default); False ranks by
      quantized distance, as the reference does.
    grouped / direct: force a path. By default a CUDA index takes the direct
      path for small probed volumes (DIRECT_MAX_CODES, DIRECT_MAX_DENSITY)
      with rerank on and saturate off, and the grouped path otherwise; a CPU
      index always takes the grouped path (the JAX package's per-probe CPU
      path is not ported). grouped=False without direct raises.
    saturate: reproduce the reference's saturating int8 sums (min(sum, 127)).
    scan_budget_bytes: memory governor budget (default: 35% of the card's
      memory, at least SCAN_BUDGET_BYTES); larger batches run in chunks.
    bound: optional (Q,) float per-query bound for the int8 quantization,
      replacing the keep-prefix estimate (grouped path only).
    screen_windows: override the grouped screen width wq (default r).
    kernels: the kernel set (lut_scan.DISPATCH; lut_scan.PLAIN runs the
      plain versions on any device, for comparisons on the card).

    Returns (dists (Q, r) float32, labels (Q, r) int32).
    """
    if index.pq.sq_bits != 4:
        raise ValueError("Quick ADC requires sq_bits == 4")
    dev = index.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    q = queries.shape[0]
    ma = min(ma, index.part_count)
    geometry_ok = index.pq.sq_count in (16, 32) and index.part_pad % 512 == 0
    budget = _default_scan_budget(dev) if scan_budget_bytes is None else scan_budget_bytes
    if direct is None:
        qa = q * ma
        density = qa / max(1, min(index.part_count, qa))
        direct = (
            dev.type == "cuda" and rerank and not saturate and geometry_ok
            and (qa * index.part_pad <= DIRECT_MAX_CODES
                 or density <= DIRECT_MAX_DENSITY)
        )
    if direct:
        # Dominant transient: the (q, ma*part_pad) distances plus screen
        # intermediates, ~9 bytes per probed code.
        chunk = _governed_query_chunk(lambda qc: qc * ma * index.part_pad * 9, q, budget)
        return _run_query_chunks(
            lambda qs, _: _search_qadc_direct_impl(index, qs, r, ma, kernels),
            queries, chunk,
        )
    if grouped is None:
        grouped = geometry_ok
    if not grouped:
        raise NotImplementedError(
            "only the grouped and direct paths are ported (sq_count 16 or 32, "
            "part_pad a multiple of 512)"
        )
    prefix_pad = max(1, int(index.max_part_size * keep)) if index.max_part_size else 1
    prefix_pad = min(prefix_pad, index.part_pad)
    chunk = _governed_query_chunk(
        lambda qc: _grouped_scan_bytes(
            qc, ma, index.part_count, index.part_pad, index.pq.code_size,
            group_size, r, prefix_pad,
        ),
        q, budget,
    )
    if bound is not None:
        bound = torch.as_tensor(bound, dtype=torch.float32, device=dev)
    return _run_query_chunks(
        lambda qs, bd: _search_qadc_grouped_impl(
            index, qs, r, ma, keep, prefix_pad, rerank, group_size, kernels,
            saturate=saturate, bound=bd, screen_windows=screen_windows,
        ),
        queries, chunk, bound,
    )
