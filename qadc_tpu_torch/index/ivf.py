"""IVF index and search (counterpart of qadc_tpu/index/ivf.py).

A query probes its `ma` nearest partitions, each with its own residual
table. Partitions are a uniform (P, part_pad/cpr, 128) row128 array, padded
by repeating each partition's last code (labels clamp to its last label).

Quick-ADC search (search_qadc, 4-bit codes, int8 tables), as in the
reference:
  - direct (small batches): exact float ADC over every probed code
    (kernel M3, direct_scan), then an exact tile screen;
  - grouped: keep-prefix bound (M2, rows_adc) and int8 tables, pairs grouped
    by partition (routing), one int8 scan per group (M1, grouped_scan) to
    per-window minima, an exact window screen, and a float rerank of the
    winning windows (M2 again);
  - per probe (grouped=False): an int8 scan of each probed partition, top-2r
    and a float rerank per probe, merged.
Conventional ADC search (search_adc, 4/8/16-bit codes, float tables):
  - 4-bit grouped: M1 with float tables, an exact screen of r windows and the
    exact float rerank (M2): the screen's minima are the rerank's distances;
  - 8-bit grouped: grouped_scan8 with bf16 tables, a screen of
    r + max(16, r // 8) windows, every member of the winning windows
    reranked with exact float32 table gathers;
  - 16-bit grouped: each probed partition decoded once per group, distances
    by a float32 GEMM, window minima, and a reconstruction rerank;
  - per probe (grouped=False): exact ADC of every probed code, merged.
At window == cpr (4-bit), window i of a partition is storage row i, so the
kernels read row128 storage in place and no block size or slot permutation
enters the results. Padded codes never enter a window minimum.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import torch
import torch.nn.functional as F

from qadc_tpu_torch import autotune
from qadc_tpu_torch.core.layout import code_view, codes_per_row
from qadc_tpu_torch.core.packing import gather_codes_row128, unpack_codes
from qadc_tpu_torch.core.tensors import (DEFAULT_DEVICE, as_f32, as_generator,
                                         full_f32_matmul, to_f32)
from qadc_tpu_torch.index.routing import group_capacity, route_queries
from qadc_tpu_torch.kernels.lut_scan import (
    DISPATCH,
    MASK_BIG,
    SCAN8_SQ_COUNTS,
    TILE,
    Kernels,
    scan8_windows,
)
from qadc_tpu_torch.ops.kmeans import balance_centroids, kmeans
from qadc_tpu_torch.ops.knn import exact_knn
from qadc_tpu_torch.ops.quantization import int8_tables, keep_prefix_bound
from qadc_tpu_torch.ops.tables import adc_tables
from qadc_tpu_torch.ops.topk import exact_tile_screen, merge_topk, topk_smallest
from qadc_tpu_torch.quantizers.pq import ProductQuantizer, decode_rows


# Partition padding granularity in codes (qadc_tpu/index/ivf.py:PART_ALIGN).
PART_ALIGN = 512


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

    @classmethod
    def create(cls, pq: ProductQuantizer, coarse_centroids) -> "IVFIndex":
        """Empty index on the quantizer's device: PART_ALIGN zero codes a
        partition, n = 0."""
        dev = pq.centroids.device
        cc = to_f32(coarse_centroids, dev)
        p = cc.shape[0]
        return cls(
            pq=pq, coarse_centroids=cc,
            codes=torch.zeros((p, PART_ALIGN // codes_per_row(pq.code_size), 128),
                              dtype=torch.uint8, device=dev),
            labels=torch.zeros((p, PART_ALIGN), dtype=torch.int32, device=dev),
            part_sizes=torch.zeros((p,), dtype=torch.int32, device=dev),
            n=0, max_part_size=0)

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


def set_quantizer(index: IVFIndex, pq: ProductQuantizer) -> IVFIndex:
    """Install an (externally trained) quantizer into an EMPTY IVF index.

    Codes already present were encoded with the old quantizer and would be
    misread, so a non-empty index is rejected: swap first, then add vectors.
    """
    dim = index.coarse_centroids.shape[1]
    if pq.dim != dim:
        raise ValueError(f"quantizer dim {pq.dim} != index dim {dim}")
    if index.n != 0:
        raise ValueError(f"cannot swap quantizer into a non-empty index (n={index.n}): "
                         "existing codes were encoded with the old quantizer")
    return IVFIndex.create(pq, index.coarse_centroids)


def keep_for_init(init: int, part_count: int, ma: int, n: int) -> float:
    """The paper's `init` (codes scanned exactly per query) as a keep
    fraction: keep = (init * K) / (ma * N)."""
    if min(init, part_count, ma, n) <= 0:
        raise ValueError("all of init, part_count, ma, n must be positive")
    return (init * part_count) / (ma * n)


def train_coarse(generator, learn_vectors, part_count: int, iters: int = 50,
                 balance_cap: float | None = None, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Learn the coarse quantizer: k-means++ and `iters` Lloyd iterations.

    generator: torch.Generator on the data's device, or an int seed.
    learn_vectors: (N, dim); a tensor stays on its device, numpy goes to
      `device`.
    balance_cap: optional ratio: bound the largest cell at balance_cap x the
      mean cell size by splitting oversized cells (part_count unchanged;
      ops/kmeans.balance_centroids). Every partition is padded to the
      largest, so unbounded cell skew inflates the whole index; 3.0 suits
      clustered data, None keeps plain Lloyd.

    Returns (part_count, dim) float32 centroids.
    """
    x = as_f32(learn_vectors, device)
    gen = as_generator(generator, x.device)
    centroids, _ = kmeans(gen, x, part_count, iters)
    if balance_cap is not None:
        centroids, _ = balance_centroids(gen, x, centroids, cap_ratio=balance_cap)
    return centroids


def compute_residuals(index: IVFIndex, vectors, assignments) -> torch.Tensor:
    """residual = vector - coarse_centroid[assignment], on the index's device."""
    dev = index.device
    assignments = torch.as_tensor(assignments, device=dev).long()
    return to_f32(vectors, dev) - index.coarse_centroids[assignments]


def add(index: IVFIndex, vectors, encode_batch: int = 262144) -> IVFIndex:
    """Assign -> residual -> encode -> scatter into partitions: a one-shot
    wrapper over index/build.IVFBuilder. For streamed ingest use the builder
    directly, so that buffers append in place and padding happens once."""
    from qadc_tpu_torch.index.build import IVFBuilder

    b = IVFBuilder.from_index(index)
    b.add(vectors, encode_batch=encode_batch)
    return b.finalize()


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


def rows_adc(rows: torch.Tensor, tlo_c: torch.Tensor, thi_c: torch.Tensor,
             cb: int) -> torch.Tensor:
    """Exact float ADC distances of whole row128 storage rows, each row with
    its own compact tables.

    Args:
      rows: (A, 128) uint8 packed 4-bit codes, cpr = 128 / cb a row.
      tlo_c, thi_c: (A, 16*cb) float32 compact tables of each row
        (tile_tables_rows, gathered to row granularity).
      cb: code bytes.

    Returns:
      (A, cpr) float32, one distance a code, summed in float32 over
      b = 0..cb-1, low nibble then high.

    This is M2 (kernels.rows_adc) with row i scored against table row i: the
    rows are its whole storage and the ids are the identity, so nothing is
    copied (a non-contiguous argument is made contiguous first). On the CPU
    M2's plain version runs.
    """
    if tlo_c.shape[-1] != 16 * cb or thi_c.shape != tlo_c.shape:
        raise ValueError(f"compact tables must be (A, {16 * cb}), got {tuple(tlo_c.shape)}")
    ids = torch.arange(rows.shape[0], dtype=torch.int32, device=rows.device)
    return DISPATCH.rows_adc(rows.contiguous(), ids, ids, tlo_c.contiguous(),
                             thi_c.contiguous())


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
    tiles = tile_tables_rows(tables.reshape(q * ma, m, 16))
    if bound_override is None:
        pd, valid = prefix_distances(index.codes, parts, index.part_sizes[parts.long()], keep,
                                     prefix_pad, tiles, kernels)
        bound = keep_prefix_bound(pd.reshape(q, -1), r, valid.reshape(q, -1))
    else:
        bound = torch.as_tensor(bound_override, dtype=torch.float32, device=index.device)
    return parts, tables, int8_tables(tables, bound.reshape(q)), tiles


def prefix_distances(codes, parts, sizes, keep: float, prefix_pad: int, tiles,
                     kernels: Kernels):
    """Keep-prefix distances: the first prefix_pad codes of each probed
    partition, scored by M2 (rows_adc) over their storage rows.

    codes: (P, rpp, 128) storage; parts: (Q, ma) partitions of `codes`;
    sizes: (Q, ma) their real sizes (0 leaves a pair out); tiles: the
    pairs' compact tables. Returns (dists (Q, ma, cols), valid (Q, ma,
    cols)): code j of a pair counts when j < max(1, size * keep), size > 0.
    """
    q, ma = parts.shape
    qa = q * ma
    dev = codes.device
    rpp = codes.shape[1]
    cpr = 128 // (tiles[0].shape[1] // 16)        # tiles are 16 * cb lanes wide
    starts = torch.clamp((sizes.to(torch.float32) * keep).to(torch.int32), min=1)
    starts = torch.where(sizes > 0, starts, 0)
    ppr = -(-prefix_pad // cpr)                     # prefix rows per partition
    prow = (parts.reshape(qa, 1) * rpp
            + torch.arange(ppr, dtype=torch.int32, device=dev)).reshape(qa * ppr)
    pair_of_row = torch.arange(qa, dtype=torch.int32, device=dev).repeat_interleave(ppr)
    pd = kernels.rows_adc(codes.reshape(-1, 128), prow, pair_of_row, *tiles)
    col = torch.arange(ppr * cpr, dtype=torch.int32, device=dev)
    return pd.reshape(q, ma, ppr * cpr), col[None, None, :] < starts[:, :, None]


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
    the CPU). QADC_SCAN_BUDGET_BYTES, where set, overrides both. Read once
    a device and cached (the flat index's default goes through here too)."""
    env = os.environ.get("QADC_SCAN_BUDGET_BYTES")
    if env:
        return int(env)
    if device.type == "cuda":
        _, total = torch.cuda.mem_get_info(device)
        return max(SCAN_BUDGET_BYTES, int(total * 0.35))
    return SCAN_BUDGET_BYTES


def _grouped_scan_bytes(
    q: int, ma: int, part_count: int, part_pad: int, window: int,
    group_size: int, lanes: int, val_bytes: int, slab_bytes: int,
    n_streams: int, r: int = 0, cb: int = 0, prefix_pad: int = 0,
) -> int:
    """Estimated transient device bytes of one grouped scan call: the
    reference's estimate (ivf.py:_grouped_scan_bytes) of the window-minimum
    streams, their per-pair gather and the group table slabs, plus, with r
    and cb set, the rerank's reads per selected window (a code row, a label
    row, two compact tables, the distances) and, with prefix_pad, the
    keep-prefix bound's."""
    qa = q * ma
    gcap = group_capacity(q, ma, part_count, group_size)
    c = part_pad // window
    total = (gcap * group_size * c * val_bytes * n_streams      # window minima
             + qa * c * 4 * n_streams                           # per-pair gather
             + 2 * gcap * lanes * group_size * slab_bytes)      # table slabs
    if r and cb:
        cpr = 128 // cb
        table_row = 2 * 16 * cb * 4
        a = q * min(r, ma * c)                  # selected windows (wq = r)
        total += a * (128 + cpr * 4 + table_row + cpr * 4)
        if prefix_pad:
            pre = qa * (-(-prefix_pad // cpr))  # prefix rows scanned
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


def _group_sizes(index: IVFIndex, routed) -> torch.Tensor:
    """(gcap,) int32 real code count of each group's partition (0 if unused)."""
    g_sz = index.part_sizes[routed.group_part.long()]
    return torch.where(routed.group_valid, g_sz, 0).to(torch.int32)


def _screen(cv: torch.Tensor, parts: torch.Tensor, sz: torch.Tensor, wq: int):
    """Exact screen of each query's ma*C windows down to wq.

    cv: (QA, C) window minima (inf = dead); parts: (Q, ma); sz: (QA,) sizes.
    Returns (screen_v, sel_pair, sel_part, sel_wi, sel_sz), each (Q, wq):
    the screened minima and each selected window's flat pair id (q*ma + a),
    partition, window id and partition size.
    """
    q, ma = parts.shape
    c = cv.shape[1]
    screen_v, selq = exact_tile_screen(cv.reshape(q, ma * c), wq)
    selq = selq.long()
    sel_ai = selq // c
    sel_pair = torch.arange(q, device=cv.device)[:, None] * ma + sel_ai
    sel_part = torch.gather(parts.long(), 1, sel_ai)
    sel_sz = torch.gather(sz.reshape(q, ma), 1, sel_ai)
    return screen_v, sel_pair, sel_part, selq % c, sel_sz


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
    c = index.codes.shape[1]                     # windows per partition = rows

    routed = route_queries(parts, index.part_count, group_size)
    vals = kernels.grouped_scan(
        index.codes, qtables.reshape(qa, m, 16), routed.group_part,
        routed.slot_pairs(), _group_sizes(index, routed),
    )                                            # (QA, C) int32
    cv = vals.to(torch.float32)
    if saturate:
        # Entries are >= 0, so the window min of saturating sums == min(., 127).
        cv = torch.clamp(cv, max=127.0)
    sz = index.part_sizes[parts.reshape(qa).long()]
    cv = torch.where(_window_valid_mask(sz, c, index.cpr), cv, torch.inf)

    # Exact screen of the query's ma*C windows: with wq >= r windows by true
    # window minimum, every top-r code's window is provably kept.
    screen_v, sel_pair, sel_part, sel_wi, sel_sz = _screen(
        cv, parts, sz, min(screen_windows or r, ma * c))
    tw_src = tables if rerank else qtables.to(torch.float32)
    return window_rerank(
        index.codes, index.labels, tw_src, screen_v, sel_part, sel_pair, sel_wi, sel_sz,
        r, kernels, tiles=tiles if rerank else None, clamp127=saturate and not rerank,
    )


def window_rerank(
    codes, labels, tables_qa, screen_v, sel_part, sel_pair, sel_wi, sel_sz,
    r: int, kernels: Kernels, tiles=None, clamp127: bool = False,
):
    """Expand the winning windows (storage rows) to their codes and rank them
    by exact float distance (M2 over the selected rows).

    Args:
      codes: (P, rpp, 128) uint8 row128 storage (the flat index: P = 1).
      labels: (P, part_pad) int32 labels of the codes.
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
    rpp = codes.shape[1]
    cpr = labels.shape[1] // rpp
    a = q * wq
    grow = sel_part.reshape(a) * rpp + sel_wi.reshape(a)
    lab = labels.reshape(-1, cpr)[grow]                            # (A, cpr)
    if tiles is None:
        tiles = tile_tables_rows(tables_qa.reshape(-1, m, 16))
    tlo, thi = tiles
    cvf = kernels.rows_adc(codes.reshape(-1, 128), grow.to(torch.int32),
                           sel_pair.reshape(a).to(torch.int32), tlo, thi)
    if clamp127:
        # Saturating-int8 reference semantics: entries >= 0, so min(sum, 127).
        cvf = torch.clamp(cvf, max=127.0)
    c_iota = torch.arange(cpr, device=codes.device)
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
    rerank: bool = True, grouped: bool | None = None, group_size: int | None = None,
    saturate: bool = False, direct: bool | None = None,
    scan_budget_bytes: int | None = None, bound=None, screen_windows: int = 0,
    kernels: Kernels = DISPATCH,
):
    """Quick-ADC IVF search (reference: db_query_4.cpp; requires sq_bits == 4).

    The arguments are the JAX package's (ivf.search_qadc), less the TPU
    knobs: windows are always whole storage rows (grouped_window = cpr), so
    block_n does not exist here.

    rerank: float-rerank the int8-screened windows (default); False ranks by
      quantized distance, as the reference does.
    grouped / direct: force a path. By default a CUDA index takes the direct
      path for small probed volumes (DIRECT_MAX_CODES, DIRECT_MAX_DENSITY)
      with rerank on and saturate off, and the grouped path otherwise (a CPU
      index: always grouped) when the geometry allows (sq_count 16 or 32,
      part_pad a multiple of 512). grouped=False, or another geometry, takes
      the per-probe path (_search_qadc_impl), the JAX package's CPU path.
    group_size: pairs a grouped scan serves together (index/routing.py).
      None takes the pick autotune recorded for this geometry and batch
      bucket (tuning first under QADC_AUTOTUNE=1), else
      autotune.DEFAULT_GROUP_SIZE; the results do not depend on it.
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
    if grouped and group_size is None:
        pick = autotune.lookup(autotune.geometry_key(index, "ivf_qadc_grouped", q))
        if not pick and autotune.enabled():
            pick = autotune.tune_ivf_qadc(index, queries, r=r, ma=ma, keep=keep)
        group_size = pick.get("group_size", autotune.DEFAULT_GROUP_SIZE)
    if group_size is not None and group_size < 1:
        raise ValueError(f"group_size must be >= 1, got {group_size}")
    prefix_pad = max(1, int(index.max_part_size * keep)) if index.max_part_size else 1
    prefix_pad = min(prefix_pad, index.part_pad)
    if bound is not None:
        bound = torch.as_tensor(bound, dtype=torch.float32, device=dev)
    if not grouped:
        return _search_qadc_impl(index, queries, r, ma, keep, prefix_pad, rerank,
                                 kernels, saturate=saturate, bound=bound)
    chunk = _governed_query_chunk(
        lambda qc: _grouped_scan_bytes(
            qc, ma, index.part_count, index.part_pad, index.cpr, group_size,
            lanes=16 * index.pq.code_size, val_bytes=4, slab_bytes=1, n_streams=1,
            r=r, cb=index.pq.code_size, prefix_pad=prefix_pad,
        ),
        q, budget,
    )
    return _run_query_chunks(
        lambda qs, bd: _search_qadc_grouped_impl(
            index, qs, r, ma, keep, prefix_pad, rerank, group_size, kernels,
            saturate=saturate, bound=bd, screen_windows=screen_windows,
        ),
        queries, chunk, bound,
    )


# ------------------------------------------------------- per-probe paths


def _table_sum(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(N, M, K) tables, (N, S, M) centroid ids -> (N, S) sums over m, in
    the order m = 0..M-1 (in the tables' dtype)."""
    acc = torch.zeros(idx.shape[:2], dtype=tab.dtype, device=tab.device)
    for mm in range(idx.shape[-1]):
        acc = acc + torch.gather(tab[:, mm], 1, idx[..., mm])
    return acc


def _search_qadc_impl(index: IVFIndex, queries, r: int, ma: int, keep: float,
                      prefix_pad: int, rerank: bool, kernels: Kernels,
                      saturate: bool = False, bound=None):
    """Per-probe Quick-ADC search (the reference's CPU path): an int8 scan of
    each probed partition, its top 2r (r without rerank) re-scored with the
    float tables, merged into the running top-r."""
    parts, tables, qtables, _ = _quantized_tables(
        index, queries, r, ma, keep, prefix_pad, kernels, bound_override=bound)
    q = queries.shape[0]
    part_pad = index.part_pad
    sizes = index.part_sizes[parts.long()]                   # (Q, ma)
    pcodes = code_view(index.codes, index.pq.code_size)
    rr = min(2 * r if rerank else r, part_pad)
    col = torch.arange(part_pad, device=index.device)
    best_v = torch.full((q, r), torch.inf, device=index.device)
    best_l = torch.zeros((q, r), dtype=torch.int32, device=index.device)
    for a in range(ma):
        pids = parts[:, a].long()
        idx = unpack_codes(pcodes[pids]).long()              # (Q, part_pad, M)
        acc = _table_sum(qtables[:, a].to(torch.int32), idx)  # unsaturated int32
        if saturate:
            # Entries are >= 0, so the saturating sum == min(sum, 127).
            acc = torch.clamp(acc, max=127)
        d = torch.where(col < sizes[:, a:a + 1], acc.to(torch.float32), torch.inf)
        top, rows = torch.sort(d, dim=-1, stable=True)       # ties: lower code
        top, rows = top[:, :rr], rows[:, :rr]
        cl = torch.gather(index.labels[pids], 1, rows)
        if rerank:
            cidx = torch.gather(idx, 1, rows[..., None].expand(-1, -1, idx.shape[-1]))
            cv = torch.where(torch.isfinite(top), _table_sum(tables[:, a], cidx), torch.inf)
        else:
            cv = top
        best_v, best_l = merge_topk(best_v, best_l, cv, cl, r)
    return best_v, best_l


def _search_adc_probe_impl(index: IVFIndex, queries, r: int, ma: int):
    """Per-probe exact ADC search at 4, 8 or 16 bits (the reference's
    _search_adc_jnp_impl): every code of each probed partition is scored and
    merged into the running top-r. 16-bit codes are scored as the squared
    distance to their reconstruction."""
    parts, rot = assign_queries(index, queries, ma)
    pq = index.pq
    wide = pq.sq_bits == 16
    if not wide:
        tables = adc_tables(rot, pq.centroids)               # (Q, ma, M, K)
    q = queries.shape[0]
    part_pad = index.part_pad
    sizes = index.part_sizes[parts.long()]
    pcodes = code_view(index.codes, pq.code_size)
    col = torch.arange(part_pad, device=index.device)
    best_v = torch.full((q, r), torch.inf, device=index.device)
    best_l = torch.zeros((q, r), dtype=torch.int32, device=index.device)
    for a in range(ma):
        pids = parts[:, a].long()
        idx = unpack_codes(pcodes[pids], pq.sq_count, pq.sq_bits).long()
        if wide:
            dec = decode_rows(pq, idx)                       # (Q, part_pad, dim)
            ra = rot[:, a]
            with full_f32_matmul():
                cross = torch.bmm(dec, ra[:, :, None])[..., 0]
            d = (ra * ra).sum(-1)[:, None] + (dec * dec).sum(-1) - 2.0 * cross
        else:
            d = _table_sum(tables[:, a], idx)
        # Padded codes repeat the last one: masked, or they would flood.
        d = torch.where(col < sizes[:, a:a + 1], d, torch.inf)
        cv, cl = topk_smallest(d, index.labels[pids], min(r, part_pad))
        best_v, best_l = merge_topk(best_v, best_l, cv, cl, r)
    return best_v, best_l


# ------------------------------------------------------- grouped ADC paths


def _search_adc4_grouped_impl(index: IVFIndex, queries, r: int, ma: int,
                              group_size: int, kernels: Kernels):
    """4-bit conventional ADC: M1 with float32 tables, an exact screen of r
    windows and the exact float rerank of their codes (M2).

    wq = r is lossless here: M1 sums each code in rows_adc's order, so a
    window's minimum is bit for bit the rerank's distance of one of its real
    codes, and the top-r codes lie in at most r windows, each of whose
    minimum is at most the r-th distance.
    """
    parts, rot = assign_queries(index, queries, ma)
    tables = adc_tables(rot, index.pq.centroids)             # (Q, ma, M, 16)
    q = queries.shape[0]
    m = index.pq.sq_count
    qa = q * ma
    c = index.codes.shape[1]                                 # windows = rows
    routed = route_queries(parts, index.part_count, group_size)
    cv = kernels.grouped_scan(
        index.codes, tables.reshape(qa, m, 16), routed.group_part,
        routed.slot_pairs(), _group_sizes(index, routed),
    )                                                        # (QA, C) f32, inf trimmed
    sz = index.part_sizes[parts.reshape(qa).long()]
    screen_v, sel_pair, sel_part, sel_wi, sel_sz = _screen(cv, parts, sz, min(r, ma * c))
    return window_rerank(index.codes, index.labels, tables, screen_v, sel_part, sel_pair,
                         sel_wi, sel_sz, r, kernels)


def _expand_windows(index: IVFIndex, screen_v, sel_part, sel_sz, first, stride: int,
                    window: int):
    """Every member of the selected windows: member k of a window is code
    first + k*stride of its partition.

    Returns (code ids (Q, wq*window) global, labels, alive mask): a member is
    alive when it is a real code of a live (finite) window.
    """
    q, wq = screen_v.shape
    local = first[..., None] + torch.arange(window, device=first.device) * stride
    alive = (local < sel_sz[..., None]) & torch.isfinite(screen_v)[..., None]
    cand = (sel_part[..., None] * index.part_pad + local).reshape(q, wq * window)
    return cand, index.labels.reshape(-1)[cand], alive.reshape(q, wq * window)


def _rank_candidates(fd, labels, alive, r: int):
    """Top-r of the candidates by exact distance; padded to r with +inf."""
    fd = torch.where(alive, fd, torch.inf)
    if r > fd.shape[1]:  # tiny probed volume: pad to the (Q, r) contract
        labels = F.pad(labels, (0, r - fd.shape[1]))
        fd = F.pad(fd, (0, r - fd.shape[1]), value=torch.inf)
    return topk_smallest(fd, labels, r)


def _search_adc8_grouped_impl(index: IVFIndex, queries, r: int, ma: int,
                              group_size: int, kernels: Kernels):
    """8-bit conventional ADC: grouped_scan8 with bf16 tables to window
    minima, a screen of r + max(16, r // 8) windows (the margin absorbs the
    bf16 rounding of the minima near the cut), and every member of the
    winning windows reranked with exact float32 table gathers.

    The kernel never lets a padded code into a minimum, so no argmin clamp
    or dedup is needed (the reference's ivf.py:465-486).
    """
    parts, rot = assign_queries(index, queries, ma)
    tables = adc_tables(rot, index.pq.centroids)             # (Q, ma, M, 256) f32
    q = queries.shape[0]
    m = index.pq.sq_count
    qa = q * ma
    cpr = index.cpr
    window, cs = scan8_windows(m)
    c = index.codes.shape[1] * cs
    routed = route_queries(parts, index.part_count, group_size)
    cv, _ = kernels.grouped_scan8(
        index.codes, tables.reshape(qa, m, 256).to(torch.bfloat16), routed.group_part,
        routed.slot_pairs(), _group_sizes(index, routed),
    )                                                        # (QA, C), inf = no real code
    sz = index.part_sizes[parts.reshape(qa).long()]
    wq = min(r + max(16, r // 8), ma * c)
    screen_v, sel_pair, sel_part, sel_wi, sel_sz = _screen(cv, parts, sz, wq)
    # Window r*cs + c0 holds codes r*cpr + c0 + k*cs.
    first = sel_wi // cs * cpr + sel_wi % cs
    cand, labels, alive = _expand_windows(index, screen_v, sel_part, sel_sz, first, cs,
                                          window)
    idx8 = gather_codes_row128(index.codes.reshape(-1, 128), cand, m).long()
    # Exact float32 rerank: one element gather per (candidate, sub-quantizer)
    # from the per-pair tables, summed over b = 0..m-1.
    base = sel_pair.repeat_interleave(window, dim=1) * m     # (Q, wq*window)
    flat = tables.reshape(-1)
    fd = torch.zeros(cand.shape, dtype=torch.float32, device=cand.device)
    for b in range(m):
        fd = fd + flat[(base + b) * 256 + idx8[..., b]]
    return _rank_candidates(fd, labels, alive, r)


# 16-bit grouped path: windows of ADC16_WINDOW consecutive codes (the
# reference's default), partitions decoded ADC16_GROUP_CHUNK groups at a time
# (bounds the decoded codes and distances to a few tens of MB at bench size).
ADC16_WINDOW = 8
ADC16_GROUP_CHUNK = 32


def _search_adc16_grouped_impl(index: IVFIndex, queries, r: int, ma: int,
                               group_size: int):
    """16-bit conventional ADC: each probed partition decoded once per group,
    distances to the group's queries by a float32 GEMM (no TF32), minima of
    windows of consecutive codes over real codes only, a screen of
    r + max(16, r // 8) windows, and every member of the winning windows
    reranked by its squared distance to the reconstruction."""
    window, group_chunk = ADC16_WINDOW, ADC16_GROUP_CHUNK
    parts, rot = assign_queries(index, queries, ma)
    pq = index.pq
    q = queries.shape[0]
    qa = q * ma
    dim = rot.shape[-1]
    part_pad = index.part_pad
    if part_pad % window:
        raise ValueError(f"part_pad {part_pad} is not a multiple of the window {window}")
    c = part_pad // window
    routed = route_queries(parts, index.part_count, group_size)
    g = routed.group_size
    rotq = rot.reshape(qa, dim)
    qslab = rotq[routed.slot_pairs().clamp(min=0).long()]   # (gcap, G, dim)
    g_sz = _group_sizes(index, routed)
    pcodes = code_view(index.codes, pq.code_size)
    col = torch.arange(part_pad, device=index.device)
    mins = []
    for s in range(0, routed.gcap, group_chunk):
        gp = routed.group_part[s:s + group_chunk].long()
        dec = decode_rows(pq, unpack_codes(pcodes[gp], pq.sq_count, 16))  # (ch, pad, dim)
        qs = qslab[s:s + group_chunk]                                     # (ch, G, dim)
        with full_f32_matmul():
            cross = torch.bmm(qs, dec.transpose(1, 2))                    # (ch, G, pad)
        d = ((qs * qs).sum(-1)[..., None] + (dec * dec).sum(-1)[:, None, :]
             - 2.0 * cross)
        d = torch.where(col < g_sz[s:s + group_chunk, None, None], d, torch.inf)
        mins.append(d.reshape(-1, g, c, window).amin(dim=-1))
    slot = (routed.qa_group * g + routed.qa_slot).reshape(qa).long()
    cv = torch.cat(mins).reshape(-1, c)[slot]                # (QA, C)
    sz = index.part_sizes[parts.reshape(qa).long()]
    wq = min(r + max(16, r // 8), ma * c)
    screen_v, sel_pair, sel_part, sel_wi, sel_sz = _screen(cv, parts, sz, wq)
    cand, labels, alive = _expand_windows(index, screen_v, sel_part, sel_sz,
                                          sel_wi * window, 1, window)
    codes = gather_codes_row128(index.codes.reshape(-1, 128), cand, pq.code_size)
    dec = decode_rows(pq, unpack_codes(codes, pq.sq_count, 16))  # (Q, wq*window, dim)
    qvec = rotq[sel_pair.repeat_interleave(window, dim=1)]
    fd = ((qvec - dec) ** 2).sum(-1)
    return _rank_candidates(fd, labels, alive, r)


def search_adc(
    index: IVFIndex, queries, r: int = 100, ma: int = 1, grouped: bool | None = None,
    group_size: int = 128, scan_budget_bytes: int | None = None,
    kernels: Kernels = DISPATCH,
):
    """Conventional float ADC IVF search at 4, 8 or 16 bits (reference:
    db_query.cpp; the JAX package's ivf.search_adc, less its TPU knobs).

    grouped: the grouped paths (default when part_pad is a multiple of 512
      and the geometry has a grouped path: 4-bit at sq_count 16 or 32, 8-bit
      at sq_count in SCAN8_SQ_COUNTS, any 16-bit); False takes the
      per-probe exact path. On a CPU index the grouped paths run the plain
      versions of the kernels.
    scan_budget_bytes: memory governor budget of the 4- and 8-bit grouped
      paths (default: 35% of the card's memory, at least SCAN_BUDGET_BYTES);
      larger batches run in chunks.
    kernels: the kernel set (lut_scan.DISPATCH, or lut_scan.PLAIN).

    Returns (dists (Q, r) float32, labels (Q, r) int32); +inf marks a slot
    with no candidate.
    """
    dev = index.device
    queries = torch.as_tensor(queries, dtype=torch.float32, device=dev)
    q = queries.shape[0]
    # Probing more partitions than exist == probing all of them.
    ma = min(ma, index.part_count)
    bits, m = index.pq.sq_bits, index.pq.sq_count
    has_grouped = ((bits == 4 and m in (16, 32)) or (bits == 8 and m in SCAN8_SQ_COUNTS)
                   or bits == 16)
    if grouped is None:
        grouped = has_grouped and index.part_pad % 512 == 0
    if not grouped:
        return _search_adc_probe_impl(index, queries, r, ma)
    if not has_grouped:
        raise ValueError(f"no grouped path for {m}x{bits}-bit codes")
    if bits == 16:
        return _search_adc16_grouped_impl(index, queries, r, ma, group_size)
    budget = _default_scan_budget(dev) if scan_budget_bytes is None else scan_budget_bytes
    if bits == 4:
        impl = _search_adc4_grouped_impl
        bytes_kw = dict(window=index.cpr, lanes=8 * m, val_bytes=4, slab_bytes=4,
                        n_streams=1, r=r, cb=index.pq.code_size)
    else:
        impl = _search_adc8_grouped_impl
        bytes_kw = dict(window=scan8_windows(m)[0], lanes=256 * m, val_bytes=4,
                        slab_bytes=2, n_streams=2)     # minima + argmin streams
    chunk = _governed_query_chunk(
        lambda qc: _grouped_scan_bytes(qc, ma, index.part_count, index.part_pad,
                                       group_size=group_size, **bytes_kw),
        q, budget,
    )
    return _run_query_chunks(
        lambda qs, _: impl(index, qs, r, ma, group_size, kernels), queries, chunk)
