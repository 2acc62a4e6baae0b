"""Flat (exhaustive) index and search (counterpart of qadc_tpu/index/flat.py).

One partition holds every code: (N_pad/cpr, 128) uint8 row128 storage, the
tail past n padded (the JAX package's FlatBuilder pads to a multiple of
DEFAULT_BLOCK codes by repeating the last code); labels are code indices
clamped to n - 1. Search paths, each scanning the codes in ranges whose
window minima fit the scan budget, merged exactly:
  - search_qadc (4-bit, int8 tables): keep-prefix bound (M2, rows_adc, over
    the first codes), QuantizerMAX tables, flat_scan (kernels 7 + 8) to
    per-query row minima, an exact screen of 2r windows (r without rerank)
    and a rerank of every code of the winning windows (M2);
  - search_adc, 4-bit: flat_scan with float tables, an exact screen of r
    windows and the M2 rerank, exact: a window minimum is bit for bit the
    rerank's distance of one of its codes;
  - search_adc, 8-bit: flat_scan8 (kernel 9) with bf16 tables to minima of
    the JAX package's 16-code windows, a screen of r + max(16, r // 8)
    windows and an exact float32 table-gather rerank of every member;
  - search_adc, 16-bit: decode chunks of codes, a float32 GEMM against the
    queries, an exact strided window screen per chunk;
  - windowed=False, or a geometry outside the scan kernels' gates: the
    per-code scans of kernels/scan_ref.py (the JAX package's CPU paths).
The 4-bit windows are storage rows (window == cpr). Padded codes never enter
a window minimum.
"""

from __future__ import annotations

import dataclasses

import torch

from qadc_tpu_torch.core.layout import DEFAULT_BLOCK, codes_per_row
from qadc_tpu_torch.core.packing import gather_codes_row128, unpack_codes
from qadc_tpu_torch.core.tensors import full_f32_matmul
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.kernels.lut_scan import (
    DEFAULT_BLOCK_N,
    DEFAULT_WINDOW,
    DISPATCH,
    FLAT8_BLOCK,
    FLAT8_WINDOW,
    FLAT_SCAN8_SQ_COUNTS,
    Kernels,
    flat8_members,
)
from qadc_tpu_torch.kernels.scan_ref import adc_scan_f32, scan_topk_f32, scan_topk_int8
from qadc_tpu_torch.ops.quantization import (
    clamp_bound_to_max_distance,
    keep_prefix_bound,
    quantize_tables_int8,
)
from qadc_tpu_torch.ops.tables import adc_tables
from qadc_tpu_torch.ops.topk import (exact_screen_smallest, exact_tile_screen, merge_topk,
                                     topk_smallest)
from qadc_tpu_torch.quantizers.pq import ProductQuantizer, decode_rows

__all__ = ["FlatIndex", "add", "decode_rows", "search_adc", "search_qadc", "window_search_rows"]

# Codes decoded per step of the 16-bit search (the last chunk may be shorter).
RECON_CHUNK = 65536


def _flat_range_count(n_pad: int, qp: int, window: int, budget: int) -> int:
    """Code-axis ranges so that a range's (Qp, range / window) window minima
    fit the scan budget, with Qp the query count rounded up to 128 (the JAX
    formula, kept so that the ranges match the reference's)."""
    nr = 1
    while ((n_pad // nr) // window * qp * 4 > budget
           and (n_pad // (nr * 2)) % DEFAULT_BLOCK_N == 0):
        nr *= 2
    return nr


@dataclasses.dataclass(frozen=True)
class FlatIndex:
    """Flat index (the reference's fields without the TPU-only `planes`).

    Attributes:
      pq: ProductQuantizer / OPQQuantizer.
      codes: (N_pad/cpr, 128) uint8 row128 storage.
      n: real (unpadded) code count.
    """

    pq: ProductQuantizer
    codes: torch.Tensor
    n: int

    @classmethod
    def create(cls, pq: ProductQuantizer) -> "FlatIndex":
        """Empty index on the quantizer's device: one block of zero codes, n = 0."""
        cpr = codes_per_row(pq.code_size)
        return cls(pq=pq, codes=torch.zeros((DEFAULT_BLOCK // cpr, 128), dtype=torch.uint8,
                                            device=pq.centroids.device), n=0)

    @property
    def cpr(self) -> int:
        return codes_per_row(self.pq.code_size)

    @property
    def n_pad(self) -> int:
        return self.codes.shape[0] * self.cpr

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def labels(self) -> torch.Tensor:
        """(N_pad,) int32 code indices, the padded tail clamped to n - 1."""
        lab = torch.arange(self.n_pad, dtype=torch.int32, device=self.device)
        return torch.clamp(lab, max=max(self.n - 1, 0))


def add(index: FlatIndex, vectors, encode_batch: int = 262144) -> FlatIndex:
    """Encode and append vectors: a one-shot wrapper over
    index/build.FlatBuilder. For streamed ingest use the builder directly
    (one concatenation and re-layout at finalize)."""
    from qadc_tpu_torch.index.build import FlatBuilder

    b = FlatBuilder.from_index(index)
    b.add(vectors, encode_batch=encode_batch)
    return b.finalize()


def _prefix_size(n: int, keep: float) -> int:
    """max(1, n*keep) (reference: db_query_4.cpp:125-126)."""
    return max(1, int(n * keep))


def _scan_budget(index: FlatIndex, scan_budget_bytes: int | None) -> int:
    if scan_budget_bytes is None:
        return ivf._default_scan_budget(index.device)
    return scan_budget_bytes


def _exact_rerank(tables, cand_codes, sq_bits: int):
    """Exact float32 ADC of candidates by table gathers, summed over
    m = 0..M-1. tables: (Q, M, K); cand_codes: (Q, C, code_bytes) uint8.
    Returns (Q, C) float32."""
    idx = unpack_codes(cand_codes, tables.shape[1], sq_bits).long()
    return ivf._table_sum(tables, idx)


def _quantized_tables(index: FlatIndex, queries, r: int, keep: float, kernels: Kernels):
    """Tables, the keep-prefix bound and the QuantizerMAX int8 tables.

    The bound is the r-th smallest float distance of the first
    _prefix_size(n, keep) codes, scored by M2 (rows_adc) over their storage
    rows with one pair per query (the reference scores them with
    adc_scan_f32, a one-hot matmul that sums in another order).

    Returns (tables (Q, M, 16) float32, qtables (Q, M, 16) int8, (tlo, thi)
    the compact tables of the rerank).
    """
    tables = adc_tables(index.pq.rotate(queries), index.pq.centroids)
    q = tables.shape[0]
    cpr = index.cpr
    dev = index.device
    tiles = ivf.tile_tables_rows(tables)
    ps = min(_prefix_size(index.n or index.n_pad, keep), index.n_pad)
    rows = -(-ps // cpr)
    if index.pq.code_size in (8, 16):
        row_ids = torch.arange(rows, dtype=torch.int32, device=dev).repeat(q)
        pair_ids = torch.arange(q, dtype=torch.int32, device=dev).repeat_interleave(rows)
        pd = kernels.rows_adc(index.codes, row_ids, pair_ids, *tiles).reshape(q, rows * cpr)
    else:  # a geometry M2 does not take
        pd = adc_scan_f32(index.codes[:rows].reshape(-1, index.pq.code_size), tables, 4)
    valid = torch.arange(rows * cpr, device=dev) < ps
    bound = keep_prefix_bound(pd, r, valid[None, :])
    tables_nn = torch.clamp(tables, min=0.0)
    bound = clamp_bound_to_max_distance(bound, tables_nn.amax(dim=-1).sum(dim=-1))
    qmin = tables_nn.amin(dim=(-2, -1))
    qtables = quantize_tables_int8(tables, bound[:, None, None], qmin[:, None, None])
    return tables, qtables, tiles


def window_search_rows(codes_rows, labels_flat, size: int, vals, rank_tables, r: int,
                       wq: int, kernels: Kernels, tiles=None, clamp127: bool = False):
    """Screen one code range's window (storage row) minima and rerank the
    winning windows: ivf.window_rerank with the range as one partition.

    Args:
      codes_rows: (R, 128) uint8 storage rows of the range.
      labels_flat: (R * cpr,) int32 labels of its codes.
      size: real code count of the range.
      vals: (Q, R) window minima (flat_scan).
      rank_tables: (Q, M, 16) float tables to rank the expansion with.
      tiles: optional compact (tlo, thi) tables of rank_tables.

    Returns (dists (Q, r), labels (Q, r)).
    """
    q = rank_tables.shape[0]
    r_count = codes_rows.shape[0]
    cpr = labels_flat.shape[0] // r_count
    dev = codes_rows.device
    real = torch.arange(r_count, device=dev) * cpr < size      # rows holding a real code
    screen_v, sel = exact_tile_screen(torch.where(real, vals.to(torch.float32), torch.inf), wq)
    sel_pair = torch.arange(q, device=dev)[:, None].expand(q, wq)
    return ivf.window_rerank(
        codes_rows[None], labels_flat[None], rank_tables[:, None], screen_v,
        torch.zeros((q, wq), dtype=torch.long, device=dev), sel_pair, sel.long(),
        torch.full((q, wq), size, dtype=torch.int32, device=dev), r, kernels,
        tiles=tiles, clamp127=clamp127,
    )


def _scan4_gate(index: FlatIndex, r: int) -> bool:
    """The reference's 4-bit kernel gate (flat.py:352-353, :511-516)."""
    return (index.pq.sq_bits == 4 and index.pq.sq_count in (16, 32)
            and index.n_pad % DEFAULT_BLOCK_N == 0
            and index.n_pad // DEFAULT_WINDOW >= 8 * r)


def _search4_windowed(index: FlatIndex, scan_tables, rank_tables, r: int, wq: int,
                      budget: int, kernels: Kernels, tiles=None, saturate: bool = False,
                      clamp127: bool = False):
    """4-bit window path: per code range, flat_scan to row minima, an exact
    screen of wq windows and the rerank of their codes, merged."""
    q = scan_tables.shape[0]
    window = index.cpr
    nr = _flat_range_count(index.n_pad, -(-q // 128) * 128, window, budget)
    range_codes = index.n_pad // nr
    rows = index.codes.shape[0] // nr
    labels = index.labels
    best = None
    for ri in range(nr):
        codes_r = index.codes[ri * rows:(ri + 1) * rows]
        size_r = min(max(index.n - ri * range_codes, 0), range_codes)
        vals, _ = kernels.flat_scan(codes_r, scan_tables, size_r)
        if saturate:
            # Entries are >= 0, so the window min of saturating sums == min(., 127).
            vals = torch.clamp(vals, max=127)
        dv, dl = window_search_rows(
            codes_r, labels[ri * range_codes:(ri + 1) * range_codes], size_r, vals,
            rank_tables, r, min(wq, rows), kernels, tiles=tiles, clamp127=clamp127)
        best = (dv, dl) if best is None else merge_topk(*best, dv, dl, r)
    return best


def search_qadc(index: FlatIndex, queries, r: int = 100, keep: float = 0.01,
                rerank: bool = True, saturate: bool = False, windowed: bool = True,
                scan_budget_bytes: int | None = None, kernels: Kernels = DISPATCH):
    """Quick-ADC flat search (reference: db_query_4.cpp; sq_bits must be 4).

    The arguments are the JAX package's flat.search_qadc, less `interpret`.

    keep: fraction of codes float-scanned first to set the int8 bound.
    rerank: float-rerank the int8-screened windows (2r of them); False ranks
      by quantized distance, as the reference does.
    saturate: reproduce the reference's saturating int8 sums (min(sum, 127)).
    windowed: the window path (flat_scan) where the geometry allows it
      (sq_count 16 or 32, N_pad a multiple of 1024, N_pad / 16 >= 8r), on a
      CUDA index and a CPU index alike; False, or another geometry, takes the
      per-code path, the JAX package's CPU path.
    scan_budget_bytes: bytes the window minima of one code range may take
      (default: 35% of the card's memory, at least ivf.SCAN_BUDGET_BYTES).
    kernels: the kernel set (lut_scan.DISPATCH, or lut_scan.PLAIN).

    Returns (dists (Q, r) float32, labels (Q, r) int32); distances are float
    ADC with rerank, quantized otherwise.
    """
    if index.pq.sq_bits != 4:
        raise ValueError("Quick ADC requires sq_bits == 4")
    queries = torch.as_tensor(queries, dtype=torch.float32, device=index.device)
    tables, qtables, tiles = _quantized_tables(index, queries, r, keep, kernels)
    if windowed and _scan4_gate(index, r):
        rank_tables = tables if rerank else qtables.to(torch.float32)
        return _search4_windowed(
            index, qtables, rank_tables, r, (2 if rerank else 1) * r,
            _scan_budget(index, scan_budget_bytes), kernels,
            tiles=tiles if rerank else None, saturate=saturate,
            clamp127=saturate and not rerank)
    packed = index.codes.reshape(-1, index.pq.code_size)
    if not rerank:
        return scan_topk_int8(packed, index.labels, qtables, r, num_valid=index.n,
                              saturate=saturate)
    screen_v, cand = scan_topk_int8(packed, index.labels, qtables, min(2 * r, index.n_pad),
                                    num_valid=index.n, saturate=saturate)
    # Flat labels are code indices, so the candidates gather directly.
    fd = _exact_rerank(tables, gather_codes_row128(index.codes, cand, index.pq.code_size), 4)
    # Padding stays masked after the rerank.
    return topk_smallest(torch.where(torch.isfinite(screen_v), fd, torch.inf), cand, r)


def _scan8_gate(index: FlatIndex, r: int) -> bool:
    """The reference's 8-bit kernel gate (flat.py:402-403), at the
    sub-quantizer counts flat_scan8 takes."""
    return (index.pq.sq_bits == 8 and index.pq.sq_count in FLAT_SCAN8_SQ_COUNTS
            and index.n_pad % FLAT8_BLOCK == 0
            and index.n_pad // DEFAULT_WINDOW >= 8 * r)


def _search_adc8_windowed(index: FlatIndex, tables, r: int, budget: int, kernels: Kernels):
    """8-bit window path: per code range, flat_scan8 with bf16 tables, an
    exact screen of r + max(16, r // 8) windows (the margin absorbs the bf16
    rounding of the minima near the cut), and every member of the winning
    windows reranked with exact float32 table gathers, merged.

    The kernel never lets a padded code into a minimum, so no argmin mask
    is needed (the reference's flat.py:416-417)."""
    q, m, _ = tables.shape
    t8 = tables.to(torch.bfloat16)
    # Two output streams (minima and argmins): half the budget each.
    nr = _flat_range_count(index.n_pad, -(-q // 128) * 128, FLAT8_WINDOW, budget // 2)
    range_codes = index.n_pad // nr
    rows = index.codes.shape[0] // nr
    labels = index.labels
    best = None
    for ri in range(nr):
        size_r = min(max(index.n - ri * range_codes, 0), range_codes)
        vals, _ = kernels.flat_scan8(index.codes[ri * rows:(ri + 1) * rows], t8, size_r)
        ww = min(r + max(16, r // 8), vals.shape[1])
        screen_v, sel = exact_tile_screen(vals, ww)                 # (Q, ww) windows
        members = flat8_members(sel.long(), m)                      # (Q, ww, 16)
        alive = (members < size_r) & torch.isfinite(screen_v)[..., None]
        cand = (members + ri * range_codes).reshape(q, ww * FLAT8_WINDOW)
        fd = _exact_rerank(tables, gather_codes_row128(index.codes, cand, m), 8)
        dv, dl = ivf._rank_candidates(fd, labels[cand], alive.reshape(q, -1), r)
        best = (dv, dl) if best is None else merge_topk(*best, dv, dl, r)
    return best


def _search_adc_recon(index: FlatIndex, queries, r: int):
    """16-bit ADC as a reconstruction GEMM: the ADC distance is the squared
    distance to the PQ reconstruction, so each chunk of codes is decoded and
    scored as |q|^2 + |x|^2 - 2 q.x by a float32 GEMM (no TF32), then
    screened exactly: the top-rk windows by minimum (window = codes
    {w + t*g : t < 16} of the chunk, g = chunk / 16) hold the chunk's top rk.

    The reference takes chunks of gcd(N_pad, 65536) codes, 1024 at the
    SIFT1M size (977 steps); the port takes RECON_CHUNK codes and a shorter
    last chunk. Each chunk's screen is exact, so the top-r is the same.
    """
    pq = index.pq
    rotated = pq.rotate(queries)
    q = rotated.shape[0]
    q2 = (rotated * rotated).sum(dim=1)
    cpr, n_pad = index.cpr, index.n_pad
    dev = index.device
    best_v = torch.full((q, r), torch.inf, dtype=torch.float32, device=dev)
    best_l = torch.zeros((q, r), dtype=torch.int32, device=dev)
    for s in range(0, n_pad, RECON_CHUNK):
        c = min(RECON_CHUNK, n_pad - s)
        rows = index.codes[s // cpr:(s + c) // cpr]
        dec = decode_rows(pq, unpack_codes(rows.reshape(c, pq.code_size), pq.sq_count, 16))
        with full_f32_matmul():
            cross = rotated @ dec.T                                 # (Q, c)
        d = q2[:, None] + (dec * dec).sum(dim=1)[None, :] - 2.0 * cross
        col = torch.arange(s, s + c, device=dev)
        d = torch.where(col < index.n, d, torch.inf)
        rk = min(r, c)
        g = c // DEFAULT_WINDOW
        if rk < g and c % DEFAULT_WINDOW == 0:
            wmin = d.reshape(q, DEFAULT_WINDOW, g).amin(dim=1)      # (Q, g)
            _, selw = exact_screen_smallest(wmin, rk)               # (Q, rk) windows
            cols = (selw.long()[:, :, None]
                    + torch.arange(DEFAULT_WINDOW, device=dev) * g).reshape(q, -1)
            cv = torch.gather(d, 1, cols)
        else:  # every window wins: rank the whole chunk
            cols = torch.arange(c, device=dev).expand(q, c)
            cv = d
        cl = torch.clamp(cols + s, max=max(index.n - 1, 0)).to(torch.int32)
        cv, cl = topk_smallest(cv, cl, rk)
        best_v, best_l = merge_topk(best_v, best_l, cv, cl, r)
    return best_v, best_l


def search_adc(index: FlatIndex, queries, r: int = 100, windowed: bool = True,
               scan_budget_bytes: int | None = None, kernels: Kernels = DISPATCH):
    """Conventional float ADC flat search at 4, 8 or 16 bits (reference:
    db_query.cpp; the JAX package's flat.search_adc, less `interpret`).

    windowed: the window paths where the geometry allows them: 4-bit at
      sq_count 16 or 32 (flat_scan, float tables), 8-bit at sq_count in
      FLAT_SCAN8_SQ_COUNTS (flat_scan8), each with N_pad / 16 >= 8r; False,
      or another geometry, takes the exact per-code scan. 16-bit codes
      always take the reconstruction GEMM.
    scan_budget_bytes: bytes the window minima of one code range may take.
    kernels: the kernel set (lut_scan.DISPATCH, or lut_scan.PLAIN).

    Returns (dists (Q, r) float32 ascending, labels (Q, r) int32); +inf
    marks a slot with no candidate.
    """
    queries = torch.as_tensor(queries, dtype=torch.float32, device=index.device)
    bits = index.pq.sq_bits
    if bits == 16:
        return _search_adc_recon(index, queries, r)
    tables = adc_tables(index.pq.rotate(queries), index.pq.centroids)  # (Q, M, K)
    if windowed and _scan4_gate(index, r):
        # wq = r: the screen's minima are the rerank's distances, bit for bit.
        return _search4_windowed(index, tables, tables, r, r,
                                 _scan_budget(index, scan_budget_bytes), kernels,
                                 tiles=ivf.tile_tables_rows(tables))
    if windowed and _scan8_gate(index, r):
        return _search_adc8_windowed(index, tables, r, _scan_budget(index, scan_budget_bytes),
                                     kernels)
    return scan_topk_f32(index.codes.reshape(-1, index.pq.code_size), index.labels, tables,
                         bits, r, num_valid=index.n)
