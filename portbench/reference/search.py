"""Plain reference of the searches the benchmark times, in PyTorch alone.

It imports nothing of the port and nothing of JAX. It takes the raw inputs
(queries, base vectors) and the trained quantizer state the program's
set-up learned (coarse centroids, OPQ rotation, PQ codebooks) and its code
storage, and works out again, per query, the search the configuration
names (its `adc_type`):

Quick ADC (`search`, 4-bit codes, the default):
  - the coarse assignment to the ma nearest partitions (IVF);
  - the OPQ rotation of each residual (or of the query, flat);
  - the float ADC tables, the keep-prefix bound and the QuantizerMAX
    quantization of the tables to [0, levels] (int8: levels = 127);
  - the integer 4-bit scan of every probed code to window (storage row)
    minima;
  - the exact screen of the query's windows and the float rerank of their
    codes;
  - the final top r, the Quick ADC answer as the configuration states it.

Conventional ADC at 8 bits (`search_adc8`, IVF, the port's grouped adc8
contract):
  - the assignment, the rotation and the float32 ADC tables, as above;
  - the same tables rounded to bfloat16, summed in float32 over
    b = 0..M-1 in order to each window's minimum over its real codes; a
    window is min(cpr, 8) codes of one storage row, window row * cs + c0
    holding in-row positions c0 + k * cs (cs = cpr / window), and a window
    with no real code is +inf;
  - the exact screen of r + max(16, r // 8) windows;
  - every real member of the winning windows reranked by float32 ADC (the
    float32 tables, summed over b in order), and the stable top r.

Either way, for judging an answer: the float ADC distance of every probed
code (what the exact path the IVF search takes at small batches ranks by),
and, whatever order breaks the screen's ties, each probed code's class:
SURE when its window lies below the screen's cut value, TIED at it, OUT
above it. Codes are decoded by their bit width, read from the codebooks:
K = 16 centroids a sub-quantizer packs two codes a byte (nibbles), K = 256
is one byte a sub-quantizer.

Every selection is a stable sort, so ties go to the lower position, as the
program's do. `precision(low=True)` is the control: every float32 matrix
product in TF32, with the caller passing levels = 15 (int4 tables) to the
Quick ADC search, or rerank=torch.bfloat16 (the rerank summed from the
bfloat16 tables) to the 8-bit one.

Nothing here is timed; it runs after the benchmark's window has closed, in
blocks of queries so that it fits beside the index.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

INT8_LEVELS = 127
INT4_LEVELS = 15
BIG = 1 << 30
# The 8-bit grouped search's windows: at most this many codes of a storage row.
ADC8_WINDOW = 8
# Where the exact screen puts a code's window: below the cut value (every
# exact screen keeps it), at the cut value (a screen keeps some of these
# ties, which ones is the implementation's order), or above it (none does).
SURE, TIED, OUT = 2, 1, 0


@contextlib.contextmanager
def precision(low: bool = False):
    """Float32 products in full float32 (the configuration's precision) or,
    for the control, in TF32; the process's settings are restored after."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = low
    torch.backends.cudnn.allow_tf32 = low
    torch.set_float32_matmul_precision("high" if low else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


@dataclasses.dataclass
class State:
    """What the reference follows from: the trained quantizer and the codes.

    coarse: (P, dim) float32 (IVF) or None (flat).
    rotation: (dim, dim) float32: rotate(x) = x @ rotation.T.
    codebooks: (M, K, dim / M) float32, K = 16 (4-bit) or 256 (8-bit).
    codes: (P, part_pad, code bytes) uint8 (flat: P = 1): 4-bit codes
      packed, M / 2 bytes, sub-quantizer 2b in the low nibble of byte b,
      2b + 1 in the high one; 8-bit codes M bytes, sub-quantizer b in byte b.
    labels: (P, part_pad) int64 label of each code.
    sizes: (P,) int64 real codes a partition (flat: n); later codes are
      padding and never answer.
    """

    coarse: torch.Tensor | None
    rotation: torch.Tensor
    codebooks: torch.Tensor
    codes: torch.Tensor
    labels: torch.Tensor
    sizes: torch.Tensor

    @property
    def sq_count(self) -> int:
        return self.codebooks.shape[0]

    @property
    def k(self) -> int:
        """Centroids a sub-quantizer: 16 or 256."""
        return self.codebooks.shape[1]

    @property
    def cpr(self) -> int:
        """Codes a 128-byte storage row: the window of the 4-bit scan."""
        return 128 // self.codes.shape[-1]


@dataclasses.dataclass
class Answers:
    """Per query: the answer (Q, r) of the search the configuration names,
    and the float ADC distance and the screen's class of every probed code,
    for judging an answer."""

    labels: torch.Tensor
    dists: torch.Tensor
    probes: torch.Tensor            # (Q, ma) partitions probed
    code_dists: torch.Tensor        # (Q, ma, part_pad) float32, inf past a size
    code_class: torch.Tensor        # (Q, ma, part_pad) int8: SURE, TIED or OUT


def nearest(x: torch.Tensor, base: torch.Tensor, k: int) -> torch.Tensor:
    """(Q, k) indices of the k nearest rows of base under squared L2, by
    ||b||^2 - 2 x.b, ties to the lower index."""
    scores = (base * base).sum(-1)[None, :] - 2.0 * (x @ base.T)
    return torch.sort(scores, dim=-1, stable=True)[1][:, :k]


def adc_tables(rot: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(..., M, K) squared distances of each rotated sub-vector to its
    sub-quantizer's centroids: ||r||^2 + ||c||^2 - 2 r.c."""
    m, _, dsq = codebooks.shape
    r = rot.reshape(*rot.shape[:-1], m, dsq)
    cross = torch.einsum("...md,mkd->...mk", r, codebooks)
    return (r * r).sum(-1)[..., None] + (codebooks * codebooks).sum(-1) - 2.0 * cross


def nibbles(codes: torch.Tensor, m: int) -> torch.Tensor:
    """Sub-quantizer m's centroid index of each packed code (..., M / 2)
    uint8 -> (...) int64: the low nibble of byte m // 2 for even m, the
    high one for odd m."""
    byte = codes[..., m // 2].to(torch.int64)
    return byte & 15 if m % 2 == 0 else byte >> 4


def centroid(codes: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """Sub-quantizer m's centroid index of each code (..., code bytes) uint8
    -> (...) int64, by the bit width of K = k centroids: a nibble at 16,
    byte m at 256."""
    if k == 16:
        return nibbles(codes, m)
    if k == 256:
        return codes[..., m].to(torch.int64)
    raise ValueError(f"codes of {k} centroids a sub-quantizer: only 16 and 256 are stored")


def decode(codes: torch.Tensor, sq_count: int, k: int) -> torch.Tensor:
    """(..., code bytes) uint8 -> (..., M) int64 centroid indices."""
    return torch.stack([centroid(codes, m, k) for m in range(sq_count)], -1)


def float_sums(tables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """sum_m tables[..., m, code_m] in float32, m = 0..M-1 in order.
    tables (B, A, M, K); codes (B or 1, A, N, code bytes) -> (B, A, N)."""
    shape = tables.shape[:2] + codes.shape[2:3]
    acc = torch.zeros(shape, dtype=torch.float32, device=codes.device)
    k = tables.shape[-1]
    for m in range(tables.shape[-2]):
        acc = acc + torch.gather(tables[..., m, :], -1, centroid(codes, m, k).expand(shape))
    return acc


def quantize(tables: torch.Tensor, bound: torch.Tensor, levels: int) -> torch.Tensor:
    """QuantizerMAX tables of each query: (Q, ..., M, K) float32 and (Q,)
    bounds -> int32 in [0, levels]. A bound that is not finite becomes the
    query's largest possible distance; qmin is its smallest non-negative
    entry; an entry at or above the bound takes the top level."""
    q = tables.shape[0]
    t = torch.clamp(tables, min=0.0)
    most = t.amax(-1).sum(-1).reshape(q, -1).amax(-1)
    bound = torch.where(torch.isfinite(bound), bound, most * (1.0 + 1e-6))
    shape = (q,) + (1,) * (tables.dim() - 1)
    qmax = bound.reshape(shape)
    qmin = t.reshape(q, -1).amin(-1).reshape(shape)
    delta = (qmax - qmin) / float(levels)
    scaled = (t - qmin) / torch.clamp(delta, min=1e-30)
    out = torch.clamp(scaled, 0.0, levels + 1.0).to(torch.int32).clamp(0, levels)
    return torch.where(t >= qmax, levels, out)


def int_sums(qtables: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """sum_m qtables[..., m, code_m] in int32; shapes as float_sums."""
    shape = qtables.shape[:2] + codes.shape[2:3]
    acc = torch.zeros(shape, dtype=torch.int32, device=codes.device)
    for m in range(qtables.shape[-2]):
        acc = acc + torch.gather(qtables[..., m, :], -1, nibbles(codes, m).expand(shape))
    return acc


def kth_smallest(d: torch.Tensor, r: int) -> torch.Tensor:
    """(...,) r-th smallest along the last axis; inf when fewer than r."""
    if d.shape[-1] < r:
        return torch.full(d.shape[:-1], torch.inf, device=d.device)
    return torch.sort(d, dim=-1, stable=True)[0][..., r - 1]


def _top(d: torch.Tensor, labels: torch.Tensor, r: int):
    """Stable top-r smallest with labels, padded with inf / -1 to r."""
    sv, order = torch.sort(d, dim=-1, stable=True)
    sl = torch.gather(labels, -1, order)
    if sv.shape[-1] < r:
        pad = r - sv.shape[-1]
        sv = torch.nn.functional.pad(sv, (0, pad), value=torch.inf)
        sl = torch.nn.functional.pad(sl, (0, pad), value=-1)
    sv, sl = sv[..., :r], sl[..., :r]
    return sv, torch.where(torch.isfinite(sv), sl, -1)


def search(state: State, queries: torch.Tensor, r: int, ma: int, keep: float,
           screen: int, levels: int = INT8_LEVELS, block: int = 8) -> Answers:
    """The Quick ADC answers for queries (Q, dim), in blocks of queries.

    ma: partitions probed (1 for a flat index). screen: windows the exact
    screen keeps, in units of r (IVF 1, flat 2, as the configuration
    states). keep: the share of each probed partition's first codes whose
    float distances set the quantization bound.
    """
    return _in_blocks(lambda x: _search_block(state, x, r, ma, keep, screen, levels),
                      queries, block)


def _in_blocks(search_block, queries: torch.Tensor, block: int) -> Answers:
    parts = [search_block(queries[s:s + block]) for s in range(0, queries.shape[0], block)]
    return Answers(*(torch.cat([getattr(p, f.name) for p in parts])
                     for f in dataclasses.fields(Answers)))


def _search_block(state: State, x: torch.Tensor, r: int, ma: int, keep: float,
                  screen: int, levels: int) -> Answers:
    b = x.shape[0]
    dev = x.device
    n_parts, part_pad, _ = state.codes.shape
    cpr = state.cpr
    if state.coarse is None:
        probes = torch.zeros((b, 1), dtype=torch.int64, device=dev)
        res = x[:, None, :]
        codes, labels = state.codes[None], state.labels[None].expand(b, 1, part_pad)
    else:
        probes = nearest(x, state.coarse, min(ma, n_parts))
        res = x[:, None, :] - state.coarse[probes]
        codes, labels = state.codes[probes], state.labels[probes]       # (B, ma, pad, .)
    pa = probes.shape[1]
    tables = adc_tables(res @ state.rotation.T, state.codebooks)        # (B, ma, M, 16)
    sizes = state.sizes[probes]                                          # (B, ma)
    col = torch.arange(part_pad, device=dev)
    real = col[None, None, :] < sizes[..., None]                         # (B, ma, pad)
    fd = torch.where(real, float_sums(tables, codes), torch.inf)

    # Keep-prefix bound: the r-th smallest float distance over the first
    # max(1, size * keep) codes of each probed partition (size * keep in
    # float32), within the prefix rows the search scores.
    if state.coarse is None:
        starts = torch.full_like(sizes, min(max(1, int(int(state.sizes[0]) * keep)), part_pad))
    else:
        most = int(state.sizes.max())
        prefix = min(max(1, int(most * keep)), part_pad) if most else 1
        starts = torch.clamp((sizes.to(torch.float32) * keep).to(torch.int64), min=1)
        starts = torch.clamp(torch.where(sizes > 0, starts, 0), max=-(-prefix // cpr) * cpr)
    pre = torch.where(col[None, None, :] < starts[..., None], fd, torch.inf)
    bound = kth_smallest(pre.reshape(b, -1), r)
    qt = quantize(tables, bound, levels)

    # The integer scan to window minima, the exact screen, the float rerank.
    c = part_pad // cpr
    si = torch.where(real, int_sums(qt, codes), BIG)
    wmin = si.reshape(b, pa, c, cpr).amin(-1).to(torch.float32)
    rows = torch.arange(c, device=dev)
    wmin = torch.where(rows[None, None, :] * cpr < sizes[..., None], wmin, torch.inf)
    wq = min(screen * r, pa * c)
    sv, sel = torch.sort(wmin.reshape(b, pa * c), dim=-1, stable=True)
    sv, sel = sv[:, :wq], sel[:, :wq]
    pos = (sel % c)[..., None] * cpr + torch.arange(cpr, device=dev)     # (B, wq, cpr)
    pair = (sel // c)[..., None].expand_as(pos)
    cand = torch.gather(fd.reshape(b, -1), 1, (pair * part_pad + pos).reshape(b, -1))
    cand_l = torch.gather(labels.reshape(b, -1), 1, (pair * part_pad + pos).reshape(b, -1))
    alive = torch.isfinite(sv)[..., None].expand_as(pos).reshape(b, -1)
    quick_d, quick_l = _top(torch.where(alive, cand, torch.inf), cand_l, r)
    window_class = _classes(wmin, sv)
    code_class = window_class.to(torch.int8).repeat_interleave(cpr, dim=-1)
    code_class = torch.where(real, code_class, OUT)
    return Answers(quick_l, quick_d, probes, fd, code_class)


def _classes(wmin: torch.Tensor, sv: torch.Tensor) -> torch.Tensor:
    """Each window's class against the screen's cut, the last of the
    screened minima sv (B, wq): wmin (B, ...) -> SURE, TIED or OUT."""
    cut = sv[:, -1].reshape((-1,) + (1,) * (wmin.dim() - 1))
    return torch.where(wmin < cut, SURE, torch.where(wmin == cut, TIED, OUT))


def adc8_screen_width(r: int) -> int:
    """Windows the 8-bit grouped search keeps: r + max(16, r // 8), the
    screen width of the port's and the JAX package's grouped adc8 search
    (ROADMAP: "Screen widths are kept from the reference"); the margin over
    r absorbs the bfloat16 rounding of the window minima near the cut."""
    return r + max(16, r // 8)


def search_adc8(state: State, queries: torch.Tensor, r: int, ma: int,
                rerank: torch.dtype = torch.float32, block: int = 8) -> Answers:
    """The 8-bit conventional ADC answers for queries (Q, dim) over an IVF
    index (see the module's docstring), in blocks of queries.

    rerank: the tables the rerank sums, float32 as the configuration
    states; bfloat16 for the control (the screen's own sums).
    """
    if state.coarse is None or state.k != 256:
        raise ValueError("search_adc8 takes an IVF index of 8-bit codes")
    return _in_blocks(lambda x: _adc8_block(state, x, r, ma, rerank), queries, block)


def _adc8_block(state: State, x: torch.Tensor, r: int, ma: int,
                rerank: torch.dtype) -> Answers:
    b = x.shape[0]
    dev = x.device
    n_parts, part_pad, _ = state.codes.shape
    cpr = state.cpr
    window = min(cpr, ADC8_WINDOW)
    cs = cpr // window
    rows = part_pad // cpr
    probes = nearest(x, state.coarse, min(ma, n_parts))
    res = x[:, None, :] - state.coarse[probes]
    codes, labels = state.codes[probes], state.labels[probes]       # (B, ma, pad, M)
    pa = probes.shape[1]
    tables = adc_tables(res @ state.rotation.T, state.codebooks)    # (B, ma, M, 256)
    sizes = state.sizes[probes]
    real = torch.arange(part_pad, device=dev)[None, None, :] < sizes[..., None]
    fd = torch.where(real, float_sums(tables, codes), torch.inf)
    low = tables.to(torch.bfloat16).to(torch.float32)
    sd = torch.where(real, float_sums(low, codes), torch.inf)
    ranked = fd if rerank == torch.float32 else sd

    # In-row position c0 + k * cs is window c0's k-th code: a row's codes
    # as (window, cs), reduced over k.
    c = rows * cs
    wmin = sd.reshape(b, pa, rows, window, cs).amin(-2).reshape(b, pa, c)
    wq = min(adc8_screen_width(r), pa * c)
    sv, sel = torch.sort(wmin.reshape(b, pa * c), dim=-1, stable=True)
    sv, sel = sv[:, :wq], sel[:, :wq]
    w = sel % c
    pos = ((w // cs) * cpr + w % cs)[..., None] + torch.arange(window, device=dev) * cs
    flat = ((sel // c)[..., None] * part_pad + pos).reshape(b, -1)   # (B, wq * window)
    cand = torch.gather(ranked.reshape(b, -1), 1, flat)
    cand_l = torch.gather(labels.reshape(b, -1), 1, flat)
    alive = torch.isfinite(sv)[..., None].expand_as(pos).reshape(b, -1)
    dists, answer = _top(torch.where(alive, cand, torch.inf), cand_l, r)
    window_class = _classes(wmin, sv).to(torch.int8).reshape(b, pa, rows, 1, cs)
    code_class = window_class.expand(b, pa, rows, window, cs).reshape(b, pa, part_pad)
    code_class = torch.where(real, code_class, OUT)
    return Answers(answer, dists, probes, fd, code_class)


def exact_nn(queries: torch.Tensor, base: torch.Tensor, qblock: int = 2048,
             nblock: int = 262_144) -> torch.Tensor:
    """(Q,) index of each query's nearest base vector under squared L2
    (ties to the lower index), in blocks, float32 products."""
    best_d = torch.full((queries.shape[0],), torch.inf, device=queries.device)
    best_i = torch.zeros((queries.shape[0],), dtype=torch.int64, device=queries.device)
    for s in range(0, base.shape[0], nblock):
        blk = base[s:s + nblock]
        b2 = (blk * blk).sum(-1)
        for t in range(0, queries.shape[0], qblock):
            q = queries[t:t + qblock]
            d = b2[None, :] - 2.0 * (q @ blk.T)
            v, i = d.min(dim=-1)
            upd = v < best_d[t:t + qblock]
            best_d[t:t + qblock] = torch.where(upd, v, best_d[t:t + qblock])
            best_i[t:t + qblock] = torch.where(upd, i + s, best_i[t:t + qblock])
    return best_i


def encode(state: State, vectors: torch.Tensor):
    """The reference's encoding of base vectors under the program's trained
    quantizer: (partition (N,), centroid indices (N, M)); flat: partition 0."""
    if state.coarse is None:
        part = torch.zeros(vectors.shape[0], dtype=torch.int64, device=vectors.device)
        res = vectors
    else:
        part = nearest(vectors, state.coarse, 1)[:, 0]
        res = vectors - state.coarse[part]
    m, _, dsq = state.codebooks.shape
    sub = (res @ state.rotation.T).reshape(-1, m, dsq)
    cb = state.codebooks
    d = (cb * cb).sum(-1)[None] - 2.0 * torch.einsum("nmd,mkd->nmk", sub, cb)
    return part, torch.argmin(d, dim=-1)


def recall_at_r(labels, nearest_ids) -> float:
    """Share of answers (A, r) whose true nearest neighbour (A,) is among
    the returned labels (t = 1, as the reference's recall.hpp)."""
    hits = np.asarray(labels) == np.asarray(nearest_ids)[:, None]
    return float(hits.any(-1).mean()) if hits.size else float("nan")
