"""M1 with int8 tables (csrc/scan_mma.cu: grouped_scan_mma_kernel_plan,
_prefix and the scan): its work split and its fragment maps on the CPU, its
output on the card.

On the CPU (no JAX: the file also runs on the card's machine):
  (a) lut_scan.grouped_scan_mma_plan packs each group's live pairs in slot
      order and prefixes the groups' costs;
  (b) lut_scan.grouped_scan_mma_walk, the kernel's walk, covers every real
      (group, oct) of a live group exactly once across the warps, reaches no
      oct past a partition's real rows, and leaves the rows from each live
      group's last real oct on to the sentinel stores;
  (c) a lane-by-lane emulation of one warp's oct (codes on the mma's M side:
      A the one-hot of 16 codes by byte permutes of their nibbles, B the
      tables of 8 pairs byte-transposed to match, the m16n8k32 fragment maps
      of the PTX ISA, the padded-code masks, the 16-bit packed minima and the
      three exchanges of the row reduction) reproduces grouped_scan_plain at
      CB 8 and 16, one and two N tiles, a partial row;
  (d) the tile minima (tile_minima=True): grouped_scan_plain's are the
      masked float rows' amin; tile_merges, the kernel's merges from its
      walk, carries each real oct once a chunk,
      reaches every real tile of a live pair, cuts tiles between warps
      where a share boundary falls inside one, and its minimum over the
      merges (from the plan's +inf) is grouped_scan_plain's; the lane
      emulation's per-lane fold of a tile's octs and the three exchanges of
      merge_tiles give the same minima.
On the card (skipped without CUDA; run with --noconftest): the whole (QA,
rpp) output of lut_scan.grouped_scan equals grouped_scan_plain bit for bit,
sentinel rows included, in a sparse geometry (>= 1,024 partitions, part_pad
>= 8x the mean list, 1-4 live pairs a group, sizes 0, 1 and off the row), a
dense one (12-128 live pairs a group, one of exactly group_size), with groups
past n_groups, at CB 8 and 16; and a replay of a CUDA graph of the call
equals the eager call; the kernels' own `scan.rows` count equals
grouped_scan_rows'; with tile_minima, the rows unchanged and the tile minima
equal grouped_scan_plain's bit for bit, eager and under graph replay, in
the sparse geometry (an empty partition: all +inf; tiles with real and
sentinel rows; tiles cut by the warps' shares) and the dense one at 64 rows.
Tolerance: exact everywhere (int32 sums of int8 entries).
"""

import numpy as np
import pytest
import torch

from qadc_tpu_torch.eval.trace import recording
from qadc_tpu_torch.index.routing import route_queries
from qadc_tpu_torch.kernels import lut_scan

torch.set_num_threads(1)

OCT = lut_scan.GROUPED_MMA_OCT
NONE16 = 0x7FFF


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda", 0)


def routed_groups(counts, sizes, group_size: int, seed: int):
    """(group_part, slot_pair, group_sizes, qa): route_queries over pairs of
    which partition j takes counts[j], shuffled; groups past n_groups stay
    unused (size 0, no live slot)."""
    rng = np.random.default_rng(seed)
    pids = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    rng.shuffle(pids)
    routed = route_queries(torch.from_numpy(pids.reshape(-1, 1)), len(counts), group_size)
    sizes = torch.as_tensor(sizes, dtype=torch.int32)
    g_sz = torch.where(routed.group_valid, sizes[routed.group_part.long()], 0).to(torch.int32)
    return routed.group_part, routed.slot_pairs(), g_sz, int(pids.size), int(routed.n_groups)


def sparse_case(m: int, seed: int):
    """1,024 partitions of 64 rows, lists ~1/10 of part_pad (the largest
    whole), 1-4 pairs a list: Deep100M's shape, scaled down."""
    cpr = 256 // m
    rng = np.random.default_rng(seed)
    parts, rpp = 1024, 64
    sizes = rng.integers(1, rpp * cpr // 5, parts)
    sizes[:6] = [0, 1, cpr - 1, cpr + 1, 3 * cpr, rpp * cpr]      # empty, one code, off the row
    counts = rng.integers(1, 5, parts)
    return parts, rpp, sizes, counts, 128


def dense_case(m: int, seed: int, rpp: int = 40):
    """16 partitions of 40 rows (64: a multiple of TILE, as tile minima
    need), 12-200 pairs a list (one exactly group_size, one past it):
    SIFT's shape, scaled down."""
    cpr = 256 // m
    rng = np.random.default_rng(seed)
    parts = 16
    sizes = rng.integers(rpp * cpr // 3, rpp * cpr + 1, parts)
    sizes[:3] = [0, rpp * cpr, rpp * cpr - 3]
    counts = rng.integers(12, 65, parts)
    counts[:3] = [128, 200, 12]
    return parts, rpp, sizes, counts, 128


def scan_inputs(case, m: int, seed: int):
    parts, rpp, sizes, counts, group_size = case
    rng = np.random.default_rng(seed + 1)
    group_part, slot_pair, g_sz, qa, n_groups = routed_groups(counts, sizes, group_size, seed)
    codes = torch.from_numpy(rng.integers(0, 256, (parts, rpp, 128), dtype=np.uint8))
    tables = torch.from_numpy(rng.integers(-128, 128, (qa, m, 16)).astype(np.int8))
    return [codes, tables, group_part, slot_pair, g_sz], n_groups


# ---------------------------------------------------------------- (a) the plan


@pytest.mark.parametrize("cb,held", [(8, 1), (8, 2), (16, 1)])
def test_plan_packs_live_pairs_and_prefixes_costs(cb, held):
    rng = np.random.default_rng(cb)
    slot_pair = torch.full((7, 20), -1, dtype=torch.int32)
    for g, live in enumerate([0, 1, 8, 9, 17, 20, 3]):
        slot_pair[g, torch.from_numpy(rng.permutation(20)[:live])] = torch.arange(
            100 * g, 100 * g + live, dtype=torch.int32)
    sizes = torch.tensor([50, 0, 1, 129, 300, 1000, 64], dtype=torch.int32)
    rpp, cpr = 30, 128 // cb
    packed, live, base = lut_scan.grouped_scan_mma_plan(slot_pair, sizes, rpp, cb, held)
    total = 0
    for g in range(7):
        row = slot_pair[g]
        want = row[row >= 0]                                   # slot order
        n = want.numel()
        assert live[g] == n
        assert torch.equal(packed[g, :n], want) and (packed[g, n:] == -1).all()
        rows = min(rpp, -(-int(sizes[g]) // cpr)) if n else 0
        tiles = -(-n // 8)
        total += -(-rows // OCT) * (-(-tiles // held) * lut_scan.GROUPED_MMA_ONEHOT_COST
                                    + tiles)
        assert base[g + 1] == total
    assert base[0] == 0
    assert base[-1] == lut_scan.grouped_scan_rows(slot_pair, sizes, rpp, cpr).sum()


def test_grouped_scan_rows_counts_live_groups_only():
    slot_pair = torch.tensor([[-1, -1], [3, -1], [-1, 0], [1, 2]], dtype=torch.int32)
    sizes = torch.tensor([500, 17, 0, 10_000], dtype=torch.int32)
    got = lut_scan.grouped_scan_rows(slot_pair, sizes, 40, 16)
    assert got.tolist() == [0, 2, 0, 40]


# ---------------------------------------------------------------- (b) the walk


def _real_octs(slot_pair, group_sizes, rpp, cpr):
    rows = lut_scan.grouped_scan_rows(slot_pair, group_sizes, rpp, cpr).tolist()
    return {(g, o) for g, r in enumerate(rows) for o in range(-(-r // OCT))}, rows


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("kind,warps", [("sparse", 264 * 8), ("sparse", 7), ("dense", 264 * 8),
                                        ("dense", 3), ("dense", 1)])
def test_walk_covers_each_real_oct_once(m, kind, warps):
    cb = m // 2
    case = (sparse_case if kind == "sparse" else dense_case)(m, 5)
    parts, rpp, sizes, counts, group_size = case
    _, slot_pair, g_sz, _, n_groups = routed_groups(counts, sizes, group_size, 5)
    assert slot_pair.shape[0] > n_groups                       # groups past n_groups
    held = lut_scan.grouped_mma_tiles(cb, int((slot_pair >= 0).sum()), parts)
    walks, dead = lut_scan.grouped_scan_mma_walk(slot_pair, g_sz, rpp, cb, held, warps)
    want, rows = _real_octs(slot_pair, g_sz, rpp, 128 // cb)
    seen = [item for walk in walks for item in walk]
    assert len(seen) == len(set(seen)) and set(seen) == want   # each real oct once, no other
    for walk in walks:                                         # a warp's octs in order
        assert walk == sorted(walk)
    live = (slot_pair >= 0).any(dim=1).tolist()
    assert [g for g, _ in dead] == [g for g in range(len(live)) if live[g]]
    for g, first in dead:                                      # from the last real oct on
        assert first == min(rpp, -(-rows[g] // OCT) * OCT)
    if warps > 100 and kind == "sparse":
        busy = [len(w) for w in walks if w]
        assert max(busy) <= 2 * (len(seen) / warps) + 2        # the cost prefix balances them


def test_walk_of_a_batch_with_no_live_group_is_empty():
    slot_pair = torch.full((4, 8), -1, dtype=torch.int32)
    walks, dead = lut_scan.grouped_scan_mma_walk(slot_pair, torch.full((4,), 99, dtype=torch.int32),
                                                 20, 8, 1, 16)
    assert all(not w for w in walks) and dead == []


# ---------------------------------------------------------------- (c) one warp, lane by lane


def _byte(word, i):
    return (int(word) >> (8 * i)) & 0xFF


def _prmt(a, b, c):
    """PTX prmt.b32, default mode: byte i is byte c[4i+2:4i] of (b:a), or
    its sign replicated where bit 4i+3 of c is set."""
    src = [_byte(a, i) for i in range(4)] + [_byte(b, i) for i in range(4)]
    out = 0
    for i in range(4):
        s = (c >> (4 * i)) & 0xF
        byte = src[s & 7]
        if s & 8:
            byte = 0xFF if byte & 0x80 else 0
        out |= byte << (8 * i)
    return out


def _mma(a_regs, b_regs, c_regs):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 over the 32 lanes' registers
    (the PTX ISA's fragment maps; lane = 4*group + tig):
      A (16x32): reg i byte e -> row group + 8*(i odd), col 4*tig + e + 16*(i >= 2)
      B (32x8):  reg i byte e -> row 4*tig + e + 16*i, col group
      C (16x8):  reg i        -> row group + 8*(i >= 2), col 2*tig + (i & 1)"""
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        grp, tig = lane >> 2, lane & 3
        for i in range(4):
            for e in range(4):
                a[grp + 8 * (i & 1), 4 * tig + e + 16 * (i >> 1)] = np.int8(
                    np.uint8(_byte(a_regs[lane][i], e)))
        for i in range(2):
            for e in range(4):
                b[4 * tig + e + 16 * i, grp] = np.int8(np.uint8(_byte(b_regs[lane][i], e)))
    d = a @ b
    for lane in range(32):
        grp, tig = lane >> 2, lane & 3
        for i in range(4):
            c_regs[lane][i] += int(d[grp + 8 * (i >> 1), 2 * tig + (i & 1)])


def _pack2(lo, hi):
    return (lo & 0xFFFF) | ((hi & 0xFFFF) << 16)


def _vmins2(x, y):
    def half(v, s):
        h = (v >> s) & 0xFFFF
        return h - 0x10000 if h & 0x8000 else h
    return _pack2(min(half(x, 0), half(y, 0)), min(half(x, 16), half(y, 16)))


def _reduce_rows(x):
    """x: (32 lanes, 8 rows) packed words -> (32,) the lane's row gl, as
    scan_mma.cu's reduce_rows exchanges them (xor 16, 8, 4)."""
    x = [list(r) for r in x]
    for width, xor in ((4, 16), (2, 8), (1, 4)):
        new = []
        for lane in range(32):
            up = (lane >> 2) & width
            other = x[lane ^ xor]
            row = []
            for k in range(width):
                keep = x[lane][k + width] if up else x[lane][k]
                send = other[k + width] if up else other[k]    # what the partner sends
                row.append(_vmins2(keep, send))
            new.append(row)
        x = new
    return [r[0] for r in x]


def emulate_oct(codes_p, tables, pairs, size, oct_, cb, tiles, lanes=None):
    """One warp's oct `oct_` of one group's partition codes_p (rpp, 128)
    against its live pairs (at most 8 * tiles), as scan_mma.cu's load_tiles
    and scan_oct run it. Returns {(pair, row): value} for the oct's rows
    below rpp; `lanes`, a list, gets each N tile's 32 reduced words (row gl
    in lane gl * 4 + t), what scan_oct folds into its tile minima. k-step
    2q + h of a code covers its nibbles N_i (i = 0..3: the low and high
    nibbles of bytes 2q, 2q + 1) at the values 8h + t (k = 4t + i) and 8h +
    4 + t (k = 16 + 4t + i)."""
    rpp = codes_p.shape[0]
    cpr, rows_per_tile = 128 // cb, cb // 8
    rows = min(rpp, -(-size // cpr)) if size > 0 else 0
    tab = tables.numpy().view(np.uint8).reshape(tables.shape[0], 2 * cb, 16)
    bt = []                                                    # per tile, k-step, lane: (b0, b1)
    for j in range(tiles):
        regs = [[[0, 0] for _ in range(32)] for _ in range(cb)]
        for lane in range(32):
            s, t = 8 * j + (lane >> 2), lane & 3
            if s < len(pairs):
                for q in range(cb // 2):
                    for h in range(2):
                        regs[2 * q + h][lane] = [
                            sum(int(tab[pairs[s], 4 * q + i, 8 * h + e + t]) << (8 * i)
                                for i in range(4)) for e in (0, 4)]
        bt.append(regs)
    x = np.full((tiles, 32, OCT), _pack2(NONE16, NONE16), dtype=np.int64)
    for mt in range(OCT // rows_per_tile):
        r = oct_ * OCT + mt * rows_per_tile
        if r >= rows:
            continue
        row_bytes = [codes_p[k].numpy() if k < rpp else np.zeros(128, np.uint8)
                     for k in (r, r + 1)]
        acc = [[[0] * 4 for _ in range(32)] for _ in range(tiles)]
        for kk in range(cb):
            wi, qh = kk // 4, kk % 4
            a_regs = []
            for lane in range(32):
                gl, t = lane >> 2, lane & 3
                if cb == 8:                                    # codes gl and gl + 8 of the row
                    up, down = row_bytes[0][8 * gl:8 * gl + 8], row_bytes[0][64 + 8 * gl:72 + 8 * gl]
                else:                                          # code gl of two rows
                    up, down = row_bytes[0][16 * gl:16 * gl + 16], row_bytes[1][16 * gl:16 * gl + 16]
                sel = []
                for code in (up, down):
                    w = int(code[4 * wi:4 * wi + 4].copy().view("<u4")[0])
                    w = w ^ 0x88888888 if qh & 1 else w
                    sel.append(w >> 16 if qh >= 2 else w)
                one = 1 << (8 * t)
                a_regs.append([_prmt(one, 0, sel[0]), _prmt(one, 0, sel[1]),
                               _prmt(0, one, sel[0]), _prmt(0, one, sel[1])])
            for j in range(tiles):
                _mma(a_regs, bt[j][kk], acc[j])
        real = size - r * cpr
        for j in range(tiles):
            for lane in range(32):
                gl = lane >> 2
                lo0, hi0, lo1, hi1 = acc[j][lane]
                if cb == 8:
                    if gl >= real:
                        lo0 = hi0 = NONE16
                    if gl + 8 >= real:
                        lo1 = hi1 = NONE16
                    x[j, lane, mt] = _pack2(min(lo0, lo1), min(hi0, hi1))
                else:
                    if gl >= real:
                        lo0 = hi0 = NONE16
                    if gl >= real - cpr:
                        lo1 = hi1 = NONE16
                    x[j, lane, 2 * mt], x[j, lane, 2 * mt + 1] = _pack2(lo0, hi0), _pack2(lo1, hi1)
    out = {}
    for j in range(tiles):
        v = _reduce_rows(x[j])
        if lanes is not None:
            lanes.append(v)
        for lane in range(32):
            gl, t = lane >> 2, lane & 3
            row = oct_ * OCT + gl
            for e in range(2):
                s = 8 * j + 2 * t + e
                h = (v[lane] >> (16 * e)) & 0xFFFF
                h = h - 0x10000 if h & 0x8000 else h
                if row < rpp and s < len(pairs):
                    key = (pairs[s], row)
                    assert out.get(key, h) == h                 # the 8 lanes of a row agree
                    out[key] = lut_scan.TRIM_SENTINEL if h == NONE16 else h
    return out


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("live,size", [(3, 0), (3, 1), (8, 150), (11, -5)])   # -5: 5 short
def test_warp_emulation_reproduces_grouped_scan_plain(m, live, size):
    cb, cpr = m // 2, 256 // m
    rng = np.random.default_rng(m + live)
    rpp = 19                                                   # a partial oct at the end
    size = rpp * cpr + size if size < 0 else size
    codes = torch.from_numpy(rng.integers(0, 256, (1, rpp, 128), dtype=np.uint8))
    tables = torch.from_numpy(rng.integers(-128, 128, (live, m, 16)).astype(np.int8))
    slot_pair = torch.full((1, 16), -1, dtype=torch.int32)
    slot_pair[0, :live] = torch.from_numpy(rng.permutation(live).astype(np.int32))
    args = [codes, tables, torch.zeros(1, dtype=torch.int32), slot_pair,
            torch.tensor([size], dtype=torch.int32)]
    want = lut_scan.grouped_scan_plain(*args)
    packed, _, _ = lut_scan.grouped_scan_mma_plan(slot_pair, args[4], rpp, cb, 1)
    pairs = packed[0, :live].tolist()
    rows = min(rpp, -(-size // cpr))
    octs = -(-rows // OCT)
    for oct_ in sorted({0, octs - 1} - {-1}):
        got = emulate_oct(codes[0], tables, pairs, size, oct_, cb, -(-live // 8))
        assert len(got) == live * min(OCT, rpp - oct_ * OCT)
        for (p, row), v in got.items():
            assert v == want[p, row], (p, row)


def _merge_tile(words):
    """scan_mma.cu's merge_tiles: the lanes' folded row minima to the
    minimum over the eight rows gl of each column pair (exchanges xor 4, 8,
    16), in every lane."""
    x = list(words)
    for xor in (4, 8, 16):
        x = [_vmins2(x[lane], x[lane ^ xor]) for lane in range(32)]
    return x


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("live,size", [(3, 0), (3, 37), (8, 150), (11, -5)])   # -5: 5 short
def test_warp_emulation_folds_the_tile_minima(m, live, size):
    """A warp's fold of each oct's reduced words into a tile (one 16-bit
    min a lane an oct) and merge_tiles' exchanges give, in lanes t = 0..3,
    columns 2t and 2t + 1's tile minima: grouped_scan_plain's, +inf where
    no real row is (the merge skips them; the plan's +inf stays)."""
    cb, cpr = m // 2, 256 // m
    rng = np.random.default_rng(m + live + 1)
    rpp = 2 * lut_scan.TILE
    size = rpp * cpr + size if size < 0 else size
    codes = torch.from_numpy(rng.integers(0, 256, (1, rpp, 128), dtype=np.uint8))
    tables = torch.from_numpy(rng.integers(-128, 128, (live, m, 16)).astype(np.int8))
    slot_pair = torch.full((1, 16), -1, dtype=torch.int32)
    slot_pair[0, :live] = torch.from_numpy(rng.permutation(live).astype(np.int32))
    args = [codes, tables, torch.zeros(1, dtype=torch.int32), slot_pair,
            torch.tensor([size], dtype=torch.int32)]
    _, want = lut_scan.grouped_scan_plain(*args, True)
    packed, _, _ = lut_scan.grouped_scan_mma_plan(slot_pair, args[4], rpp, cb, 1)
    pairs, ntiles = packed[0, :live].tolist(), -(-live // 8)
    octs = -(-min(rpp, -(-size // cpr)) // OCT) if size else 0
    per_tile = lut_scan.TILE // OCT
    got = torch.full_like(want, float("inf"))
    for t in range(-(-octs // per_tile)):
        acc = [[_pack2(NONE16, NONE16)] * 32 for _ in range(ntiles)]
        for o in range(t * per_tile, min(octs, (t + 1) * per_tile)):
            words = []
            emulate_oct(codes[0], tables, pairs, size, o, cb, ntiles, lanes=words)
            acc = [[_vmins2(a, w) for a, w in zip(aj, wj)] for aj, wj in zip(acc, words)]
        for j in range(ntiles):
            folded = _merge_tile(acc[j])
            for lane in range(4):
                for e in range(2):
                    s = 8 * j + 2 * lane + e
                    h = (folded[lane] >> (16 * e)) & 0xFFFF
                    h = h - 0x10000 if h & 0x8000 else h
                    if s < live and h != NONE16:
                        got[pairs[s], t] = float(h)
    assert torch.equal(got, want)


def test_reduce_rows_leaves_row_gl_in_every_lane():
    rng = np.random.default_rng(3)
    lanes = rng.integers(-4096, 4065, (32, OCT, 2))
    x = [[_pack2(int(lo), int(hi)) for lo, hi in row] for row in lanes]
    got = _reduce_rows(x)
    for lane in range(32):
        gl, t = lane >> 2, lane & 3
        col = lanes[[4 * g + t for g in range(8)], gl]             # row gl over the column's lanes
        assert got[lane] == _pack2(int(col[:, 0].min()), int(col[:, 1].min()))


# ---------------------------------------------------------------- (d) the tile minima


def tile_merges(walks, slot_pair, held: int):
    """The tile merges of M1's scan with tile_minima (scan_mma.cu's
    merge_tiles calls), from its walks (lut_scan.grouped_scan_mma_walk): per
    warp, in order, (group, tile, chunk, octs), the octs whose row minima one
    merge (an atomic minimum a pair) carries. A group of one chunk of `held`
    N tiles merges where the warp's walk leaves a tile: at its fourth oct,
    or where the walk leaves the group (its last real oct, the end of the
    warp's share); a group of more chunks merges each oct's, a chunk at a
    time."""
    live = (slot_pair >= 0).sum(dim=1).tolist()
    per_tile = lut_scan.TILE // OCT
    merges = []
    for walk in walks:
        mine, octs = [], []
        for i, (grp, o) in enumerate(walk):
            chunks = -(-live[grp] // (8 * held))
            if chunks > 1:
                mine += [(grp, o // per_tile, ch, [o]) for ch in range(chunks)]
                continue
            octs.append(o)
            if o % per_tile == per_tile - 1 or walk[i + 1:i + 2] != [(grp, o + 1)]:
                mine.append((grp, o // per_tile, 0, octs))
                octs = []
        merges.append(mine)
    return merges


def _masked(rows):
    return torch.where(rows < lut_scan.TRIM_SENTINEL, rows.to(torch.float32), torch.inf)


@pytest.mark.parametrize("m", [16, 32])
def test_plain_tile_minima_are_the_masked_rows_amin(m):
    args, _ = scan_inputs(sparse_case(m, 9), m, 9)
    rows, tiles = lut_scan.grouped_scan_plain(*args, True)
    assert torch.equal(rows, lut_scan.grouped_scan_plain(*args))
    assert tiles.dtype == torch.float32 and tiles.shape == (rows.shape[0], rows.shape[1] // 32)
    assert torch.equal(tiles, _masked(rows).reshape(rows.shape[0], -1, 32).amin(-1))
    assert torch.isinf(tiles).any() and torch.isfinite(tiles).any()
    got = lut_scan.grouped_scan(*args, True)                   # the wrapper: the plain version
    assert torch.equal(got[0], rows) and torch.equal(got[1], tiles)


def test_tile_minima_need_int8_tables_and_whole_tiles():
    m = 16
    args, _ = scan_inputs(dense_case(m, 4), m, 4)              # rpp 40
    with pytest.raises(ValueError, match="tile minima"):
        lut_scan.grouped_scan(*args, True)
    args, _ = scan_inputs(dense_case(m, 4, rpp=64), m, 4)
    args[1] = args[1].to(torch.float32)
    with pytest.raises(ValueError, match="tile minima"):
        lut_scan.grouped_scan(*args, True)


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("kind,warps", [("sparse", 264 * 8), ("sparse", 7), ("dense", 264 * 8),
                                        ("dense", 3), ("dense", 1)])
def test_tile_merges_cover_each_real_tile_and_give_its_minimum(m, kind, warps):
    cb = m // 2
    case = sparse_case(m, 6) if kind == "sparse" else dense_case(m, 6, rpp=64)
    args, _ = scan_inputs(case, m, 6)
    codes, tables, _, slot_pair, g_sz = args
    rpp, per_tile = codes.shape[1], lut_scan.TILE // OCT
    held = lut_scan.grouped_mma_tiles(cb, tables.shape[0], codes.shape[0])
    walks, _ = lut_scan.grouped_scan_mma_walk(slot_pair, g_sz, rpp, cb, held, warps)
    merges = tile_merges(walks, slot_pair, held)
    packed, live, _ = lut_scan.grouped_scan_mma_plan(slot_pair, g_sz, rpp, cb, held)
    chunk = 8 * held
    chunks = [-(-int(n) // chunk) for n in live]
    real, rows_of = _real_octs(slot_pair, g_sz, rpp, 128 // cb)
    carried = [(g, ch, o) for mine in merges for g, t, ch, octs in mine for o in octs]
    assert sorted(carried) == sorted((g, ch, o) for g, o in real for ch in range(chunks[g]))
    assert all(o // per_tile == t for mine in merges for _, t, _, octs in mine for o in octs)
    writers = {}
    for w, mine in enumerate(merges):
        for g, t, _, _ in mine:
            writers.setdefault((g, t), set()).add(w)
    assert set(writers) == {(g, o // per_tile) for g, o in real}   # every real tile, no other
    rows, want = lut_scan.grouped_scan_plain(*args, True)
    masked = _masked(rows)
    got = torch.full_like(want, float("inf"))                  # the plan's fill: every pair is live
    for mine in merges:
        for g, t, ch, octs in mine:
            pairs = packed[g, ch * chunk:(ch + 1) * chunk]
            pairs = pairs[pairs >= 0].long()
            cols = torch.tensor([o * OCT + i for o in octs for i in range(OCT)])
            got[pairs, t] = torch.minimum(got[pairs, t], masked[pairs][:, cols].amin(-1))
    assert torch.equal(got, want)
    split = [k for k, ws in writers.items() if len(ws) > 1]
    if warps > 100 or (kind == "sparse" and warps > 1):
        assert split                                           # share boundaries cut tiles
    if warps == 1:
        assert not split


# ---------------------------------------------------------------- on the card


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_grouped_scan_equals_plain_whole_output(cuda, m, kind):
    case = (sparse_case if kind == "sparse" else dense_case)(m, 30 + m)
    args, n_groups = scan_inputs(case, m, 30 + m)
    assert args[3].shape[0] > n_groups                         # groups past n_groups
    want = lut_scan.grouped_scan_plain(*args)
    before = lut_scan.launches["grouped_scan"]
    got = lut_scan.grouped_scan(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert lut_scan.launches["grouped_scan"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("m", [16, 32])
def test_grouped_scan_graph_replay_equals_eager(cuda, m):
    """A graph captured on one batch's inputs, replayed on another's copied
    into them, equals the eager call on the other's."""
    case = sparse_case(m, 50)
    args, _ = scan_inputs(case, m, 50)
    other, _ = scan_inputs((case[0], case[1], case[2][::-1].copy(), case[3], case[4]), m, 51)
    assert other[3].shape == args[3].shape and other[1].shape == args[1].shape
    static = [a.to(cuda) for a in args]
    lut_scan.grouped_scan(*static)                             # the kernels loaded
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = lut_scan.grouped_scan(*static)
    for s, o in zip(static, other):
        s.copy_(o.to(cuda))
    graph.replay()
    eager = lut_scan.grouped_scan(*[o.to(cuda) for o in other])
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    assert torch.equal(eager.cpu(), lut_scan.grouped_scan_plain(*other))


@pytest.mark.parametrize("m", [16, 32])
def test_scan_rows_is_the_kernels_own_count(cuda, m):
    """In a recording, M1 counts `scan.rows` from its prefix kernel (no op
    of its own): the real rows of the live groups, as grouped_scan_rows
    sums them; off, it records nothing."""
    args, _ = scan_inputs(sparse_case(m, 70), m, 70)
    want = int(lut_scan.grouped_scan_rows(args[3], args[4], args[0].shape[1], 256 // m).sum())
    dargs = [a.to(cuda) for a in args]
    with recording() as rec:
        lut_scan.grouped_scan(*dargs)
    assert [(c.name, c.value) for c in rec.counts] == [("scan.rows", want)]
    with recording() as rec:
        lut_scan.grouped_scan(*args)                           # the plain version counts too
    assert [(c.name, c.value) for c in rec.counts] == [("scan.rows", want)]


def _card_warps(device) -> int:
    """M1's scan warps on the card: one wave of two blocks of 8 warps an SM
    (its launch bounds; the resident count the launcher asks is at most 2)."""
    return torch.cuda.get_device_properties(device).multi_processor_count * 2 * 8


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("kind", ["sparse", "dense"])
def test_grouped_scan_tile_minima_equal_plain(cuda, m, kind):
    """With tile_minima the rows are grouped_scan_plain's, sentinel rows
    included, and the tile minima its amin over the masked float rows bit
    for bit: an empty partition all +inf, tiles holding real and sentinel
    rows, tiles cut between warps by their shares of the cost prefix."""
    seed = 80 + m
    case = sparse_case(m, seed) if kind == "sparse" else dense_case(m, seed, rpp=64)
    args, _ = scan_inputs(case, m, seed)
    want_rows, want = lut_scan.grouped_scan_plain(*args, True)
    rows, tiles = lut_scan.grouped_scan(*[a.to(cuda) for a in args], True)
    torch.cuda.synchronize()
    assert torch.equal(rows.cpu(), want_rows) and torch.equal(tiles.cpu(), want)
    cb, rpp = m // 2, args[0].shape[1]
    empty = torch.nonzero(args[4] == 0).flatten()
    live_empty = args[3][empty][args[3][empty] >= 0].long()
    assert torch.isinf(want[live_empty]).all()                 # an empty partition's pairs
    if kind == "sparse":
        assert live_empty.numel()
        held = lut_scan.grouped_mma_tiles(cb, args[1].shape[0], args[0].shape[0])
        for warps in (_card_warps(cuda), _card_warps(cuda) // 2):
            walks, _ = lut_scan.grouped_scan_mma_walk(args[3], args[4], rpp, cb, held, warps)
            merges = tile_merges(walks, args[3], held)
            writers = {}
            for w, mine in enumerate(merges):
                for g, t, _, _ in mine:
                    writers.setdefault((g, t), set()).add(w)
            assert any(len(ws) > 1 for ws in writers.values())  # tiles cut by share boundaries


@pytest.mark.parametrize("m", [16, 32])
def test_grouped_scan_tile_minima_under_graph_replay(cuda, m):
    """A graph of the call with tile_minima, captured on one batch and
    replayed on another's inputs, gives the eager call's rows and tiles."""
    case = sparse_case(m, 90)
    args, _ = scan_inputs(case, m, 90)
    other, _ = scan_inputs((case[0], case[1], case[2][::-1].copy(), case[3], case[4]), m, 91)
    static = [a.to(cuda) for a in args]
    lut_scan.grouped_scan(*static, True)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        rows, tiles = lut_scan.grouped_scan(*static, True)
    for s, o in zip(static, other):
        s.copy_(o.to(cuda))
    graph.replay()
    eager = lut_scan.grouped_scan(*[o.to(cuda) for o in other], True)
    torch.cuda.synchronize()
    assert torch.equal(rows, eager[0]) and torch.equal(tiles, eager[1])
    want = lut_scan.grouped_scan_plain(*other, True)
    assert torch.equal(eager[0].cpu(), want[0]) and torch.equal(eager[1].cpu(), want[1])
