"""The tensor-core formulation of the 4-bit int8 scans, on the CPU.

csrc/scan_mma.cuh computes flat_scan and M1 (int8 tables) as an int8 product
of the tables with the codes' one-hot. The kernel runs only on a card; what
can be held here is its arithmetic and its index maps:

  (a) scan_onehot_plain / grouped_scan_onehot_plain (the kernel's arithmetic
      in PyTorch) equal flat_scan_plain / grouped_scan_plain exactly, minima
      and argmin indices;
  (b) they equal the JAX kernels lut_scan_tq / lut_scan_reduce and
      lut_scan_grouped_tq / lut_scan_grouped_prefetch run in interpret mode
      on the same numpy inputs, exactly, on every window with a real code;
  (c) a lane-by-lane emulation of one warp (A words from the table bytes, B
      words from the one-hot rule, the m16n8k32 fragment maps of the PTX
      ISA, the C positions, the two xor-shuffles) reproduces flat_scan_plain;
  (d) the packed minimum (sum << 4) | position returns the lowest tied code.
Tolerance: exact everywhere (int32 sums of int8 entries).
"""

import numpy as np
import pytest
import torch

from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.index.routing import route_queries
from qadc_tpu_torch.kernels import lut_scan, scan_lab
from test_torch_flat_kernels import N as FLAT_N
from test_torch_flat_kernels import _codes, _jax_scan4, _tables4
from test_torch_grouped_scan import MASKED, _case, _jax_minima
from torch_parity import to_port

INT_MAX = np.iinfo(np.int32).max


def _inputs(m, q, r_count, seed, high=128):
    g = np.random.default_rng(seed)
    codes = torch.from_numpy(g.integers(0, 256, (r_count, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(0, high, (q, m, 16)).astype(np.int8))
    return codes, tables


# ---------------------------------------------------------------- (a) flat


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("q", [1, 5, 17, 128])
@pytest.mark.parametrize("n_kind", ["mid_row", "zero", "all", "one"])
def test_onehot_plain_equals_flat_scan_plain(m, q, n_kind):
    cpr = 256 // m
    r_count = 37                                   # ragged: not a multiple of a quad of rows
    codes, tables = _inputs(m, q, r_count, 10 * m + q)
    n = {"mid_row": r_count * cpr - 5 * cpr - 3, "zero": 0, "all": r_count * cpr, "one": 1}[n_kind]
    want_v, want_i = lut_scan.flat_scan_plain(codes, tables, n, True)
    got_v, got_i = lut_scan.scan_onehot_plain(codes, tables, n, True, chunk_rows=16)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    mins, none = lut_scan.scan_onehot_plain(codes, tables, n)
    assert none is None and torch.equal(mins, want_v)
    if n_kind == "zero":
        assert (mins == lut_scan.TRIM_SENTINEL).all() and (got_i == -1).all()


@pytest.mark.parametrize("m", [16, 32])
def test_onehot_plain_takes_negative_entries(m):
    """int8 entries are signed in the product, as the plain version reads them."""
    g = np.random.default_rng(m)
    codes = torch.from_numpy(g.integers(0, 256, (9, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(-128, 128, (7, m, 16)).astype(np.int8))
    assert torch.equal(lut_scan.scan_onehot_plain(codes, tables, 9 * 256 // m)[0],
                       lut_scan.flat_scan_plain(codes, tables, 9 * 256 // m)[0])


@pytest.mark.parametrize("name", ["all_127", "all_0", "one_hot_rows", "random"])
@pytest.mark.parametrize("m", [16, 32])
def test_exactness_probe_tables_on_cpu(m, name):
    """The lab's adversarial tables through both plain formulations: the
    largest sum is 127 * m, and nothing differs."""
    codes, _ = _inputs(m, 1, 24, 3)
    n = 24 * 256 // m - 5
    tables = scan_lab.adversarial_tables(m, 9, 0, "cpu")[name]
    got = lut_scan.scan_onehot_plain(codes, tables, n)[0]
    assert torch.equal(got, lut_scan.flat_scan_plain(codes, tables, n)[0])
    if name == "all_127":
        assert (got == 127 * m).all()
    bad = scan_lab.exactness_probe(codes, n, m, 9, scan=lut_scan.scan_onehot_plain,
                                   reference=lut_scan.flat_scan_plain)
    assert bad[name] == 0 and set(bad) == {"all_127", "all_0", "one_hot_rows", "random"}


# ---------------------------------------------------------------- (a) grouped


def _groups(g, sizes, rpp, cpr, q, ma, group_size):
    """Routed groups over random probes of partitions of the given sizes."""
    parts = len(sizes)
    pids = torch.from_numpy(g.integers(0, parts, (q, ma)).astype(np.int32))
    routed = route_queries(pids, parts, group_size=group_size)
    sz = torch.tensor(sizes, dtype=torch.int32)
    g_sz = torch.where(routed.group_valid, sz[routed.group_part.long()], 0)
    return [routed.group_part, routed.slot_pairs(), g_sz.to(torch.int32)]


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("group_size", [4, 16, 128])
@pytest.mark.parametrize("q", [1, 9, 40])
def test_onehot_plain_equals_grouped_scan_plain(m, group_size, q):
    g = np.random.default_rng(100 * m + group_size + q)
    cpr = 256 // m
    rpp, ma = 50, 4
    sizes = [0, 1, 17, rpp * cpr, 277, 600]        # empty, one code, mid-row, full, 277
    codes = torch.from_numpy(g.integers(0, 256, (len(sizes), rpp, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(0, 128, (q * ma, m, 16)).astype(np.int8))
    groups = _groups(g, sizes, rpp, cpr, q, ma, group_size)
    slot_pair = groups[1]
    assert (slot_pair < 0).any()                   # empty slots
    want = lut_scan.grouped_scan_plain(codes, tables, *groups)
    got = lut_scan.grouped_scan_onehot_plain(codes, tables, *groups)
    assert torch.equal(got, want)
    assert (got < lut_scan.TRIM_SENTINEL).any() and (got == lut_scan.TRIM_SENTINEL).any()


def test_onehot_plain_group_with_no_live_slot():
    """A group whose slots are all empty writes nothing; one live slot in a
    group of 128 is scanned."""
    g = np.random.default_rng(5)
    codes = torch.from_numpy(g.integers(0, 256, (2, 20, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(0, 128, (3, 16, 16)).astype(np.int8))
    slot_pair = torch.full((2, 128), -1, dtype=torch.int32)
    slot_pair[1, 77] = 2
    args = (codes, tables, torch.tensor([0, 1], dtype=torch.int32), slot_pair,
            torch.tensor([320, 277], dtype=torch.int32))
    want = lut_scan.grouped_scan_plain(*args)
    got = lut_scan.grouped_scan_onehot_plain(*args)
    assert torch.equal(got, want)
    assert (got[:2] == lut_scan.TRIM_SENTINEL).all() and (got[2, :18] < 127 * 16 + 1).all()
    assert (got[2, 18:] == lut_scan.TRIM_SENTINEL).all()   # ceil(277 / 16) = 18 rows


# ---------------------------------------------------------------- (b) the JAX kernels


@pytest.mark.parametrize("planes", [True, False], ids=["tq", "row128"])
@pytest.mark.parametrize("m", [16, 32])
def test_onehot_plain_matches_jax_flat_kernels(m, planes):
    codes, tables = _codes(m // 2), _tables4(m, False)
    got = lut_scan.scan_onehot_plain(torch.from_numpy(codes), torch.from_numpy(tables),
                                     FLAT_N)[0].numpy()
    real = np.arange(codes.shape[0]) * (256 // m) < FLAT_N
    assert not real.all()
    want = _jax_scan4(codes, tables, planes)
    np.testing.assert_array_equal(got[:, real], want[:, real])
    assert (got[:, ~real] == lut_scan.TRIM_SENTINEL).all()


@pytest.mark.parametrize("kind", ["row128", "tq"])
def test_onehot_plain_matches_jax_grouped_kernels(kind):
    jindex, parts, qtables = _case(kind)
    want, jvalid = _jax_minima(jindex, parts, qtables)
    tindex = to_port(jindex)
    q, ma = parts.shape
    routed = route_queries(torch.from_numpy(parts), tindex.part_count, 128)
    out = lut_scan.grouped_scan_onehot_plain(
        tindex.codes, torch.from_numpy(qtables), routed.group_part, routed.slot_pairs(),
        ivf._group_sizes(tindex, routed))
    sz = tindex.part_sizes[torch.from_numpy(parts.reshape(q * ma)).long()]
    valid = ivf._window_valid_mask(sz, tindex.codes.shape[1], tindex.cpr).numpy()
    np.testing.assert_array_equal(valid, jvalid)
    assert jvalid.any()
    np.testing.assert_array_equal(np.where(valid, out.numpy(), MASKED), want)


# ---------------------------------------------------------------- (c) one warp, lane by lane


def _shl_clamp(x, s):
    """PTX shl.b32: a shift of 32 or more gives zero."""
    return (x << s) & 0xFFFFFFFF if s < 32 else 0


def _byte(word, i):
    return (word >> (8 * i)) & 0xFF


def _mma_m16n8k32(a_regs, b_regs, c_regs):
    """mma.sync.m16n8k32.row.col.s32.s8.s8.s32 over the 32 lanes' registers,
    by the PTX ISA's fragment maps: lane = 4*group + tig;
      A (16x32): reg i byte e -> row group + 8*(i odd), col 4*tig + e + 16*(i >= 2)
      B (32x8):  reg i byte e -> row 4*tig + e + 16*i, col group
      C (16x8):  reg i        -> row group + 8*(i >= 2), col 2*tig + (i & 1)
    """
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        grp, tig = lane >> 2, lane & 3
        for i in range(4):
            for e in range(4):
                a[grp + 8 * (i & 1), 4 * tig + e + 16 * (i >> 1)] = np.int8(_byte(a_regs[lane][i], e))
        for i in range(2):
            for e in range(4):
                b[4 * tig + e + 16 * i, grp] = np.int8(_byte(b_regs[lane][i], e))
    d = a @ b
    for lane in range(32):
        grp, tig = lane >> 2, lane & 3
        for i in range(4):
            c_regs[lane][i] += int(d[grp + 8 * (i >> 1), 2 * tig + (i & 1)])


def _emulate_warp_row(table16, row_bytes, real, cb, with_rows):
    """One warp, one m-tile, one storage row, as scan_mma.cuh runs it.
    table16: (16, 32*cb) uint8 view of 16 queries' tables; row_bytes: (128,)
    uint8. Returns the 16 queries' minima (packed when with_rows)."""
    cpr = 128 // cb
    tiles, words = cpr // 8, cb // 4
    tab_words = table16.reshape(16, -1).copy().view("<u4")           # (16, 8*cb)
    row_words = row_bytes.copy().view("<u4")                         # (32,)
    c = [[[0] * 4 for _ in range(32)] for _ in range(tiles)]
    for wi in range(words):
        for i in range(4):
            kstep = wi * 4 + i
            for tile in range(tiles):
                a_regs, b_regs = [], []
                for lane in range(32):
                    grp, tig = lane >> 2, lane & 3
                    a_regs.append([int(tab_words[grp + 8 * h, 8 * kstep + 4 * hi + tig])
                                   for hi in range(2) for h in range(2)])
                    word = int(row_words[4 * grp + tile * words + wi])     # lane's 16 bytes at 16*grp
                    tsel = 0x20202020 * tig
                    wl = (((word << 3) & 0x78787878) ^ tsel)
                    wh = (((word >> 1) & 0x78787878) ^ tsel)
                    b_regs.append([_shl_clamp(1, _byte(wl, i)), _shl_clamp(1, _byte(wh, i))])
                _mma_m16n8k32(a_regs, b_regs, c[tile])
    v = np.zeros((32, 2), np.int64)
    for lane in range(32):
        tig = lane & 3
        for h in range(2):
            m = INT_MAX
            for tile in range(tiles):
                for ci in range(2):
                    code = 2 * (2 * tig + ci) + tile if cb == 8 else 2 * tig + ci
                    x = c[tile][lane][2 * h + ci]
                    if with_rows:
                        x = (x << 4) | code
                    if code >= real:
                        x = INT_MAX
                    m = min(m, x)
            v[lane, h] = m
    for xor in (1, 2):                                               # the two shuffles
        v = np.minimum(v, v[np.arange(32) ^ xor])
    out = np.zeros(16, np.int64)
    for lane in range(32):
        assert (v[lane] == v[lane & ~3]).all()                       # every lane of a group agrees
        out[lane >> 2], out[(lane >> 2) + 8] = v[lane]
    return out


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("with_rows", [False, True])
def test_warp_emulation_reproduces_flat_scan_plain(m, with_rows):
    cb, cpr = m // 2, 256 // m
    r_count = 5
    codes, tables = _inputs(m, 16, r_count, 77 + m, high=6)          # ties inside a row
    n = r_count * cpr - 3                                            # the last row partly real
    want_v, want_i = lut_scan.flat_scan_plain(codes, tables, n, True)
    table16 = tables.numpy().view(np.uint8).reshape(16, 32 * cb)
    for row in range(r_count):
        got = _emulate_warp_row(table16, codes[row].numpy(), n - row * cpr, cb, with_rows)
        if with_rows:
            np.testing.assert_array_equal(got >> 4, want_v[:, row].numpy())
            np.testing.assert_array_equal(row * cpr + (got & 15), want_i[:, row].numpy())
        else:
            np.testing.assert_array_equal(got, want_v[:, row].numpy())


def test_onehot_lane_word_rule():
    """shl(1, ((nibble << 3) ^ (t << 5))) is byte nibble & 3 of lane t's word
    when nibble >> 2 == t, and zero otherwise, for all 16 nibbles."""
    for nib in range(16):
        for t in range(4):
            got = _shl_clamp(1, (nib << 3) ^ (t << 5))
            want = 1 << (8 * (nib & 3)) if nib >> 2 == t else 0
            assert got == want


# ---------------------------------------------------------------- (d) packed argmin


@pytest.mark.parametrize("m", [16, 32])
def test_packed_argmin_returns_lowest_tied_code(m):
    cpr = 256 // m
    codes, _ = _inputs(m, 1, 11, 9)
    zeros = torch.zeros((3, m, 16), dtype=torch.int8)                # every code ties at 0
    n = 11 * cpr - 2
    mins, idx = lut_scan.scan_onehot_plain(codes, zeros, n, with_rows=True)
    assert (mins == 0).all()
    assert torch.equal(idx, (torch.arange(11, dtype=torch.int32) * cpr).expand(3, 11))
    # Few distinct entries: many ties, every index the first code holding the minimum.
    _, tables = _inputs(m, 6, 11, 19, high=2)
    mins, idx = lut_scan.scan_onehot_plain(codes, tables, n, with_rows=True)
    want_v, want_i = lut_scan.flat_scan_plain(codes, tables, n, with_rows=True)
    assert torch.equal(mins, want_v) and torch.equal(idx, want_i)


# ---------------------------------------------------------------- the lab on the CPU


def test_scan_lab_plain_modes():
    codes, tables = _inputs(16, 5, 12, 4)
    n = 12 * 16 - 7
    want = lut_scan.flat_scan_plain(codes, tables, n)[0]
    for mode in ("full", "full_mt2", "full_mt1", "wg_full"):
        assert torch.equal(scan_lab.scan_lab(codes, tables, n, mode), want)
    assert (scan_lab.scan_lab(codes, tables, n, "copy") == lut_scan.TRIM_SENTINEL).all()
    for mode in ("no_min", "wg_skeleton", "wg_acc_only"):
        with pytest.raises(RuntimeError):
            scan_lab.scan_lab(codes, tables, n, mode)
    with pytest.raises(KeyError):
        scan_lab.scan_lab(codes, tables, n, "nope")
    assert {bits for bits, _, _ in scan_lab.LAB_MODES.values()} == set(range(8))


@pytest.mark.parametrize("cb", [8, 16])
def test_selector_sum_plain_holds_float64(cb):
    x = torch.from_numpy(np.random.default_rng(11).uniform(0, 500, (512, 128)).astype(np.float32))
    got = scan_lab.selector_sum(x, cb).double()
    want = x.double().reshape(512, 128 // cb, cb).sum(-1)
    assert float(((got - want).abs() / want.abs().clamp(min=1e-9)).max()) < 1e-6


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("rows", [1, 7, 513])
def test_selector_sum_plain_holds_float64_at_any_rows(rows, cb):
    """Row counts that are not a multiple of the kernel's four rows a block."""
    x = torch.from_numpy(np.random.default_rng(rows).uniform(0, 500, (rows, 128)).astype(np.float32))
    got = scan_lab.selector_sum(x, cb).double()
    assert got.shape == (rows, 128 // cb)
    want = x.double().reshape(rows, 128 // cb, cb).sum(-1)
    assert float(((got - want).abs() / want.abs().clamp(min=1e-9)).max()) < 1e-6
