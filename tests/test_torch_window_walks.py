"""The walks of the two window-scan kernels redesigned for the H100, modelled
in PyTorch where no card is, against the plain version and the Pallas
kernels in interpret mode.

  flat_scan_window_query_minor_plain: the float32 window scan's query-minor
    kernel (csrc/flat_scan_window_qm.cu): tables query-minor in chunks, a
    window's slots in rank order, a strict < and the rank of the minimum.
    Held to flat_scan_window_plain bit for bit (random float tables, padded
    codes inside a block; minima, transposed minima, argmin ids), and to
    lut_scan_reduce(acc_dtype_name="float32") bit for bit on tables of
    multiples of 1/8 (every sum exact in any order: the Pallas kernel sums
    by a one-hot product, the port in rows_adc's order), n = N_pad.
  flat_scan_window_planes_plain: kernel 10's register engine
    (csrc/flat_scan_window_perm4.cu): nibble planes, entries biased to
    unsigned, four lookups by three byte permutes and a select, sums in
    16-bit lanes,
    eight windows a lane (any G = block_n / W) or a fold for G = 1, 2, 4.
    Held to flat_scan_window_plain bit for bit with padding, and to
    lut_scan_vpu_reduce bit for bit at n = N_pad, with tables of all -128
    and all 127 at 32 sub-quantizers (biased lane sums of 0 and 8160: no
    carry between 16-bit lanes).
  The helpers prmt (PTX prmt.b32, sign replication included), vminu2 and
  nibble_planes are held to their definitions, and the select mask (a
  sign-replicating prmt of x << 4 and x) to each nibble's bit 3.
  scan_lab.sass_loops, which counts the register engine's compiled loops
  for its ceiling, is held on a hand-written cuobjdump listing: innermost
  loops only, nested or not, code that a forward branch skips without
  losing a byte permute left out.
  Tolerance: exact throughout.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.kernels import lut_scan as jls
from qadc_tpu_torch.kernels import lut_scan, scan_lab

torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

Q = 5
# (m, block_n, window): the reference tests' SHAPES, G = 4 (16, 64, 16) and
# (32, 8, 2), G = 1 (16, 512, 512), G = 2 (16, 64, 32), and G not a multiple
# of 8: 12 (16, 96, 8), 3 (32, 48, 16), 24 (16, 384, 16).
SHAPES = [(16, 1024, 16), (16, 512, 8), (32, 512, 8), (32, 1024, 16)]
SMALL_G = [(16, 64, 16), (32, 8, 2), (16, 512, 512), (16, 64, 32)]
ODD_G = [(16, 96, 8), (32, 48, 16), (16, 384, 16)]
ALL = SHAPES + SMALL_G + ODD_G
MODES = [{}, {"with_rows": True}, {"transpose_out": True}]
MODE_IDS = ["min", "rows", "transposed"]


def _ids(shapes):
    return [f"m{m}-b{b}-w{w}" for m, b, w in shapes]


@functools.cache
def _codes(m, block_n, blocks=3, seed=0):
    """(blocks * block_n * m / 256, 128) row128 storage of random codes, at
    least 4096 codes for the Pallas kernels' row tiles."""
    blocks = max(blocks, -(-4096 // block_n))
    g = np.random.default_rng([seed, m, block_n])
    return g.integers(0, 256, (blocks * block_n * m // 256, 128), dtype=np.uint8)


def _n_pad(codes, m):
    return codes.shape[0] * (256 // m)


def _padded_n(codes, m, block_n):
    """A real code count that ends inside the last block, not on a window."""
    return _n_pad(codes, m) - block_n // 2 - 3 if block_n > 8 else _n_pad(codes, m) - 13


def _int_tables(m, kind, q=Q, seed=1):
    g = np.random.default_rng([seed, m])
    if kind == "random":
        return g.integers(-128, 128, (q, m, 16)).astype(np.int8)
    if kind == "plateaus":                     # few distinct entries: ties
        return g.integers(0, 4, (q, m, 16)).astype(np.int8)
    return np.full((q, m, 16), {"low": -128, "high": 127}[kind], np.int8)


def _float_tables(m, exact, q=Q, seed=2):
    g = np.random.default_rng([seed, m])
    if exact:                                  # multiples of 1/8 below 8: sums exact
        return (g.integers(0, 64, (q, m, 16)) / 8).astype(np.float32)
    return g.random((q, m, 16)).astype(np.float32)


def _equal(got, want):
    assert torch.equal(got[0], want[0])
    assert got[1] is want[1] is None or torch.equal(got[1], want[1])


# ---- the float32 query-minor walk --------------------------------------------


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("m,block_n,window", ALL, ids=_ids(ALL))
def test_query_minor_walk_matches_plain(m, block_n, window, mode):
    codes = torch.from_numpy(_codes(m, block_n))
    tables = torch.from_numpy(_float_tables(m, False, q=37))
    n = _padded_n(codes, m, block_n)
    walk = lut_scan.flat_scan_window_query_minor_plain(codes, tables, n, block_n, window, **mode)
    _equal(walk, lut_scan.flat_scan_window_plain(codes, tables, n, block_n, window, **mode))


@pytest.mark.parametrize("m", [16, 32])
def test_query_minor_walk_over_chunks(m):
    """130 queries: two chunks of 128 at 16 sub-quantizers, three of 64 at 32."""
    codes = torch.from_numpy(_codes(m, 512))
    tables = torch.from_numpy(_float_tables(m, False, q=130))
    n = _padded_n(codes, m, 512)
    assert -(-130 // lut_scan.flat_scan_chunk(130, m)) == (2 if m == 16 else 3)
    walk = lut_scan.flat_scan_window_query_minor_plain(codes, tables, n, 512, 8, with_rows=True)
    _equal(walk, lut_scan.flat_scan_window_plain(codes, tables, n, 512, 8, with_rows=True))


def _jax_reduce(codes, tables, cb, block_n, window, **kw):
    tlo, thi = jls.build_scan_tables(jnp.asarray(tables))
    vals, rows = jls.lut_scan_reduce(jnp.asarray(codes), tlo, thi, cb=cb, block_n=block_n,
                                     window=window, acc_dtype_name="float32", interpret=True,
                                     **kw)
    return np.asarray(vals), None if rows is None else np.asarray(rows)


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("m,block_n,window", SHAPES + SMALL_G[:2],
                         ids=_ids(SHAPES + SMALL_G[:2]))
def test_query_minor_walk_matches_reference(m, block_n, window, mode):
    """Exact sums: minima and the lowest tied slot's ids equal JAX's."""
    codes = _codes(m, block_n)
    tables = _float_tables(m, True)
    want_v, want_r = _jax_reduce(codes, tables, m // 2, block_n, window, **mode)
    got_v, got_r = lut_scan.flat_scan_window_query_minor_plain(
        torch.from_numpy(codes), torch.from_numpy(tables), _n_pad(codes, m), block_n, window,
        **mode)
    want_v = want_v[:Q] if mode.get("transpose_out") else want_v[:, :Q]
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    if mode.get("with_rows"):
        np.testing.assert_array_equal(got_r.numpy(), want_r[:, :Q])


def test_query_minor_walk_at_cpr_is_flat_scan():
    """At W = cpr a window is a storage row: the walk's minima and ids are
    float flat_scan's with rows, transposed."""
    codes = torch.from_numpy(_codes(16, 1024))
    tables = torch.from_numpy(_float_tables(16, False, q=37))
    n = _padded_n(codes, 16, 1024)
    vals, ids = lut_scan.flat_scan_window_query_minor_plain(codes, tables, n, 1024, 16,
                                                            with_rows=True)
    f_vals, f_ids = lut_scan.flat_scan_plain(codes, tables, n, with_rows=True)
    assert torch.equal(vals.T, f_vals) and torch.equal(ids.T, f_ids)


# ---- the register engine's walk -------------------------------------------------


@pytest.mark.parametrize("kind", ["random", "plateaus"])
@pytest.mark.parametrize("m,block_n,window", ALL, ids=_ids(ALL))
def test_planes_walk_matches_plain(m, block_n, window, kind):
    codes = torch.from_numpy(_codes(m, block_n))
    tables = torch.from_numpy(_int_tables(m, kind, q=37))
    n = _padded_n(codes, m, block_n)
    want, _ = lut_scan.flat_scan_window_plain(codes, tables, n, block_n, window)
    got = lut_scan.flat_scan_window_planes_plain(codes, tables, n, block_n, window)
    assert got.dtype == torch.int32 and torch.equal(got, want)


def test_planes_walk_windows_with_no_real_code():
    """n ends in the first block: the later blocks' windows hold the sentinel."""
    codes = torch.from_numpy(_codes(16, 64))
    tables = torch.from_numpy(_int_tables(16, "random"))
    for block_n, window in ((64, 16), (64, 8), (512, 512)):
        got = lut_scan.flat_scan_window_planes_plain(codes, tables, 40, block_n, window)
        want, _ = lut_scan.flat_scan_window_plain(codes, tables, 40, block_n, window)
        assert torch.equal(got, want)
        assert bool((got[block_n // window:] == lut_scan.TRIM_SENTINEL).all())


@pytest.mark.parametrize("kind", ["random", "low", "high"])
@pytest.mark.parametrize("m,block_n,window", SHAPES + SMALL_G + ODD_G[1:2],
                         ids=_ids(SHAPES + SMALL_G + ODD_G[1:2]))
def test_planes_walk_matches_vpu_reference(m, block_n, window, kind):
    codes = _codes(m, block_n)
    tables = _int_tables(m, kind)
    tlo, thi = jls.build_scan_tables(jnp.asarray(tables))
    want = np.asarray(jls.lut_scan_vpu_reduce(jnp.asarray(codes), tlo, thi, cb=m // 2,
                                              block_n=block_n, window=window, interpret=True))
    got = lut_scan.flat_scan_window_planes_plain(torch.from_numpy(codes),
                                                 torch.from_numpy(tables), _n_pad(codes, m),
                                                 block_n, window)
    np.testing.assert_array_equal(got.numpy(), want[:, :Q])
    if kind != "random":
        assert bool((got == m * int(tables[0, 0, 0])).all())


@pytest.mark.parametrize("entry", [-128, 127])
def test_sixteen_bit_lanes_hold_the_extremes(entry):
    """32 sub-quantizers of one entry: every biased lane sum is 32 * (entry +
    128), 0 or 8160, and no lane carries into its neighbour."""
    x = torch.from_numpy(np.random.default_rng(4).integers(0, 1 << 32, (7, 32), dtype=np.int64))
    tab = torch.full((3, 32, 4), (entry + 128) * 0x01010101, dtype=torch.int64)
    acc = lut_scan._perm4_lookup8(tab, x)                          # (7, 3, 4)
    lane = 32 * (entry + 128)
    assert bool((acc == lane | (lane << 16)).all())


def test_lookup8_lanes_are_the_slot_sums():
    """Lane i of the four words (slots (0, 2), (1, 3), (4, 6), (5, 7)) is the
    biased sum of slot i's entries over the sub-quantizers."""
    g = np.random.default_rng(5)
    tables = torch.from_numpy(g.integers(-128, 128, (4, 16, 16)).astype(np.int8))
    x = torch.from_numpy(g.integers(0, 1 << 32, (9, 16), dtype=np.int64))
    biased = tables.view(torch.uint8).long() ^ 0x80                   # (Q, M, 16)
    tab = (biased.reshape(4, 16, 4, 4) << (8 * torch.arange(4))).sum(-1)
    acc = lut_scan._perm4_lookup8(tab, x)                          # (9, Q, 4)
    for i in range(8):
        nib = (x >> (4 * i)) & 15                                  # (9, M)
        want = biased[:, torch.arange(16)[None, :], nib].sum(-1).T  # (9, Q)
        got = (acc[..., (i >> 2) * 2 + (i & 1)] >> (16 * ((i >> 1) & 1))) & 0xFFFF
        assert torch.equal(got, want)


def test_nibble_planes_layout():
    m, block_n = 32, 48
    codes = torch.from_numpy(_codes(m, block_n))
    planes = lut_scan.nibble_planes(codes, block_n, m // 2)
    blocks = _n_pad(codes, m) // block_n
    assert planes.shape == (blocks, block_n // 8 + 1, m)
    assert bool((planes[:, -1] == 0).all())
    flat = codes.reshape(-1, m // 2).long()
    for blk in (0, blocks - 1):
        for slot in range(block_n):
            code = int(lut_scan.slots_to_rows(torch.tensor(blk * block_n + slot), block_n, m // 2))
            for sq in range(m):
                nib = (int(flat[code, sq // 2]) >> (4 * (sq % 2))) & 15
                assert (int(planes[blk, slot // 8, sq]) >> (4 * (slot % 8))) & 15 == nib


def _prmt_ref(x, y, s):
    src = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    out = 0
    for k in range(4):
        nib = (s >> (4 * k)) & 15
        v = src[nib & 7]
        if nib & 8:
            v = 0xFF if v & 0x80 else 0
        out |= v << (8 * k)
    return out


def test_prmt_is_ptx_prmt():
    x, y = 0x33221100, 0x77665544
    assert int(lut_scan.prmt(x, y, 0x3210)) == x
    assert int(lut_scan.prmt(x, y, 0x7654)) == y
    assert int(lut_scan.prmt(x, y, 0x0123)) == 0x00112233
    assert int(lut_scan.prmt(x, 0, 0x4341)) == 0x00330011
    assert int(lut_scan.prmt(0x80FF7F01, 0, 0x89AB)) == 0x0000FFFF  # sign replication
    g = np.random.default_rng(6)
    vals = g.integers(0, 1 << 32, (3, 200), dtype=np.int64)
    got = lut_scan.prmt(*(torch.from_numpy(v) for v in vals))
    want = [_prmt_ref(*map(int, col)) for col in vals.T]
    assert got.tolist() == want


def test_sign_replicating_prmt_is_the_bit3_mask():
    """Byte i of prmt(x << 4, x, 0xD9C8) is 0xFF iff nibble i of x has bit 3
    set (i < 4); of prmt(x << 4, x, 0xFBEA), nibble 4 + i."""
    x = torch.from_numpy(np.random.default_rng(7).integers(0, 1 << 32, 500, dtype=np.int64))
    signs = (x << 4) & 0xFFFFFFFF
    for half, pick in enumerate((0xD9C8, 0xFBEA)):
        mask = lut_scan.prmt(signs, x, pick)
        for i in range(4):
            bit3 = (x >> (4 * (4 * half + i) + 3)) & 1
            assert torch.equal((mask >> (8 * i)) & 0xFF, bit3 * 0xFF)


def test_vminu2_takes_each_lane():
    a = torch.tensor([0x0001FFFF, 0x00050002, 0xFFFF0000])
    b = torch.tensor([0x00020000, 0x00040003, 0x0000FFFF])
    assert lut_scan.vminu2(a, b).tolist() == [0x00010000, 0x00040002, 0x00000000]


# ---- the compiled loops' counts (scan_lab.sass_loops) -------------------------

_SASS = """
        Function : _ZN4anon29flat_scan_window_perm4_kernelILi8EEEvPKh
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   PRMT R2, R3, 0x3210, R4 ;
        /*0020*/                   LOP3.LUT R5, R5, 0x7, RZ, 0xc0, !PT ;
        /*0030*/                   PRMT R6, R8, R7, R9 ;
        /*0040*/              @!P0 BRA 0x70 ;
        /*0050*/                   SHF.R.W.U32 R8, R8, R12, R72 ;
        /*0060*/                   LDS.128 R72, [R115+0x40] ;
        /*0070*/                   PRMT R10, R8, R7, R11 ;
        /*0080*/                   IMAD R13, R10, R14, R13 ;
        /*0090*/               @P1 BRA 0x30 ;
        /*00a0*/               @P2 BRA 0x20 ;
        /*00b0*/               @P4 BRA 0xd0 ;
        /*00c0*/                   PRMT R6, R8, R7, R9 ;
        /*00d0*/                   VIMNMX.U32 R20, R20, R6, PT ;
        /*00e0*/               @P3 BRA 0xb0 ;
        /*00f0*/                   EXIT ;
        /*0100*/                   BRA 0x100 ;
        Function : _ZN4anon28flat_scan_window_regs_kernelILi8EEEvPKh
        /*0000*/                   PRMT R6, R8, R7, R9 ;
        /*0010*/               @P1 BRA 0x0 ;
"""


def test_sass_loops_count_each_innermost_loop_on_its_hot_path():
    loops = scan_lab.sass_loops(_SASS, "flat_scan_window_perm4_kernel", 1)
    assert list(loops) == [8]
    inner, fold = loops[8]   # the outer loop at 0x20 encloses the inner one: left out
    # Inner (nested): the funnel shift and its load are skipped, both PRMTs kept.
    assert (inner["start"], inner["nested"]) == (0x30, True)
    assert inner["ops"] == {"PRMT": 2, "BRA": 2, "IMAD": 1}
    assert (inner["alu"], inner["fma"], inner["other"], inner["prmt"]) == (2, 1, 2, 2)
    assert inner["lookups"] == 8 and inner["alu_per_lookup"] == 2 / 8
    # Fold (not nested): the branch at 0xb0 would skip a PRMT, so it is not taken.
    assert (fold["start"], fold["nested"]) == (0xb0, False)
    assert fold["ops"] == {"BRA": 2, "PRMT": 1, "VIMNMX": 1}
    assert (fold["alu"], fold["fma"], fold["other"]) == (2, 0, 2)
    # A loop without PRMTs (the branch to itself at 0x100) is not counted.
    assert scan_lab.sass_loops(_SASS, "no_such_kernel", 1) == {}
