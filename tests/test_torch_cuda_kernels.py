"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped where there is no CUDA card (the kernels run only there). On a card
run it without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: M1, flat_scan (the tensor-core kernels), flat_scan_window (the
tensor-core kernel and the tile walk) and flat_scan_window_regs with int8
tables (int32 sums) bit-exact; the float scans (M1, flat_scan and
flat_scan_window with float tables, grouped_scan8, flat_scan8), M2 and M3
rtol 1e-6, atol 1e-5 * max: the plain versions sum in the
kernels' order, but the card may contract or round differently; the staged
M2 and the chunked M3 are also held bit for bit to their plain versions
(one sum order, adds only). MASK_BIG
placement, trim sentinels and dead windows exact; argmin indices equal
(flat scans: wherever the minima are equal bit for bit).
"""

import numpy as np
import pytest
import torch

from qadc_tpu_torch.convert import flat_index_from_arrays, ivf_index_from_arrays
from qadc_tpu_torch.eval.synth import (bench_flat_arrays, bench_ivf8_arrays,
                                       bench_ivf16_arrays, bench_ivf_arrays)
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.index.routing import route_queries
from qadc_tpu_torch.kernels import lut_scan, scan_lab
from test_torch_grouped_slot_minor import LIVE_COUNTS, groups_with_live_counts, scatter_slots
from test_torch_rows_adc_tiles import ID_CASES, id_list_inputs

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda", 0)


def _close(got, want):
    atol = 1e-5 * float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=atol)


def _groups(g, parts, rpp, cpr, q, ma, group_size):
    """Routed groups over random probes of partitions of assorted sizes."""
    pids = torch.from_numpy(g.integers(0, parts, (q, ma)).astype(np.int32))
    sizes = torch.tensor([0, 1, 17, rpp * cpr, 900, 3000], dtype=torch.int32)[:parts]
    routed = route_queries(pids, parts, group_size=group_size)
    g_sz = torch.where(routed.group_valid, sizes[routed.group_part.long()], 0)
    return [routed.group_part, routed.slot_pairs(), g_sz.to(torch.int32)]


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("group_size", [4, 128])
def test_grouped_scan_matches_plain(cuda, m, f32, group_size):
    g = np.random.default_rng(m)
    parts, rpp, q, ma = 6, 200, 9, 4                    # rpp spans a partial tile
    codes = torch.from_numpy(g.integers(0, 256, (parts, rpp, 128), dtype=np.uint8))
    if f32:  # a float table of 32 sub-quantizers is 2 KB: G=128 runs in chunks
        tables = torch.from_numpy(g.random((q * ma, m, 16)).astype(np.float32))
    else:
        tables = torch.from_numpy(g.integers(0, 128, (q * ma, m, 16)).astype(np.int8))
    args = [codes, tables, *_groups(g, parts, rpp, 128 // (m // 2), q, ma, group_size)]
    want = lut_scan.grouped_scan_plain(*args)
    key = "grouped_scan_f32" if f32 else "grouped_scan"
    before = lut_scan.launches[key]
    got = lut_scan.grouped_scan(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert lut_scan.launches[key] == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("m", [4, 8, 16])
@pytest.mark.parametrize("group_size", [4, 128])
def test_grouped_scan8_matches_plain(cuda, m, group_size):
    g = np.random.default_rng(200 + m)
    parts, rpp, q, ma = 6, 200, 9, 4
    codes = torch.from_numpy(g.integers(0, 256, (parts, rpp, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.random((q * ma, m, 256)).astype(np.float32)).to(torch.bfloat16)
    args = [codes, tables, *_groups(g, parts, rpp, 128 // m, q, ma, group_size)]
    want_v, want_i = lut_scan.grouped_scan8_plain(*args)
    before = lut_scan.launches["grouped_scan8"]
    got_v, got_i = lut_scan.grouped_scan8(*[a.to(cuda) for a in args])
    torch.cuda.synchronize()
    assert lut_scan.launches["grouped_scan8"] == before + 1
    got_v, got_i = got_v.cpu(), got_i.cpu()
    assert torch.equal(torch.isinf(got_v), torch.isinf(want_v))
    fin = torch.isfinite(want_v)
    _close(got_v[fin], want_v[fin])
    assert torch.equal(got_i, want_i)


@pytest.mark.parametrize("cb", [8, 16])
def test_rows_adc_matches_plain(cuda, cb):
    g = np.random.default_rng(cb)
    codes = torch.from_numpy(g.integers(0, 256, (300, 128), dtype=np.uint8))
    rows = torch.from_numpy(g.integers(0, 300, 701).astype(np.int32))
    pairs = torch.from_numpy(g.integers(0, 40, 701).astype(np.int32))
    tlo = torch.from_numpy(g.normal(size=(40, 16 * cb)).astype(np.float32))
    thi = torch.from_numpy(g.normal(size=(40, 16 * cb)).astype(np.float32))
    args = [codes, rows, pairs, tlo, thi]
    want = lut_scan.rows_adc_plain(*args)
    got = lut_scan.rows_adc(*[a.to(cuda) for a in args])
    _close(got.cpu(), want)


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("name,a", ID_CASES)
def test_rows_adc_equals_plain_and_arm(cuda, name, a, cb):
    """The staged M2 (csrc/rows_adc.cu:rows_adc_kernel) at the id lists of its
    cases, bit for bit its plain version and its walk."""
    args = id_list_inputs(name, a, cb)
    want = lut_scan.rows_adc_plain(*args)
    dev = [t.to(cuda) for t in args]
    torch.cuda.synchronize()
    before = dict(lut_scan.launches)
    got = lut_scan.rows_adc(*dev)
    torch.cuda.synchronize()
    assert lut_scan.launches["rows_adc"] == before["rows_adc"] + (1 if a else 0)
    assert got.shape == (a, 128 // cb)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(lut_scan.rows_adc_staged_plain(*dev), got)


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("kind", ["flat_keep_prefix", "screen_order"])
def test_rows_adc_at_search_sizes(cuda, cb, kind):
    """Many tiles: the flat keep-prefix's lists (the same rows for every
    query, a pair a query: runs of 625 cut by tiles) and a rerank's (a pair
    a row from 3,072, rows all over the storage)."""
    g = np.random.default_rng(40 + cb)
    codes = torch.from_numpy(g.integers(0, 256, (20_000, 128), dtype=np.uint8)).to(cuda)
    qa = 3072
    tlo = torch.from_numpy(g.normal(size=(qa, 16 * cb)).astype(np.float32)).to(cuda)
    thi = torch.from_numpy(g.normal(size=(qa, 16 * cb)).astype(np.float32)).to(cuda)
    if kind == "flat_keep_prefix":
        rows = torch.arange(625, dtype=torch.int32, device=cuda).repeat(128)
        pairs = torch.arange(128, dtype=torch.int32, device=cuda).repeat_interleave(625)
    else:
        rows = torch.from_numpy(g.integers(0, 20_000, 12_800).astype(np.int32)).to(cuda)
        pairs = torch.from_numpy(g.integers(0, qa, 12_800).astype(np.int32)).to(cuda)
    args = (codes, rows, pairs, tlo, thi)
    got = lut_scan.rows_adc(*args)
    assert torch.equal(got, lut_scan.rows_adc_plain(*args))


def test_searches_launch_only_the_staged_rows_adc(cuda):
    arrays, meta = bench_ivf_arrays(np.random.default_rng(0), parts=16)
    index = ivf_index_from_arrays(arrays, meta, cuda)
    queries = np.random.default_rng(1).normal(size=(32, 128)).astype(np.float32)
    torch.cuda.synchronize()
    before = dict(lut_scan.launches)
    ivf.search_qadc(index, queries, r=50, ma=4, keep=0.005, direct=False, grouped=True)
    ivf.search_adc(index, queries, r=50, ma=4)
    torch.cuda.synchronize()
    assert lut_scan.launches["rows_adc"] == before["rows_adc"] + 3


@pytest.mark.parametrize("cb", [8, 16])
def test_direct_scan_matches_plain(cuda, cb):
    g = np.random.default_rng(100 + cb)
    parts, part_pad, qa = 5, 512, 7
    codes = torch.from_numpy(
        g.integers(0, 256, (parts, part_pad * cb // 128, 128), dtype=np.uint8))
    pp = torch.from_numpy(g.integers(0, parts, qa).astype(np.int32))
    tlo = torch.from_numpy(g.normal(size=(qa, 16 * cb)).astype(np.float32))
    thi = torch.from_numpy(g.normal(size=(qa, 16 * cb)).astype(np.float32))
    sizes = torch.tensor([0, 1, 31, 33, 500, 512, 256], dtype=torch.int32)
    args = [codes, pp, tlo, thi, sizes]
    want_d, want_m = lut_scan.direct_scan_plain(*args)
    got_d, got_m = lut_scan.direct_scan(*[a.to(cuda) for a in args])
    got_d, got_m = got_d.cpu(), got_m.cpu()
    big = want_d == lut_scan.MASK_BIG
    assert torch.equal(got_d == lut_scan.MASK_BIG, big)
    _close(torch.where(big, 0.0, got_d), torch.where(big, 0.0, want_d))
    _close(got_m, want_m)


# M3 at the direct path's shapes: (partitions, part_pad, pairs), the bench
# IVF-256 16x4 index (part_pad 4,096) and the CLI's trained one (12,288) at
# b = 1, 32 and 128 (ma 24); and small ones with a partition of size 0.
DIRECT_SHAPES = [(256, 4096, 24), (256, 4096, 768), (256, 4096, 3072), (256, 12288, 24),
                 (256, 12288, 768), (256, 12288, 3072), (5, 512, 7), (5, 256, 33)]


def _direct_inputs(parts, part_pad, qa, cb, seed=0):
    g = np.random.default_rng([seed, parts, part_pad, qa, cb])
    codes = torch.from_numpy(g.integers(0, 256, (parts, part_pad * cb // 128, 128),
                                        dtype=np.uint8))
    sizes = g.integers(0, part_pad + 1, parts).astype(np.int32)
    sizes[:4] = (0, 1, part_pad, part_pad - 33)     # empty, one code, full, a partial tile
    pp = g.integers(0, parts, qa).astype(np.int32)
    pp[:min(qa, 4)] = np.arange(min(qa, 4))
    tlo = g.uniform(0, 30, (qa, 16 * cb)).astype(np.float32)
    thi = g.uniform(0, 30, (qa, 16 * cb)).astype(np.float32)
    return [torch.from_numpy(x) for x in (pp, tlo, thi)], codes, torch.from_numpy(sizes[pp])


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("parts,part_pad,qa", DIRECT_SHAPES)
def test_direct_scan_equals_plain_and_arm(cuda, parts, part_pad, qa, cb):
    """The chunked M3 equals its plain version bit for bit: distances, tile
    minima and MASK_BIG at and past each size."""
    (pp, tlo, thi), codes, sizes = _direct_inputs(parts, part_pad, qa, cb)
    args = [x.to(cuda) for x in (codes, pp, tlo, thi, sizes)]
    before = dict(lut_scan.launches)
    got = lut_scan.direct_scan(*args)
    want = lut_scan.direct_scan_plain(*args)
    torch.cuda.synchronize()
    assert lut_scan.launches["direct_scan"] == before["direct_scan"] + 1
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    col = torch.arange(part_pad, device=cuda)
    assert torch.equal(got[0] == lut_scan.MASK_BIG, col[None, :] >= args[4][:, None])
    assert (got[0][args[4] == 0] == lut_scan.MASK_BIG).all()


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("rounds", [1, 2, 3, 4])
def test_direct_scan_at_any_rounds(cuda, monkeypatch, cb, rounds):
    """Every number of rounds a block (part_pad 12,288 = 12 rounds of 1024,
    and 768, less than one) gives the plain result and the walk's."""
    monkeypatch.setattr(lut_scan, "direct_scan_rounds", lambda qa, part_pad, sms: rounds)
    for parts, part_pad, qa in ((7, 12288, 9), (5, 768, 11)):
        (pp, tlo, thi), codes, sizes = _direct_inputs(parts, part_pad, qa, cb, seed=rounds)
        args = [x.to(cuda) for x in (codes, pp, tlo, thi, sizes)]
        got = lut_scan.direct_scan(*args)
        walk = lut_scan.direct_scan_items_plain(*[a.cpu() for a in args], rounds)
        for x in (walk, lut_scan.direct_scan_plain(*args)):
            assert torch.equal(got[0].cpu(), x[0].cpu()) and torch.equal(got[1].cpu(), x[1].cpu())


def test_direct_searches_launch_only_the_chunked_m3(cuda):
    arrays, meta = bench_ivf_arrays(np.random.default_rng(0), parts=16)
    index = ivf_index_from_arrays(arrays, meta, cuda)
    queries = np.random.default_rng(1).normal(size=(4, 128)).astype(np.float32)
    before = dict(lut_scan.launches)
    ivf.search_qadc(index, queries, r=50, ma=4, direct=True)
    torch.cuda.synchronize()
    assert lut_scan.launches["direct_scan"] == before["direct_scan"] + 1


def test_wrappers_raise_on_bad_input(cuda):
    codes = torch.zeros((2, 4, 128), dtype=torch.uint8, device=cuda)
    tlo = torch.zeros((3, 128), dtype=torch.float32, device=cuda)
    rows = torch.zeros(3, dtype=torch.int64, device=cuda)  # must be int32
    with pytest.raises(TypeError):
        lut_scan.rows_adc(codes.reshape(-1, 128), rows, rows.int(), tlo, tlo)
    with pytest.raises(ValueError):  # tables on another device
        lut_scan.rows_adc(codes.reshape(-1, 128), rows.int(), rows.int(), tlo.cpu(), tlo)


def test_search_on_card_matches_plain(cuda):
    arrays, meta = bench_ivf_arrays(np.random.default_rng(0), parts=16)
    index = ivf_index_from_arrays(arrays, meta, cuda)
    queries = np.random.default_rng(1).normal(size=(8, 128)).astype(np.float32)
    for kw in (dict(direct=True), dict(direct=False, grouped=True)):
        d, l = ivf.search_qadc(index, queries, r=50, ma=4, keep=0.005, **kw)
        pd, pl = ivf.search_qadc(index, queries, r=50, ma=4, keep=0.005,
                                 kernels=lut_scan.PLAIN, **kw)
        _close(d.cpu(), pd.cpu())
        assert torch.equal(l.cpu()[:, 0], pl.cpu()[:, 0])


@pytest.mark.parametrize("make", [bench_ivf_arrays, bench_ivf8_arrays, bench_ivf16_arrays])
def test_search_adc_on_card_matches_plain(cuda, make):
    arrays, meta = make(np.random.default_rng(0), parts=16)
    index = ivf_index_from_arrays(arrays, meta, cuda)
    queries = np.random.default_rng(1).normal(size=(8, 128)).astype(np.float32)
    d, l = ivf.search_adc(index, queries, r=50, ma=4)
    pd, pl = ivf.search_adc(index, queries, r=50, ma=4, kernels=lut_scan.PLAIN)
    ed, el = ivf.search_adc(index, queries, r=50, ma=4, grouped=False)
    _close(d.cpu(), pd.cpu())
    assert torch.equal(l.cpu()[:, 0], pl.cpu()[:, 0])
    assert torch.equal(l.cpu()[:, 0], el.cpu()[:, 0])


def _same_minima(got, want, f32: bool):
    """Minima of a flat scan equal (int32) or close (float, +inf placed alike)."""
    if not f32:
        assert torch.equal(got, want)
        return
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    fin = torch.isfinite(want)
    _close(got[fin], want[fin])


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("with_rows", [False, True])
def test_flat_scan_matches_plain(cuda, m, f32, with_rows):
    g = np.random.default_rng(300 + m)
    r_count, q = 300, 300          # a partial row tile; several query chunks
    cpr = 256 // m
    codes = torch.from_numpy(g.integers(0, 256, (r_count, 128), dtype=np.uint8))
    if f32:
        tables = torch.from_numpy(g.random((q, m, 16)).astype(np.float32))
    else:
        tables = torch.from_numpy(g.integers(0, 128, (q, m, 16)).astype(np.int8))
    n = r_count * cpr - 5 * cpr - 3             # a partly real row, then padding
    want_v, want_i = lut_scan.flat_scan_plain(codes, tables, n, with_rows)
    key = "flat_scan_f32" if f32 else "flat_scan"
    before = lut_scan.launches[key]
    got_v, got_i = lut_scan.flat_scan(codes.to(cuda), tables.to(cuda), n, with_rows)
    torch.cuda.synchronize()
    assert lut_scan.launches[key] == before + 1
    _same_minima(got_v.cpu(), want_v, f32)
    if with_rows:
        same = got_v.cpu() == want_v
        assert same.float().mean() > 0.99
        assert torch.equal(got_i.cpu()[same], want_i[same])
    else:
        assert got_i is None and want_i is None


@pytest.mark.parametrize("m", [4, 8, 16, 32])
def test_flat_scan8_matches_plain(cuda, m):
    g = np.random.default_rng(400 + m)
    n_pad, q = 256 * 37, 37        # a partial last thread block; several query chunks
    codes = torch.from_numpy(g.integers(0, 256, (n_pad * m // 128, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.random((q, m, 256)).astype(np.float32)).to(torch.bfloat16)
    n = n_pad - 300
    want_v, want_i = lut_scan.flat_scan8_plain(codes, tables, n)
    before = lut_scan.launches["flat_scan8"]
    got_v, got_i = lut_scan.flat_scan8(codes.to(cuda), tables.to(cuda), n)
    torch.cuda.synchronize()
    assert lut_scan.launches["flat_scan8"] == before + 1
    got_v, got_i = got_v.cpu(), got_i.cpu()
    _same_minima(got_v, want_v, True)
    same = got_v == want_v
    assert same.float().mean() > 0.99
    assert torch.equal(got_i[same], want_i[same])


@pytest.mark.parametrize("m,bits", [(16, 4), (8, 8), (8, 16)])
def test_flat_search_on_card_matches_plain(cuda, m, bits):
    arrays, meta = bench_flat_arrays(np.random.default_rng(0), m, bits, n=50_000)
    index = flat_index_from_arrays(arrays, meta, cuda)
    queries = np.random.default_rng(1).normal(size=(8, 128)).astype(np.float32)
    runs = [lambda k: flat.search_adc(index, queries, r=50, kernels=k)]
    if bits == 4:
        runs.append(lambda k: flat.search_qadc(index, queries, r=50, keep=0.01, kernels=k))
    for run in runs:
        (d, l), (pd, pl) = run(lut_scan.DISPATCH), run(lut_scan.PLAIN)
        _close(d.cpu(), pd.cpu())
        assert torch.equal(l.cpu()[:, 0], pl.cpu()[:, 0])


# (m, block_n, window): W = cpr; two rows a window; a parity class of a row;
# W != cpr at 32 sub-quantizers; a block of one storage row.
WINDOW_SHAPES = [(16, 1024, 16), (32, 1024, 16), (16, 512, 8), (32, 512, 8), (16, 2048, 64),
                 (32, 8, 2)]


# (m, block_n, window) of the tensor-core window scans: those of
# WINDOW_SHAPES, W = 2 cpr, windows longer than a tile (256 > 128 columns;
# 1024), W = 1, and windows of no power of two (24, 3: dead columns).
WINDOW_TC_SHAPES = WINDOW_SHAPES + [(16, 1024, 32), (32, 1024, 32), (16, 2048, 256),
                                    (32, 2048, 256), (16, 1024, 1024), (16, 1024, 1),
                                    (32, 1536, 24), (16, 1536, 3)]


def _window_inputs(m, block_n, f32, q=37, blocks=5, seed=500):
    g = np.random.default_rng(seed + m + block_n)
    codes = torch.from_numpy(g.integers(0, 256, (blocks * block_n * m // 256, 128),
                                        dtype=np.uint8))
    if f32:
        tables = torch.from_numpy(g.random((q, m, 16)).astype(np.float32))
    else:  # few distinct entries: many ties inside a window
        tables = torch.from_numpy(g.integers(0, 4, (q, m, 16)).astype(np.int8))
    return codes, tables, blocks * block_n - block_n // 2 - 3   # padding inside a block


@pytest.mark.parametrize("m,block_n,window", WINDOW_SHAPES)
@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("mode", ["min", "rows", "transposed"])
def test_flat_scan_window_matches_plain(cuda, m, block_n, window, f32, mode):
    codes, tables, n = _window_inputs(m, block_n, f32)
    kw = dict(with_rows=mode == "rows", transpose_out=mode == "transposed")
    want_v, want_i = lut_scan.flat_scan_window_plain(codes, tables, n, block_n, window, **kw)
    key = "flat_scan_window_f32" if f32 else "flat_scan_window"
    before = lut_scan.launches[key]
    got_v, got_i = lut_scan.flat_scan_window(codes.to(cuda), tables.to(cuda), n, block_n,
                                             window, **kw)
    torch.cuda.synchronize()
    assert lut_scan.launches[key] == before + 1
    _same_minima(got_v.cpu(), want_v, f32)
    if mode == "rows":
        same = got_v.cpu() == want_v
        assert same.float().mean() > 0.99
        assert torch.equal(got_i.cpu()[same], want_i[same])     # ties: the lowest slot
    else:
        assert got_i is None and want_i is None


@pytest.mark.parametrize("m,block_n,window", WINDOW_TC_SHAPES)
@pytest.mark.parametrize("q", [5, 37, 130])   # partial warps; a second block of queries
def test_flat_scan_window_regs_matches_plain(cuda, m, block_n, window, q):
    """The four-lookup register engine (flat_scan_window_regs) equals the
    plain version, its own walk and flat_scan_window bit for bit, counted
    once; G = block_n / W runs 8 windows a lane (G a multiple of 8) or folds
    (G = 4 at (32, 8, 2), G = 1 at W = block_n)."""
    codes, tables, n = _window_inputs(m, block_n, False, q=q)
    want, _ = lut_scan.flat_scan_window_plain(codes, tables, n, block_n, window)
    before = dict(lut_scan.launches)
    got = lut_scan.flat_scan_window_regs(codes.to(cuda), tables.to(cuda), n, block_n, window)
    same_kernel, _ = lut_scan.flat_scan_window(codes.to(cuda), tables.to(cuda), n, block_n,
                                               window)
    torch.cuda.synchronize()
    assert lut_scan.launches["flat_scan_window_regs"] == before["flat_scan_window_regs"] + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, same_kernel)
    assert torch.equal(lut_scan.flat_scan_window_planes_plain(codes, tables, n, block_n, window),
                       want)


def test_flat_scan_window_regs_takes_negative_entries(cuda):
    """int8 entries are sign-extended by the register engine, as the plain
    version does."""
    g = np.random.default_rng(9)
    codes = torch.from_numpy(g.integers(0, 256, (128, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(-128, 128, (33, 16, 16)).astype(np.int8))
    want, _ = lut_scan.flat_scan_window_plain(codes, tables, 2048, 1024, 16)
    got = lut_scan.flat_scan_window_regs(codes.to(cuda), tables.to(cuda), 2048, 1024, 16)
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("entry", [-128, 127])
@pytest.mark.parametrize("block_n,window", [(1024, 16), (1024, 1024), (8, 2)])
def test_flat_scan_window_regs_extreme_entries(cuda, entry, block_n, window):
    """Tables of all -128 or all 127 at 32 sub-quantizers: biased sums of 0
    and 32 * 255 in the 16-bit lanes, no carry between lanes."""
    g = np.random.default_rng(3)
    codes = torch.from_numpy(g.integers(0, 256, (256, 128), dtype=np.uint8))
    tables = torch.full((40, 32, 16), entry, dtype=torch.int8)
    got = lut_scan.flat_scan_window_regs(codes.to(cuda), tables.to(cuda), 2000, block_n, window)
    want, _ = lut_scan.flat_scan_window_plain(codes, tables, 2000, block_n, window)
    assert torch.equal(got.cpu(), want)
    assert bool(((want == 32 * entry) | (want == lut_scan.TRIM_SENTINEL)).all())


@pytest.mark.parametrize("m,block_n,window", WINDOW_TC_SHAPES)
@pytest.mark.parametrize("q", [5, 37, 130])    # one group of 128 queries, partly masked; two
@pytest.mark.parametrize("mode", ["min", "rows", "transposed"])
def test_flat_scan_window_tensor_cores_equal_arm_and_plain(cuda, m, block_n, window, q, mode):
    """The int8 window scan on the tensor cores equals the plain version and
    its own walk bit for bit: minima, transposed minima and argmin ids (ties:
    few distinct entries; the lowest slot wins, not the lowest code at W >
    cpr), with padded codes inside a block."""
    codes, tables, n = _window_inputs(m, block_n, False, q=q)
    kw = dict(with_rows=mode == "rows", transpose_out=mode == "transposed")
    before = dict(lut_scan.launches)
    got = lut_scan.flat_scan_window(codes.to(cuda), tables.to(cuda), n, block_n, window, **kw)
    torch.cuda.synchronize()
    assert lut_scan.launches["flat_scan_window"] == before["flat_scan_window"] + 1
    plain = lut_scan.flat_scan_window_plain(codes, tables, n, block_n, window, **kw)
    walk = lut_scan.flat_scan_window_tiles_plain(codes, tables, n, block_n, window, **kw)
    for other in (plain, walk):
        assert torch.equal(got[0].cpu(), other[0].cpu())
        assert got[1] is other[1] is None or torch.equal(got[1].cpu(), other[1].cpu())


@pytest.mark.parametrize("m,block_n,window", WINDOW_TC_SHAPES)
@pytest.mark.parametrize("q", [5, 20, 37, 130])  # both sides of the threshold; two chunks
@pytest.mark.parametrize("mode", ["min", "rows", "transposed"])
@pytest.mark.parametrize("forced", [False, True], ids=["wrapper", "query_minor_forced"])
def test_flat_scan_window_f32_query_minor_equals_arm_and_plain(cuda, monkeypatch, m, block_n,
                                                               window, q, mode, forced):
    """The float32 window scan (the query-minor kernel from
    WINDOW_QUERY_MINOR_MIN_QUERIES queries on, the lookup kernel below; or,
    forced, the query-minor kernel at every batch) equals the lookup kernel
    at any batch (flat_scan_window_f32_lookup), the plain version and the query-minor
    walk bit for bit: minima, transposed minima and argmin ids, with padded
    codes inside a block. Each call is counted once."""
    if forced:
        monkeypatch.setattr(lut_scan, "WINDOW_QUERY_MINOR_MIN_QUERIES", 1)
    codes, tables, n = _window_inputs(m, block_n, True, q=q)
    kw = dict(with_rows=mode == "rows", transpose_out=mode == "transposed")
    before = dict(lut_scan.launches)
    got = lut_scan.flat_scan_window(codes.to(cuda), tables.to(cuda), n, block_n, window, **kw)
    lookup = lut_scan.flat_scan_window_f32_lookup(codes.to(cuda), tables.to(cuda), n, block_n,
                                                  window, **kw)
    torch.cuda.synchronize()
    assert lut_scan.launches["flat_scan_window_f32"] == before["flat_scan_window_f32"] + 1
    assert (lut_scan.launches["flat_scan_window_f32_lookup"]
            == before["flat_scan_window_f32_lookup"] + 1)
    plain = lut_scan.flat_scan_window_plain(codes, tables, n, block_n, window, **kw)
    walk = lut_scan.flat_scan_window_query_minor_plain(codes, tables, n, block_n, window, **kw)
    for other in (lookup, plain, walk):
        assert torch.equal(got[0].cpu(), other[0].cpu())
        assert got[1] is other[1] is None or torch.equal(got[1].cpu(), other[1].cpu())


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("q", [9, 130])
def test_flat_scan_window_f32_at_cpr_is_flat_scan(cuda, m, q):
    """At W = cpr the float window scan's minima and ids are float
    flat_scan's with rows, transposed, bit for bit."""
    cpr = 256 // m
    codes, tables, n = _window_inputs(m, 1024, True, q=q, blocks=7)
    codes, tables = codes.to(cuda), tables.to(cuda)
    mins, _ = lut_scan.flat_scan_window(codes, tables, n, 1024, cpr, transpose_out=True)
    vals, ids = lut_scan.flat_scan_window(codes, tables, n, 1024, cpr, with_rows=True)
    f_mins, f_ids = lut_scan.flat_scan(codes, tables, n, with_rows=True)
    assert torch.equal(mins, f_mins) and torch.equal(vals.T, f_mins) and torch.equal(ids.T, f_ids)


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("q", [9, 130])
def test_flat_scan_window_at_cpr_is_flat_scan(cuda, m, q):
    """At W = cpr a window is a storage row: the window scan's transposed
    minima are flat_scan's, and its ids flat_scan's with rows, transposed."""
    cpr = 256 // m
    codes, tables, n = _window_inputs(m, 1024, False, q=q, blocks=7)
    codes, tables = codes.to(cuda), tables.to(cuda)
    mins, _ = lut_scan.flat_scan_window(codes, tables, n, 1024, cpr, transpose_out=True)
    vals, ids = lut_scan.flat_scan_window(codes, tables, n, 1024, cpr, with_rows=True)
    f_mins, f_ids = lut_scan.flat_scan(codes, tables, n, with_rows=True)
    assert torch.equal(mins, f_mins) and torch.equal(vals.T, f_mins) and torch.equal(ids.T, f_ids)


def test_flat_scan_window_negative_entries(cuda):
    """int8 entries below zero: the keys (sum << lw) | rank order them too."""
    g = np.random.default_rng(19)
    codes = torch.from_numpy(g.integers(0, 256, (512, 128), dtype=np.uint8))
    for m, q in ((16, 33), (32, 64)):
        tables = torch.from_numpy(g.integers(-128, 128, (q, m, 16)).astype(np.int8))
        for block_n, window in ((1024, 16), (2048, 256)):
            n_pad = 512 * 256 // m
            got = lut_scan.flat_scan_window(codes.to(cuda), tables.to(cuda), n_pad - 5, block_n,
                                            window, with_rows=True)
            want = lut_scan.flat_scan_window_plain(codes, tables, n_pad - 5, block_n, window,
                                                   with_rows=True)
            assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


def test_lut_scan_topk_int8_on_card_matches_plain(cuda):
    codes, tables, n = _window_inputs(16, 1024, False, q=9, blocks=8)
    want_v, want_i = lut_scan.lut_scan_topk_int8(codes, tables, 50, n, 1024, 16)
    got_v, got_i = lut_scan.lut_scan_topk_int8(codes.to(cuda), tables.to(cuda), 50, n, 1024, 16)
    assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_i.cpu(), want_i)


# ---- the tensor-core int8 scans (csrc/scan_mma.cu), their lookup twins, the lab


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("q", [1, 5, 17, 128, 130])   # partial m-tiles; a third query group
@pytest.mark.parametrize("n_kind", ["mid_row", "zero", "all", "one"])
def test_flat_scan_mma_matches_plain(cuda, m, q, n_kind):
    g = np.random.default_rng(600 + m + q)
    cpr = 256 // m
    r_count = 301                                  # ragged: a partial quad of rows
    codes = torch.from_numpy(g.integers(0, 256, (r_count, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(0, 6, (q, m, 16)).astype(np.int8))   # ties in a row
    n = {"mid_row": r_count * cpr - 5 * cpr - 3, "zero": 0, "all": r_count * cpr, "one": 1}[n_kind]
    want_v, want_i = lut_scan.flat_scan_plain(codes, tables, n, True)
    hot_v, hot_i = lut_scan.scan_onehot_plain(codes, tables, n, True)
    dc, dt = codes.to(cuda), tables.to(cuda)
    before = dict(lut_scan.launches)
    got_v, got_i = lut_scan.flat_scan(dc, dt, n, True)
    mins, none = lut_scan.flat_scan(dc, dt, n)
    torch.cuda.synchronize()
    assert lut_scan.launches["flat_scan"] == before["flat_scan"] + 2
    assert none is None
    assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_i.cpu(), want_i)
    assert torch.equal(mins.cpu(), want_v)
    assert torch.equal(hot_v, want_v) and torch.equal(hot_i, want_i)


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("group_size", [4, 16, 128])
@pytest.mark.parametrize("q", [1, 9, 40])      # 40 x 4 pairs: more than 16 live slots a group
def test_grouped_scan_mma_matches_plain(cuda, m, group_size, q):
    g = np.random.default_rng(700 + m + group_size + q)
    cpr = 256 // m
    rpp, ma = 50, 4
    sizes = torch.tensor([0, 1, 17, rpp * cpr, 277, 600], dtype=torch.int32)
    codes = torch.from_numpy(g.integers(0, 256, (6, rpp, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(0, 128, (q * ma, m, 16)).astype(np.int8))
    pids = torch.from_numpy(g.integers(0, 6, (q, ma)).astype(np.int32))
    routed = route_queries(pids, 6, group_size=group_size)
    g_sz = torch.where(routed.group_valid, sizes[routed.group_part.long()], 0).to(torch.int32)
    args = [codes, tables, routed.group_part, routed.slot_pairs(), g_sz]
    want = lut_scan.grouped_scan_plain(*args)
    dargs = [a.to(cuda) for a in args]
    before = dict(lut_scan.launches)
    got = lut_scan.grouped_scan(*dargs)
    torch.cuda.synchronize()
    assert lut_scan.launches["grouped_scan"] == before["grouped_scan"] + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(lut_scan.grouped_scan_onehot_plain(*args), want)


def test_grouped_scan_mma_one_live_slot_of_128(cuda):
    g = np.random.default_rng(8)
    codes = torch.from_numpy(g.integers(0, 256, (2, 20, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(0, 128, (3, 16, 16)).astype(np.int8))
    slot_pair = torch.full((2, 128), -1, dtype=torch.int32)
    slot_pair[1, 77] = 2
    args = [codes, tables, torch.tensor([0, 1], dtype=torch.int32), slot_pair,
            torch.tensor([320, 277], dtype=torch.int32)]
    want = lut_scan.grouped_scan_plain(*args)
    got = lut_scan.grouped_scan(*[a.to(cuda) for a in args]).cpu()
    assert torch.equal(got[2], want[2])            # rows 0 and 1 belong to no slot: unwritten


def test_grouped_scan_mma_group_larger_than_a_slot_chunk(cuda):
    """2000 slots a group: two gathers of 1024 slots, 80 live."""
    g = np.random.default_rng(10)
    codes = torch.from_numpy(g.integers(0, 256, (1, 9, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(0, 128, (80, 16, 16)).astype(np.int8))
    slot_pair = torch.full((1, 2000), -1, dtype=torch.int32)
    slot_pair[0, torch.from_numpy(g.permutation(2000)[:80])] = torch.arange(80, dtype=torch.int32)
    args = [codes, tables, torch.zeros(1, dtype=torch.int32), slot_pair,
            torch.tensor([9 * 16 - 5], dtype=torch.int32)]
    want = lut_scan.grouped_scan_plain(*args)
    assert torch.equal(lut_scan.grouped_scan(*[a.to(cuda) for a in args]).cpu(), want)


@pytest.mark.parametrize("mode", list(scan_lab.LAB_MODES))
def test_scan_lab_mode_launches(cuda, mode):
    g = np.random.default_rng(11)
    codes = torch.from_numpy(g.integers(0, 256, (301, 128), dtype=np.uint8)).to(cuda)
    tables = torch.from_numpy(g.integers(0, 128, (130, 16, 16)).astype(np.int8)).to(cuda)
    n = 301 * 16 - 21
    before = lut_scan.launches["scan_lab"]
    got = scan_lab.scan_lab(codes, tables, n, mode)
    torch.cuda.synchronize()
    assert lut_scan.launches["scan_lab"] == before + 1
    assert got.shape == (130, 301) and got.dtype == torch.int32
    bits, mt, _ = scan_lab.LAB_MODES[mode]
    if bits == 7:
        assert torch.equal(got, lut_scan.flat_scan_plain(codes, tables, n)[0])
    if bits == 0 and mt:
        assert (got[:, :300] == lut_scan.TRIM_SENTINEL).all()


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("q", [40, 48, 64, 129, 300])   # either side of the kernel choice
def test_flat_scan_kernel_choice_matches_lookup(cuda, m, q):
    """flat_scan's int8 kernel is mma.sync below lut_scan.WGMMA_MIN_QUERIES and
    wgmma from there on (several query groups at 129 and 300): both equal the
    plain version over many tiles, with and without rows."""
    g = np.random.default_rng(800 + m + q)
    cpr = 256 // m
    r_count = 2051                               # many 128-code tiles, the last one partial
    codes = torch.from_numpy(g.integers(0, 256, (r_count, 128), dtype=np.uint8)).to(cuda)
    tables = torch.from_numpy(g.integers(0, 128, (q, m, 16)).astype(np.int8)).to(cuda)
    n = r_count * cpr - 3 * cpr - 1
    for with_rows in (False, True):
        got = lut_scan.flat_scan(codes, tables, n, with_rows)
        want = lut_scan.flat_scan_plain(codes, tables, n, with_rows)
        assert torch.equal(got[0], want[0])
        assert with_rows is False or torch.equal(got[1], want[1])


@pytest.mark.parametrize("m", [16, 32])
def test_exactness_probe_on_card(cuda, m):
    g = np.random.default_rng(12)
    codes = torch.from_numpy(g.integers(0, 256, (640, 128), dtype=np.uint8)).to(cuda)
    bad = scan_lab.exactness_probe(codes, 640 * 256 // m - 9, m, q=130)
    assert bad == {"all_127": 0, "all_0": 0, "one_hot_rows": 0, "random": 0}
    tables = scan_lab.adversarial_tables(m, 4, 0, cuda)["all_127"]
    assert (lut_scan.flat_scan(codes, tables, 640 * 256 // m)[0] == 127 * m).all()


@pytest.mark.parametrize("cb", [8, 16])
def test_selector_sum_holds_float64(cuda, cb):
    x = torch.from_numpy(np.random.default_rng(11).uniform(0, 500, (512, 128)).astype(np.float32))
    before = lut_scan.launches["selector_sum"]
    got = scan_lab.selector_sum(x.to(cuda), cb).cpu().double()
    assert lut_scan.launches["selector_sum"] == before + 1
    want = x.double().reshape(512, 128 // cb, cb).sum(-1)
    assert float(((got - want).abs() / want.abs().clamp(min=1e-9)).max()) < 1e-6


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("rows", [1, 7, 512, 513])
def test_selector_sum_rows_hold_float64(cuda, rows, cb):
    """A warp a row, four rows a block: row counts off the block's multiple."""
    x = torch.from_numpy(np.random.default_rng(rows).uniform(0, 500, (rows, 128)).astype(np.float32))
    got = scan_lab.selector_sum(x.to(cuda), cb).cpu().double()
    assert got.shape == (rows, 128 // cb)
    want = x.double().reshape(rows, 128 // cb, cb).sum(-1)
    assert float(((got - want).abs() / want.abs().clamp(min=1e-9)).max()) < 1e-6


def test_ab_engines_agree(cuda):
    g = np.random.default_rng(13)
    codes = torch.from_numpy(g.integers(0, 256, (640, 128), dtype=np.uint8)).to(cuda)
    tables = torch.from_numpy(g.integers(0, 128, (37, 16, 16)).astype(np.int8)).to(cuda)
    n = 640 * 16 - 40
    want = lut_scan.flat_scan_plain(codes, tables, n)[0]
    for name, fn in scan_lab.ab_scans(codes, tables, n).items():
        assert torch.equal(fn(), want), name


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("q,r_count", [(64, 3), (1000, 130), (48, 1)])
def test_flat_scan_wgmma_small_and_wide(cuda, m, q, r_count):
    """The warpgroup kernel on less than one tile of rows, and on eight query groups."""
    g = np.random.default_rng(900 + m + q)
    codes = torch.from_numpy(g.integers(0, 256, (r_count, 128), dtype=np.uint8)).to(cuda)
    tables = torch.from_numpy(g.integers(0, 128, (q, m, 16)).astype(np.int8)).to(cuda)
    n = r_count * (256 // m) - 1
    got = lut_scan.flat_scan(codes, tables, n, True)
    want = lut_scan.flat_scan_plain(codes, tables, n, True)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---- the query-minor flat scans (csrc/flat_scan_qm.cuh, flat_scan8_qm.cuh)


@pytest.fixture
def query_minor_at_any_batch(monkeypatch):
    """The wrappers take the query-minor kernels at every batch."""
    monkeypatch.setattr(lut_scan, "QUERY_MINOR_MIN_QUERIES", 1)
    monkeypatch.setattr(lut_scan, "QUERY_MINOR_MIN_QUERIES8", 1)


@pytest.mark.parametrize("m", [16, 32])          # 32: 64 queries a chunk
@pytest.mark.parametrize("q", [1, 31, 33, 128, 300])
@pytest.mark.parametrize("n_kind", ["mid_row", "zero", "all", "one"])
def test_flat_scan_query_minor_equals_lookup_kernel(cuda, query_minor_at_any_batch, m, q, n_kind):
    """The query-minor float kernel against the kernel it replaces and both
    plain versions, bit for bit, minima and argmin ids; the float minimum is
    rows_adc's distance of its code."""
    g = np.random.default_rng(1000 + m + q)
    cpr = 256 // m
    r_count = 2051                               # many tiles of 32 rows, the last partial
    codes = torch.from_numpy(g.integers(0, 256, (r_count, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.random((q, m, 16)).astype(np.float32))
    tables[: q // 2] = torch.from_numpy(g.integers(0, 4, (q // 2, m, 16)).astype(np.float32))  # ties
    n = {"mid_row": r_count * cpr - 5 * cpr - 3, "zero": 0, "all": r_count * cpr, "one": 1}[n_kind]
    dc, dt = codes.to(cuda), tables.to(cuda)
    before = dict(lut_scan.launches)
    got_v, got_i = lut_scan.flat_scan(dc, dt, n, True)
    mins, none = lut_scan.flat_scan(dc, dt, n)
    old_v, old_i = lut_scan.flat_scan_f32_lookup(dc, dt, n, True)
    torch.cuda.synchronize()
    assert lut_scan.launches["flat_scan_f32"] == before["flat_scan_f32"] + 2
    assert lut_scan.launches["flat_scan_f32_lookup"] == before["flat_scan_f32_lookup"] + 1
    assert none is None and torch.equal(mins, got_v)
    assert torch.equal(got_v, old_v) and torch.equal(got_i, old_i)
    for plain in (lut_scan.flat_scan_plain, lut_scan.flat_scan_query_minor_plain):
        want_v, want_i = plain(dc, dt, n, True)
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    tlo, thi = ivf.tile_tables_rows(dt)
    rows = torch.arange(0, r_count, 7, dtype=torch.int32, device=cuda)
    live = rows.long() * cpr < n
    for qi in (0, q - 1):
        d = lut_scan.rows_adc(dc, rows, torch.full_like(rows, qi), tlo, thi)     # (A, cpr)
        pick = torch.gather(d, 1, (got_i[qi, rows.long()].long() % cpr).clamp(min=0)[:, None])[:, 0]
        assert torch.equal(pick[live], got_v[qi, rows.long()][live])


@pytest.mark.parametrize("m", [4, 8, 16, 32])    # 16, 32: chunks of 16 and 8 queries
@pytest.mark.parametrize("q", [1, 31, 33, 70])
@pytest.mark.parametrize("n_kind", ["mid_block", "zero", "all", "one"])
def test_flat_scan8_query_minor_equals_lookup_kernel(cuda, query_minor_at_any_batch, m, q, n_kind):
    g = np.random.default_rng(1100 + m + q)
    n_pad = 256 * 301                            # blocks do not divide among the SMs evenly
    codes = torch.from_numpy(g.integers(0, 256, (n_pad * m // 128, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.random((q, m, 256)).astype(np.float32))
    tables[: q // 2] = torch.from_numpy(g.integers(0, 3, (q // 2, m, 256)).astype(np.float32))
    tables = tables.to(torch.bfloat16)
    n = {"mid_block": n_pad - 300, "zero": 0, "all": n_pad, "one": 1}[n_kind]
    dc, dt = codes.to(cuda), tables.to(cuda)
    before = dict(lut_scan.launches)
    got_v, got_i = lut_scan.flat_scan8(dc, dt, n)
    old_v, old_i = lut_scan.flat_scan8_lookup(dc, dt, n)
    torch.cuda.synchronize()
    assert lut_scan.launches["flat_scan8"] == before["flat_scan8"] + 1
    assert lut_scan.launches["flat_scan8_lookup"] == before["flat_scan8_lookup"] + 1
    assert torch.equal(got_v, old_v) and torch.equal(got_i, old_i)
    for plain in (lut_scan.flat_scan8_plain, lut_scan.flat_scan8_query_minor_plain):
        want_v, want_i = plain(dc, dt, n)
        assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)


@pytest.mark.parametrize("blocks", [1, 3, 131, 133])
def test_flat_scan8_query_minor_few_blocks(cuda, query_minor_at_any_batch, blocks):
    """Fewer 256-code blocks than SMs, and one more than them."""
    g = np.random.default_rng(1200 + blocks)
    codes = torch.from_numpy(g.integers(0, 256, (blocks * 16, 128), dtype=np.uint8)).to(cuda)
    tables = torch.from_numpy(g.random((32, 8, 256)).astype(np.float32)).to(torch.bfloat16).to(cuda)
    got = lut_scan.flat_scan8(codes, tables, blocks * 256 - 7)
    want = lut_scan.flat_scan8_lookup(codes, tables, blocks * 256 - 7)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_small_batches_keep_the_lookup_kernels(cuda):
    """Below the measured thresholds flat_scan and flat_scan8 run the kernels
    of flat_scan.cu / flat_scan8.cu under their own launch counts."""
    g = np.random.default_rng(14)
    codes = torch.from_numpy(g.integers(0, 256, (64, 128), dtype=np.uint8)).to(cuda)
    t4 = torch.from_numpy(g.random((1, 16, 16)).astype(np.float32)).to(cuda)
    t8 = torch.from_numpy(g.random((1, 8, 256)).astype(np.float32)).to(torch.bfloat16).to(cuda)
    before = dict(lut_scan.launches)
    a, b = lut_scan.flat_scan(codes, t4, 1000), lut_scan.flat_scan_f32_lookup(codes, t4, 1000)
    c, d = lut_scan.flat_scan8(codes, t8, 1000), lut_scan.flat_scan8_lookup(codes, t8, 1000)
    assert torch.equal(a[0], b[0]) and torch.equal(c[0], d[0]) and torch.equal(c[1], d[1])
    for key in ("flat_scan_f32", "flat_scan_f32_lookup", "flat_scan8", "flat_scan8_lookup"):
        assert lut_scan.launches[key] == before[key] + 1


def test_query_minor_lab_on_card(cuda):
    """Every chunk of both query-minor scans equals the replaced kernel, the
    copy modes write their sentinels, every other mode and the empty kernel
    launch (scan_lab.check_query_minor raises otherwise)."""
    g = np.random.default_rng(15)
    codes = torch.from_numpy(g.integers(0, 256, (304, 128), dtype=np.uint8)).to(cuda)
    t4 = torch.from_numpy(g.random((130, 16, 16)).astype(np.float32)).to(cuda)
    t8 = torch.from_numpy(g.random((33, 8, 256)).astype(np.float32)).to(torch.bfloat16).to(cuda)
    before = dict(lut_scan.launches)
    scan_lab.check_query_minor(codes, t4, t8, 304 * 16 - 21)
    torch.cuda.synchronize()
    assert lut_scan.launches["scan_lab"] == before["scan_lab"] + 6 + len(scan_lab.QM_LAB_MODES)
    assert lut_scan.launches["empty_kernel"] == before["empty_kernel"] + 1


# ---- the slot-minor grouped scans (grouped_scan_sm.cu, grouped_scan8_sm.cu) ----

SM_RPP = 200  # a partial tile of 64 rows / 128 windows
SM_CASES = [(n,) for n in LIVE_COUNTS] + [LIVE_COUNTS]
SM_IDS = [f"live{c[0]}" for c in SM_CASES[:-1]] + ["mixed"]


def _slot_minor_inputs(counts, m, k, dtype, seed, group_size=128):
    g = np.random.default_rng(seed)
    cpr = 128 // (m // 2) if k == 16 else 128 // m
    *groups, qa = groups_with_live_counts(counts, SM_RPP, cpr, seed, group_size)
    codes = torch.from_numpy(g.integers(0, 256, (len(counts), SM_RPP, 128), dtype=np.uint8))
    # Small integers: sums tie often, so the lower-code rule is exercised.
    tables = torch.from_numpy(g.integers(0, 4, (qa, m, k)).astype(np.float32)).to(dtype)
    return [codes, tables, *groups]


@pytest.mark.parametrize("counts", SM_CASES, ids=SM_IDS)
@pytest.mark.parametrize("m", [16, 32])
def test_grouped_scan_slot_minor_equals_arm_and_plain(cuda, counts, m):
    args = _slot_minor_inputs(counts, m, 16, torch.float32, seed=m)
    want = lut_scan.grouped_scan_plain(*args)
    dev = [a.to(cuda) for a in args]
    before = dict(lut_scan.launches)
    got = lut_scan.grouped_scan(*dev)
    torch.cuda.synchronize()
    assert lut_scan.launches["grouped_scan_f32"] == before["grouped_scan_f32"] + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("counts", SM_CASES, ids=SM_IDS)
@pytest.mark.parametrize("m", [4, 8, 16])
def test_grouped_scan8_slot_minor_equals_arm_and_plain(cuda, counts, m):
    args = _slot_minor_inputs(counts, m, 256, torch.bfloat16, seed=200 + m)
    want = lut_scan.grouped_scan8_plain(*args)
    dev = [a.to(cuda) for a in args]
    before = dict(lut_scan.launches)
    got = lut_scan.grouped_scan8(*dev)
    torch.cuda.synchronize()
    assert lut_scan.launches["grouped_scan8"] == before["grouped_scan8"] + 1
    assert torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])


@pytest.mark.parametrize("group_size", [4, 16])
def test_grouped_slot_minor_small_groups(cuda, group_size):
    """A partition's pairs over several groups, groups past n_groups unused."""
    for m, k, dtype, scan, plain in ((16, 16, torch.float32, lut_scan.grouped_scan,
                                      lut_scan.grouped_scan_plain),
                                     (8, 256, torch.bfloat16, lut_scan.grouped_scan8,
                                      lut_scan.grouped_scan8_plain)):
        args = _slot_minor_inputs((1, 9, 33), m, k, dtype, seed=5, group_size=group_size)
        got, want = scan(*[a.to(cuda) for a in args]), plain(*args)
        for x, y in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("m,k", [(16, 16), (32, 16), (4, 256), (8, 256), (16, 256)])
def test_grouped_slot_minor_takes_live_slots_anywhere(cuda, m, k):
    """Live slots spread over each group's row, as no routing lays them out."""
    dtype = torch.float32 if k == 16 else torch.bfloat16
    args = _slot_minor_inputs((3, 33, 128), m, k, dtype, seed=11)
    args[3] = scatter_slots(args[3], 11)
    scan, plain = ((lut_scan.grouped_scan, lut_scan.grouped_scan_plain) if k == 16
                   else (lut_scan.grouped_scan8, lut_scan.grouped_scan8_plain))
    got, want = scan(*[a.to(cuda) for a in args]), plain(*args)
    for x, y in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert torch.equal(x.cpu(), y)


@pytest.mark.parametrize("bits", [4, 8])
def test_search_adc_launches_the_slot_minor_kernels(cuda, bits):
    make = bench_ivf_arrays if bits == 4 else bench_ivf8_arrays
    index = ivf_index_from_arrays(*make(np.random.default_rng(0), parts=16), cuda)
    queries = np.random.default_rng(1).normal(size=(32, 128)).astype(np.float32)
    key = "grouped_scan_f32" if bits == 4 else "grouped_scan8"
    torch.cuda.synchronize()
    before = dict(lut_scan.launches)
    ivf.search_adc(index, queries, r=50, ma=4)
    torch.cuda.synchronize()
    assert lut_scan.launches[key] == before[key] + 1


def test_grouped_lab_on_card(cuda):
    """Every grouped lab mode launches; the copy modes write their sentinels
    (scan_lab.check_grouped raises otherwise)."""
    f32 = [a.to(cuda) for a in _slot_minor_inputs((3, 12, 40), 16, 16, torch.float32, seed=9)]
    u8 = [a.to(cuda) for a in _slot_minor_inputs((3, 12, 40), 8, 256, torch.bfloat16, seed=9)]
    before = lut_scan.launches["scan_lab"]
    scan_lab.check_grouped(f32, u8)
    torch.cuda.synchronize()
    assert lut_scan.launches["scan_lab"] == before + len(scan_lab.GROUPED_LAB_MODES)


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("a", [1, 37, 3000])
def test_ivf_rows_adc_on_card(cuda, cb, a):
    """ivf.rows_adc (the JAX package's row-granular exact ADC) launches M2
    with the identity ids, bit for bit its plain version."""
    g = np.random.default_rng(cb + a)
    rows = torch.from_numpy(g.integers(0, 256, (a, 128), dtype=np.uint8))
    tlo = torch.from_numpy(g.random((a, 16 * cb)).astype(np.float32))
    thi = torch.from_numpy(g.random((a, 16 * cb)).astype(np.float32))
    want = ivf.rows_adc(rows, tlo, thi, cb)
    before = lut_scan.launches["rows_adc"]
    got = ivf.rows_adc(rows.to(cuda), tlo.to(cuda), thi.to(cuda), cb)
    torch.cuda.synchronize()
    assert lut_scan.launches["rows_adc"] == before + 1
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("k,per", [(256, 3000), (65536, 40_000)])
def test_chunked_kmeans_steps_on_card(cuda, monkeypatch, k, per):
    """ops/kmeans.py's assignment and Lloyd step on the card: many chunks of
    vectors and centroids equal one chunk (assignments exactly; at K > 256
    the update's index_add_ sums in a run-dependent order on CUDA, so its
    centroids are held to rtol 1e-5)."""
    import importlib

    tkm = importlib.import_module("qadc_tpu_torch.ops.kmeans")
    g = np.random.default_rng(k)
    x = torch.from_numpy(g.normal(size=(4, 5000, 16)).astype(np.float32)).to(cuda)
    c = torch.from_numpy(g.normal(size=(4, k, 16)).astype(np.float32)).to(cuda)
    c[:, -1] = c[:, 1]                                   # a tie across chunks
    small = 8 * 4 * per
    assert tkm._chunk_shape(4, 5000, k, small) != (5000, k)
    monkeypatch.setattr(tkm, "scratch_budget", lambda device: 1 << 40)
    want_a, want = tkm._assign(x, c), tkm._lloyd_step(x, c)
    monkeypatch.setattr(tkm, "scratch_budget", lambda device: small)
    got_a, got = tkm._assign(x, c), tkm._lloyd_step(x, c)
    assert torch.equal(got_a, want_a)
    if k <= tkm.ONE_HOT_MAX_K:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_sixteen_bit_encode_chunks_on_card(cuda, monkeypatch):
    """The 16-bit encode in chunks of vectors under a small scratch budget
    equals one chunk, on the card."""
    from qadc_tpu_torch.quantizers import pq

    g = np.random.default_rng(16)
    cent = torch.from_numpy(g.normal(size=(8, 1 << 16, 2)).astype(np.float32)).to(cuda)
    q = pq.ProductQuantizer(centroids=cent, sq_bits=16).validate()
    x = torch.from_numpy(g.normal(size=(3000, 16)).astype(np.float32)).to(cuda)
    monkeypatch.setattr(pq, "scratch_budget", lambda device: 1 << 40)
    want = pq.encode_indices(q, x)
    monkeypatch.setattr(pq, "scratch_budget", lambda device: 8 * 8 * 4096 * 100)  # 100 a chunk
    assert torch.equal(pq.encode_indices(q, x), want)


def test_neg_scores_one_pass_on_card(cuda):
    """ops/knn._neg_scores' one-pass -b2 + 2 cross equals 2 cross - b2 bit
    for bit on the card too (doubling is exact, so a fused multiply-add
    rounds once, as the two passes do)."""
    from qadc_tpu_torch.core.tensors import full_f32_matmul
    from qadc_tpu_torch.ops.knn import _neg_scores

    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((3, 2000, 16), generator=g, device=cuda) * 37
    b = torch.randn((3, 4096, 16), generator=g, device=cuda) * 11
    with full_f32_matmul():
        cross = torch.matmul(q, b.transpose(-1, -2))
    assert torch.equal(_neg_scores(q, b), 2.0 * cross - torch.sum(b * b, dim=-1)[..., None, :])
