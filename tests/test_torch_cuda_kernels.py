"""The CUDA kernels against their plain PyTorch versions, on the card.

Skipped where there is no CUDA card (the kernels run only there). On a card
run it without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

Tolerances: M1, flat_scan, flat_scan_window and flat_scan_window_regs with
int8 tables (int32 sums) bit-exact; the float scans (M1, flat_scan and
flat_scan_window with float tables, grouped_scan8, flat_scan8), M2 and M3
rtol 1e-6, atol 1e-5 * max: the plain versions sum in the
kernels' order, but the card may contract or round differently. MASK_BIG
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
from qadc_tpu_torch.kernels import lut_scan


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
    before = lut_scan.launches["flat_scan_window"]
    got_v, got_i = lut_scan.flat_scan_window(codes.to(cuda), tables.to(cuda), n, block_n,
                                             window, **kw)
    torch.cuda.synchronize()
    assert lut_scan.launches["flat_scan_window"] == before + 1
    _same_minima(got_v.cpu(), want_v, f32)
    if mode == "rows":
        same = got_v.cpu() == want_v
        assert same.float().mean() > 0.99
        assert torch.equal(got_i.cpu()[same], want_i[same])     # ties: the lowest slot
    else:
        assert got_i is None and want_i is None


@pytest.mark.parametrize("m,block_n,window", WINDOW_SHAPES)
@pytest.mark.parametrize("q", [37, 130])   # a partial warp; a second block of queries
def test_flat_scan_window_regs_matches_plain(cuda, m, block_n, window, q):
    codes, tables, n = _window_inputs(m, block_n, False, q=q)
    want, _ = lut_scan.flat_scan_window_plain(codes, tables, n, block_n, window)
    before = lut_scan.launches["flat_scan_window_regs"]
    got = lut_scan.flat_scan_window_regs(codes.to(cuda), tables.to(cuda), n, block_n, window)
    same_kernel, _ = lut_scan.flat_scan_window(codes.to(cuda), tables.to(cuda), n, block_n,
                                               window)
    torch.cuda.synchronize()
    assert lut_scan.launches["flat_scan_window_regs"] == before + 1
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, same_kernel)


def test_flat_scan_window_regs_takes_negative_entries(cuda):
    """int8 entries are sign-extended by both engines, as the plain version does."""
    g = np.random.default_rng(9)
    codes = torch.from_numpy(g.integers(0, 256, (128, 128), dtype=np.uint8))
    tables = torch.from_numpy(g.integers(-128, 128, (33, 16, 16)).astype(np.int8))
    want, _ = lut_scan.flat_scan_window_plain(codes, tables, 2048, 1024, 16)
    got = lut_scan.flat_scan_window_regs(codes.to(cuda), tables.to(cuda), 2048, 1024, 16)
    assert torch.equal(got.cpu(), want)


def test_lut_scan_topk_int8_on_card_matches_plain(cuda):
    codes, tables, n = _window_inputs(16, 1024, False, q=9, blocks=8)
    want_v, want_i = lut_scan.lut_scan_topk_int8(codes, tables, 50, n, 1024, 16)
    got_v, got_i = lut_scan.lut_scan_topk_int8(codes.to(cuda), tables.to(cuda), 50, n, 1024, 16)
    assert torch.equal(got_v.cpu(), want_v) and torch.equal(got_i.cpu(), want_i)
