"""The tensor-core window scan's walk (csrc/scan_wgmma.cu:
flat_scan_window_wgmma_kernel), modelled in PyTorch where no card is.

The kernel lays a code block's codes out as the product's columns in
window-major order (csrc/window_columns.cuh: column g*W' + k holds slot
g + k*G, W' the power of two at or above W, dead columns past W), takes each
column's sum from the one-hot product, its key (sum << lw) | rank, and a
window's minimum over a run of W' columns in tiles of 128, carried across
tiles for W' > 128. lut_scan.flat_scan_window_tiles_plain walks the same
indices; here it is held to flat_scan_window_plain bit for bit, at the
(block_n, W) the card tests take, with ties (integer tables with plateaus),
negative entries and n not a multiple of W, and to the reference's
lut_scan_reduce in interpret mode at n = N_pad. lut_scan.fast_div (the
kernel's division by a multiply and a shift) is held to floor division,
and window_column_codes to the reference's slot maps. Tolerance: exact
(int32 sums of int8 entries).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.kernels import lut_scan as jls
from qadc_tpu_torch.kernels import lut_scan

torch.set_num_threads(1)  # small shapes; leave the cores to the other test workers

Q = 6
# (m, block_n, window): W = cpr; parity classes of a row; W = 2 cpr; a window
# over two tiles (256 > 128 columns); and windows of no power of two.
SHAPES = [(16, 1024, 16), (32, 1024, 16), (16, 512, 8), (32, 512, 8), (16, 1024, 32),
          (32, 1024, 32), (16, 2048, 256), (32, 2048, 256)]
ODD_SHAPES = [(16, 1536, 24), (32, 1536, 3), (16, 1024, 1), (32, 1024, 1024), (16, 768, 96)]
IDS = [f"m{m}-b{b}-w{w}" for m, b, w in SHAPES]
ODD_IDS = [f"m{m}-b{b}-w{w}" for m, b, w in ODD_SHAPES]
MODES = [{}, {"with_rows": True}, {"transpose_out": True}]
MODE_IDS = ["min", "rows", "transposed"]


def _inputs(m, block_n, blocks=3, lo=0, hi=4, seed=0):
    """Codes of `blocks` blocks and int8 tables with few distinct entries
    (plateaus: many ties inside a window)."""
    g = np.random.default_rng([seed, m, block_n, lo + 128])
    codes = g.integers(0, 256, (blocks * block_n * m // 256, 128), dtype=np.uint8)
    tables = g.integers(lo, hi, (Q, m, 16)).astype(np.int8)
    return torch.from_numpy(codes), torch.from_numpy(tables)


def _equal(got, want):
    assert torch.equal(got[0], want[0])
    assert got[1] is want[1] is None or torch.equal(got[1], want[1])


@pytest.mark.parametrize("d", [1, 2, 3, 7, 8, 24, 64, 96, 128, 1000, 1024, 8191, 65536, 1 << 20])
def test_fast_div_is_floor_division(d):
    g = np.random.default_rng(d)
    x = torch.cat([torch.arange(0, 70000), torch.from_numpy(g.integers(0, 1 << 31, 50000)),
                   torch.tensor([(1 << 31) - 1, (1 << 31) - 2])])
    assert torch.equal(lut_scan.fast_div(x, d), x // d)


@pytest.mark.parametrize("m,block_n,window", SHAPES + ODD_SHAPES, ids=IDS + ODD_IDS)
def test_window_columns_hold_the_window_slots(m, block_n, window):
    """Column (g, k) of the window-major order holds the code of window g's
    k-th slot (the reference's window_slots, slots_to_rows); dead columns
    (k >= W) and columns past the last window hold none."""
    cb, n_pad = m // 2, 3 * block_n
    lw, total = lut_scan.window_columns(n_pad, window)
    gc = torch.arange(total + 300)
    got = lut_scan.window_column_codes(gc, n_pad, block_n, window, cb)
    wins = np.arange(n_pad // window)
    slots = np.asarray(jls.window_slots(jnp.asarray(wins, jnp.int32), block_n, window))
    want = np.asarray(jls.slots_to_rows(jnp.asarray(slots), block_n, cb))      # (C, W)
    padded = np.full((n_pad // window, 1 << lw), -1)
    padded[:, :window] = want
    np.testing.assert_array_equal(got[:total].numpy(), padded.reshape(-1))
    assert (got[total:] == -1).all()
    assert sorted(got[got >= 0].tolist()) == list(range(n_pad))  # every code once


@pytest.mark.parametrize("mode", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("m,block_n,window", SHAPES + ODD_SHAPES, ids=IDS + ODD_IDS)
def test_tile_walk_equals_plain(m, block_n, window, mode):
    """Ties, padded codes inside a block and n not a multiple of W."""
    codes, tables = _inputs(m, block_n)
    n = 3 * block_n - block_n // 2 - 3
    for nn in (n, 3 * block_n, window // 2 + 1, 0):
        want = lut_scan.flat_scan_window_plain(codes, tables, nn, block_n, window, **mode)
        got = lut_scan.flat_scan_window_tiles_plain(codes, tables, nn, block_n, window,
                                                    chunk_cols=700, **mode)
        _equal(got, want)


@pytest.mark.parametrize("m,block_n,window", SHAPES, ids=IDS)
def test_tile_walk_takes_negative_entries(m, block_n, window):
    """int8 entries below zero: sum * 2^lw + rank orders negative sums too."""
    codes, tables = _inputs(m, block_n, lo=-128, hi=128)
    n = 3 * block_n - 5
    for mode in MODES:
        _equal(lut_scan.flat_scan_window_tiles_plain(codes, tables, n, block_n, window, **mode),
               lut_scan.flat_scan_window_plain(codes, tables, n, block_n, window, **mode))


@functools.cache
def _reference(m, block_n, window, with_rows):
    codes, tables = _inputs(m, block_n, blocks=2)
    tlo, thi = jls.build_scan_tables(jnp.asarray(tables.numpy()))
    vals, rows = jls.lut_scan_reduce(jnp.asarray(codes.numpy()), tlo, thi, cb=m // 2,
                                     block_n=block_n, window=window, interpret=True,
                                     with_rows=with_rows)
    return np.asarray(vals), None if rows is None else np.asarray(rows)


@pytest.mark.parametrize("with_rows", [False, True], ids=["min", "rows"])
@pytest.mark.parametrize("m,block_n,window", SHAPES, ids=IDS)
def test_tile_walk_matches_reference(m, block_n, window, with_rows):
    """At n = N_pad (no padded code: the packages' rules agree), minima and
    argmin code ids equal lut_scan_reduce's; ties go to the lowest slot in
    both."""
    codes, tables = _inputs(m, block_n, blocks=2)
    want_v, want_r = _reference(m, block_n, window, with_rows)
    got_v, got_r = lut_scan.flat_scan_window_tiles_plain(codes, tables, 2 * block_n, block_n,
                                                         window, with_rows=with_rows)
    np.testing.assert_array_equal(got_v.numpy(), want_v[:, :Q])
    if with_rows:
        np.testing.assert_array_equal(got_r.numpy(), want_r[:, :Q])


def test_tile_walk_at_cpr_is_flat_scan():
    """At W = cpr the window-major order is the storage order: the walk's
    transposed minima and ids are flat_scan_plain's with rows."""
    for m in (16, 32):
        codes, tables = _inputs(m, 1024)
        n = 3 * 1024 - 77
        cpr = 256 // m
        mins, _ = lut_scan.flat_scan_window_tiles_plain(codes, tables, n, 1024, cpr,
                                                        transpose_out=True)
        vals, ids = lut_scan.flat_scan_window_tiles_plain(codes, tables, n, 1024, cpr,
                                                          with_rows=True)
        f_mins, f_ids = lut_scan.flat_scan_plain(codes, tables, n, with_rows=True)
        assert torch.equal(mins, f_mins) and torch.equal(vals.T, f_mins)
        assert torch.equal(ids.T, f_ids)
