"""The window scans' plain version vs the Pallas kernels in interpret mode,
on identical codes and tables.

  flat_scan_window (kernels 8, 8v) vs lut_scan_reduce at (cb 8, block 1024,
    W 16), (cb 8 and 16, block 512, W 8) and (cb 16, block 1024, W 16), with
    n = N_pad (no padded code, where the two packages' rules agree): minima
    bit-exact with int8 tables; argmin code ids exact with with_rows (ties to
    the lowest slot in both); transpose_out the transpose; float32 tables
    rtol 1e-5 (the Pallas kernel sums by a one-hot matmul, the port in
    rows_adc's order). The JAX side runs under each of its variants "int8",
    "int8c" and "bf16"; the port takes the same names and runs one kernel.
  flat_scan_window_regs (kernel 10) vs lut_scan_vpu_reduce: bit-exact.
  slots_to_rows / window_slots vs the JAX package's.
  Ties: a constant table gives each window's first slot; with few distinct
    entries the lowest SLOT wins in both packages, which at (cb 16, block
    1024, W 16) is not always the lowest tied code id.
  The illegal shapes raise as in JAX.
  lut_scan_topk_int8 (8w) vs JAX's: equal at num_valid = N_pad; at
    num_valid = 4000 of 4096 the decided difference (ROADMAP Queue 3): the
    port lets no padded code into a minimum, so ids < 4000, every value is
    its code's exact quantized distance, and the sorted values are nowhere
    larger than JAX's (which drops the real codes of a window whose argmin
    is padding).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.kernels import lut_scan as jls
from qadc_tpu_torch.kernels import lut_scan

N_PAD, Q = 4096, 5
# (cb, block_n, window)
SHAPES = [(8, 1024, 16), (8, 512, 8), (16, 512, 8), (16, 1024, 16)]
IDS = [f"cb{cb}-b{b}-w{w}" for cb, b, w in SHAPES]


@functools.cache
def _codes(cb: int, seed: int = 0) -> np.ndarray:
    """(N_pad / cpr, 128) row128 storage of random cb-byte codes."""
    g = np.random.default_rng(seed + cb)
    return g.integers(0, 256, size=(N_PAD * cb // 128, 128), dtype=np.uint8)


def _tables(cb: int, f32: bool = False, hi: int = 127) -> np.ndarray:
    g = np.random.default_rng(10 + cb + f32)
    if f32:
        return g.random((Q, 2 * cb, 16)).astype(np.float32)
    return g.integers(0, hi, (Q, 2 * cb, 16)).astype(np.int8)


def _jax_reduce(codes, tables, cb, block_n, window, **kw):
    tlo, thi = jls.build_scan_tables(jnp.asarray(tables))
    if tables.dtype == np.float32:
        kw["acc_dtype_name"] = "float32"
    vals, rows = jls.lut_scan_reduce(jnp.asarray(codes), tlo, thi, cb=cb, block_n=block_n,
                                     window=window, interpret=True, **kw)
    return np.asarray(vals), None if rows is None else np.asarray(rows)


def _port(codes, tables, n, block_n, window, **kw):
    v, i = lut_scan.flat_scan_window(torch.from_numpy(codes), torch.from_numpy(tables), n,
                                     block_n, window, **kw)
    return v.numpy(), None if i is None else i.numpy()


@pytest.mark.parametrize("variant", lut_scan.SCAN_VARIANTS)
@pytest.mark.parametrize("cb,block_n,window", SHAPES, ids=IDS)
def test_minima_match_reference(cb, block_n, window, variant):
    codes, tables = _codes(cb), _tables(cb)
    want, _ = _jax_reduce(codes, tables, cb, block_n, window, variant=variant)
    got, idx = _port(codes, tables, N_PAD, block_n, window, variant=variant)
    assert idx is None and got.dtype == np.int32
    np.testing.assert_array_equal(got, want[:, :Q])


@pytest.mark.parametrize("cb,block_n,window", SHAPES, ids=IDS)
def test_argmin_ids_match_reference(cb, block_n, window):
    """Few distinct table entries make ties inside most windows: both sides
    resolve them to the lowest slot."""
    codes, tables = _codes(cb), _tables(cb, hi=3)
    want_v, want_r = _jax_reduce(codes, tables, cb, block_n, window, with_rows=True)
    got_v, got_r = _port(codes, tables, N_PAD, block_n, window, with_rows=True)
    np.testing.assert_array_equal(got_v, want_v[:, :Q])
    np.testing.assert_array_equal(got_r, want_r[:, :Q])
    # Where slot order is not code order (cb 16, block 1024, W 16: rows g and
    # g + 64 interleave), the lowest slot is not always the lowest tied code.
    wins = torch.arange(N_PAD // window)
    members = lut_scan.slots_to_rows(lut_scan.window_slots(wins, block_n, window),
                                     block_n, cb).numpy()                  # (C, W)
    sums = _exact_sums(codes, tables)[:, members]                          # (Q, C, W)
    tied = sums == sums.min(axis=-1, keepdims=True)
    lowest_code = np.where(tied, members[None], N_PAD).min(axis=-1).T      # (C, Q)
    slot_order_is_code_order = (np.diff(members, axis=1) > 0).all()
    assert (got_r == lowest_code).all() == slot_order_is_code_order


@pytest.mark.parametrize("cb,block_n,window", SHAPES, ids=IDS)
def test_transposed_minima_match_reference(cb, block_n, window):
    codes, tables = _codes(cb), _tables(cb)
    want, _ = _jax_reduce(codes, tables, cb, block_n, window, transpose_out=True)
    got, _ = _port(codes, tables, N_PAD, block_n, window, transpose_out=True)
    assert got.shape == (Q, N_PAD // window)
    np.testing.assert_array_equal(got, want[:Q])


@pytest.mark.parametrize("cb,block_n,window", SHAPES, ids=IDS)
def test_float_tables_match_reference(cb, block_n, window):
    codes, tables = _codes(cb), _tables(cb, f32=True)
    want, _ = _jax_reduce(codes, tables, cb, block_n, window)
    got, _ = _port(codes, tables, N_PAD, block_n, window)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want[:, :Q], rtol=1e-5)


@pytest.mark.parametrize("cb,block_n,window", SHAPES, ids=IDS)
def test_regs_engine_matches_vpu_reference(cb, block_n, window):
    codes, tables = _codes(cb), _tables(cb)
    tlo, thi = jls.build_scan_tables(jnp.asarray(tables))
    want = np.asarray(jls.lut_scan_vpu_reduce(jnp.asarray(codes), tlo, thi, cb=cb,
                                              block_n=block_n, window=window, interpret=True))
    got = lut_scan.flat_scan_window_regs(torch.from_numpy(codes), torch.from_numpy(tables),
                                         N_PAD, block_n, window)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want[:, :Q])


@pytest.mark.parametrize("cb,block_n,window", SHAPES, ids=IDS)
def test_slot_maps_match_reference(cb, block_n, window):
    slots = np.arange(3 * block_n)
    np.testing.assert_array_equal(
        lut_scan.slots_to_rows(torch.from_numpy(slots), block_n, cb).numpy(),
        np.asarray(jls.slots_to_rows(jnp.asarray(slots), block_n, cb)))
    wins = np.arange(3 * block_n // window)
    np.testing.assert_array_equal(
        lut_scan.window_slots(torch.from_numpy(wins), block_n, window).numpy(),
        np.asarray(jls.window_slots(jnp.asarray(wins, jnp.int32), block_n, window)))


@pytest.mark.parametrize("cb,block_n,window", SHAPES, ids=IDS)
def test_all_ties_go_to_the_lowest_slot(cb, block_n, window):
    """A constant table: every code of a window ties, and the argmin is the
    code of the window's first slot, in JAX and in the port."""
    codes = _codes(cb)
    tables = np.full((Q, 2 * cb, 16), 3, np.int8)
    _, want_r = _jax_reduce(codes, tables, cb, block_n, window, with_rows=True)
    got_v, got_r = _port(codes, tables, N_PAD, block_n, window, with_rows=True)
    np.testing.assert_array_equal(got_r, want_r[:, :Q])
    assert (got_v == 3 * 2 * cb).all()
    wins = torch.arange(N_PAD // window)
    members = lut_scan.slots_to_rows(lut_scan.window_slots(wins, block_n, window), block_n, cb)
    np.testing.assert_array_equal(got_r[:, 0], members[:, 0].numpy())


def test_padded_codes_enter_no_minimum():
    """n inside a window: its padded members are left out, windows past n
    hold the sentinel and id -1 (int8) or +inf (float tables)."""
    cb, block_n, window, n = 8, 1024, 16, 3000
    codes = _codes(cb)
    for f32 in (False, True):
        tables = _tables(cb, f32=f32)
        got_v, got_r = _port(codes, tables, n, block_n, window, with_rows=True)
        full_v, _ = _port(codes, tables, N_PAD, block_n, window, with_rows=True)
        wins = torch.arange(N_PAD // window)
        members = lut_scan.slots_to_rows(lut_scan.window_slots(wins, block_n, window),
                                         block_n, cb).numpy()
        real = members < n
        empty, whole = ~real.any(axis=1), real.all(axis=1)
        assert empty.any() and (~empty & ~whole).any()
        assert (got_r[empty] == -1).all() and (got_r[~empty] < n).all()
        sentinel = np.inf if f32 else lut_scan.TRIM_SENTINEL
        assert (got_v[empty] == sentinel).all()
        np.testing.assert_array_equal(got_v[whole], full_v[whole])
        assert (got_v[~empty] >= full_v[~empty]).all()


def test_illegal_shapes_raise():
    codes, tables = torch.from_numpy(_codes(8)), torch.from_numpy(_tables(8))
    with pytest.raises(ValueError, match="multiple of block_n"):
        lut_scan.flat_scan_window(codes, tables, N_PAD, 3072, 16)
    with pytest.raises(ValueError, match="multiple of window"):
        lut_scan.flat_scan_window(codes, tables, N_PAD, 1024, 48)
    with pytest.raises(ValueError, match="min-only"):
        lut_scan.flat_scan_window(codes, tables, N_PAD, 1024, 16, with_rows=True,
                                  transpose_out=True)
    with pytest.raises(KeyError):
        lut_scan.flat_scan_window(codes, tables, N_PAD, 1024, 16, variant="fp8")
    with pytest.raises(ValueError, match="storage rows"):
        lut_scan.flat_scan_window(codes, tables, N_PAD, 8, 8)
    with pytest.raises(ValueError, match="multiple of block_n"):
        lut_scan.flat_scan_window_regs(codes, tables, N_PAD, 3072, 16)
    with pytest.raises(TypeError):
        lut_scan.flat_scan_window_regs(codes, tables.float(), N_PAD, 1024, 16)
    jt = jls.build_scan_tables(jnp.asarray(_tables(8)))
    with pytest.raises(ValueError):
        jls.lut_scan_reduce(jnp.asarray(_codes(8)), *jt, cb=8, block_n=3072, interpret=True)
    with pytest.raises(KeyError):
        jls.lut_scan_reduce(jnp.asarray(_codes(8)), *jt, cb=8, interpret=True, variant="fp8")


def _exact_sums(codes, tables):
    """(Q, N_pad) int64 quantized distance of every code."""
    cb = tables.shape[1] // 2
    c = codes.reshape(-1, cb).astype(np.int64)
    t = tables.astype(np.int64)
    out = np.zeros((tables.shape[0], c.shape[0]), np.int64)
    for b in range(cb):
        out += t[:, 2 * b][:, c[:, b] & 15] + t[:, 2 * b + 1][:, c[:, b] >> 4]
    return out


@pytest.mark.parametrize("cb,block_n,window", SHAPES, ids=IDS)
def test_topk_int8_matches_reference_without_padding(cb, block_n, window):
    codes, tables = _codes(cb), _tables(cb)
    want_v, want_r = jls.lut_scan_topk_int8(jnp.asarray(codes), jnp.asarray(tables), 50, N_PAD,
                                            cb=cb, block_n=block_n, window=window,
                                            interpret=True)
    got_v, got_r = lut_scan.lut_scan_topk_int8(torch.from_numpy(codes),
                                               torch.from_numpy(tables), 50, N_PAD, block_n,
                                               window)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_r.numpy(), np.asarray(want_r))


def test_topk_int8_with_padding_keeps_real_codes():
    cb, block_n, window, n_valid, r = 8, 1024, 16, 4000, 50
    codes, tables = _codes(cb), _tables(cb)
    want_v, _ = jls.lut_scan_topk_int8(jnp.asarray(codes), jnp.asarray(tables), r, n_valid,
                                       cb=cb, block_n=block_n, window=window, interpret=True)
    got_v, got_r = lut_scan.lut_scan_topk_int8(torch.from_numpy(codes),
                                               torch.from_numpy(tables), r, n_valid, block_n,
                                               window)
    got_v, got_r = got_v.numpy(), got_r.numpy()
    assert got_r.max() < n_valid and got_r.min() >= 0
    full = _exact_sums(codes, tables)
    for qi in range(Q):
        np.testing.assert_array_equal(full[qi, got_r[qi]], got_v[qi])
    assert (np.diff(got_v, axis=1) >= 0).all()
    assert (got_v <= np.sort(np.asarray(want_v), axis=1)).all()


def test_topk_int8_marks_absent_slots():
    """More results asked than windows hold a real code: +inf past them."""
    cb, block_n, window = 8, 1024, 16
    codes, tables = _codes(cb), _tables(cb)
    got_v, got_r = lut_scan.lut_scan_topk_int8(torch.from_numpy(codes),
                                               torch.from_numpy(tables), 256, 1024, block_n,
                                               window)
    finite = torch.isfinite(got_v)
    assert (finite.sum(dim=1) == 64).all()          # block 0's windows only
    assert (got_r[finite] < 1024).all() and (got_r[~finite] == -1).all()
