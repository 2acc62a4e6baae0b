"""The flat scan kernels' plain versions vs the Pallas kernels in interpret
mode, on identical codes and tables.

  flat_scan_plain (kernels 7 + 8) vs lut_scan_tq (byte-planes) and
    lut_scan_reduce(transpose_out=True) (row128 storage), at 16x4 and 32x4
    PQ (cb 8 and 16): per-(query, row) minima of every row holding a real
    code, int8 tables bit-exact, float32 tables rtol 1e-6 (the Pallas
    kernels sum by a one-hot matmul, the port in rows_adc's order). The
    index pads by repeating the last code, so a partly real row has the same
    minimum in both; rows with no real code hold the port's sentinel.
  flat_scan_plain(with_rows=True) vs lut_scan_reduce(with_rows=True): argmin
    code indices equal wherever the row's minimum over its real codes is
    unique.
  flat_scan8_plain (kernel 9) vs lut_scan8_reduce(transpose_out=True) at
    m = 4, 8, 16 and 32: window membership equal to window_slots +
    slots_to_rows; minima rtol 1e-5 on windows whose codes are all real
    (bf16 tables, float32 sums in another order), argmins equal wherever
    the JAX minimum beats the window's runner-up by more than that; windows
    with no real code +inf and -1.
The real code count n = 3997 is not a multiple of any cpr, so every case has
a partly real row and rows of padding. A last-code flood case shows the
reference's padded argmin that the port's kernel 9 never returns.

The float32 and 8-bit cases run twice: through the wrappers (the plain
versions, on the CPU) and, as the _query_minor tests, through
flat_scan_query_minor_plain / flat_scan8_query_minor_plain, the walk of the
query-minor kernels (csrc/flat_scan_qm.cuh, flat_scan8_qm.cuh), at the same
tolerances.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.kernels import lut_scan as jls
from qadc_tpu_torch.kernels import lut_scan

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

N_PAD, N, Q = 4096, 3997, 40


@functools.cache
def _codes(code_size: int, n: int = N, n_pad: int = N_PAD, seed: int = 0) -> np.ndarray:
    """(n_pad / cpr, 128) row128 storage of random codes, the tail past n
    repeating the last code (FlatBuilder's padding)."""
    codes = np.random.default_rng(seed + code_size).integers(
        0, 256, size=(n_pad, code_size), dtype=np.uint8)
    codes[n:] = codes[n - 1]
    return codes.reshape(-1, 128)


def _tables4(m: int, f32: bool) -> np.ndarray:
    g = np.random.default_rng(m + f32)
    if f32:
        return g.random((Q, m, 16)).astype(np.float32)
    return g.integers(0, 128, (Q, m, 16)).astype(np.int8)


def _code_sums4(codes_rows: np.ndarray, tables: np.ndarray) -> np.ndarray:
    """(Q, N_pad) exact sums (int64 or float64) of every code."""
    q, m, _ = tables.shape
    codes = codes_rows.reshape(-1, m // 2).astype(np.int64)
    t = tables.astype(np.int64 if tables.dtype == np.int8 else np.float64)
    out = np.zeros((q, codes.shape[0]), t.dtype)
    for b in range(m // 2):
        out += t[:, 2 * b][:, codes[:, b] & 15] + t[:, 2 * b + 1][:, codes[:, b] >> 4]
    return out


def _jax_scan4(codes_rows, tables, planes: bool):
    """(Q, R) row minima of the JAX flat 4-bit kernel at window == cpr."""
    cb = tables.shape[1] // 2
    cpr = 128 // cb
    acc = "float32" if tables.dtype == np.float32 else "int32"
    if planes:
        bn = jls.pick_block_n_tq(N_PAD, cpr)
        vals = jls.lut_scan_tq(
            jls.to_planes(jnp.asarray(codes_rows), cb, bn),
            jls.build_scan_tables_tq(jnp.asarray(tables)), cb=cb, block_n=bn,
            window=cpr, interpret=True, acc_dtype_name=acc)
    else:
        tlo, thi = jls.build_scan_tables(jnp.asarray(tables))
        if acc == "float32":
            tlo, thi = tlo.astype(jnp.float32), thi.astype(jnp.float32)
        vals, _ = jls.lut_scan_reduce(
            jnp.asarray(codes_rows), tlo, thi, cb=cb, block_n=jls.pick_block_n(N_PAD),
            window=cpr, interpret=True, transpose_out=True, acc_dtype_name=acc)
    return np.asarray(vals)[:Q]


@pytest.mark.parametrize("planes", [True, False], ids=["tq", "row128"])
@pytest.mark.parametrize("f32", [False, True], ids=["int8", "f32"])
@pytest.mark.parametrize("m", [16, 32])
def test_flat_scan_matches_reference(m, f32, planes):
    _flat_scan_matches_reference(lut_scan.flat_scan, m, f32, planes)


@pytest.mark.parametrize("planes", [True, False], ids=["tq", "row128"])
@pytest.mark.parametrize("m", [16, 32])
def test_flat_scan_query_minor_matches_reference(m, planes):
    _flat_scan_matches_reference(lut_scan.flat_scan_query_minor_plain, m, True, planes)


def _flat_scan_matches_reference(scan, m, f32, planes):
    codes = _codes(m // 2)
    tables = _tables4(m, f32)
    got, idx = scan(torch.from_numpy(codes), torch.from_numpy(tables), N)
    assert idx is None and got.dtype == (torch.float32 if f32 else torch.int32)
    got = got.numpy()
    cpr = 256 // m
    real = np.arange(codes.shape[0]) * cpr < N
    assert N % cpr and not real.all()          # a partly real row and padding rows
    want = _jax_scan4(codes, tables, planes)
    if f32:
        np.testing.assert_allclose(got[:, real], want[:, real], rtol=1e-6)
        assert np.isinf(got[:, ~real]).all()
    else:
        np.testing.assert_array_equal(got[:, real], want[:, real])
        assert (got[:, ~real] == lut_scan.TRIM_SENTINEL).all()


@pytest.mark.parametrize("f32", [False, True], ids=["int8", "f32"])
@pytest.mark.parametrize("m", [16, 32])
def test_flat_scan_with_rows_matches_reference(m, f32):
    _flat_scan_with_rows_matches_reference(lut_scan.flat_scan, m, f32)


@pytest.mark.parametrize("m", [16, 32])
def test_flat_scan_query_minor_with_rows_matches_reference(m):
    _flat_scan_with_rows_matches_reference(lut_scan.flat_scan_query_minor_plain, m, True)


def _flat_scan_with_rows_matches_reference(scan, m, f32):
    codes = _codes(m // 2)
    tables = _tables4(m, f32)
    cb = m // 2
    cpr = 128 // cb
    mins, idx = scan(torch.from_numpy(codes), torch.from_numpy(tables), N, with_rows=True)
    tlo, thi = jls.build_scan_tables(jnp.asarray(tables))
    if f32:
        tlo, thi = tlo.astype(jnp.float32), thi.astype(jnp.float32)
    want_v, want_r = jls.lut_scan_reduce(
        jnp.asarray(codes), tlo, thi, cb=cb, block_n=jls.pick_block_n(N_PAD), window=cpr,
        interpret=True, with_rows=True, acc_dtype_name="float32" if f32 else "int32")
    want_v, want_r = np.asarray(want_v).T[:Q], np.asarray(want_r).T[:Q]
    r_count = codes.shape[0]
    sums = _code_sums4(codes, tables).astype(np.float64)
    sums[:, N:] = np.inf                                          # real codes only
    srt = np.sort(sums.reshape(Q, r_count, cpr), axis=-1)
    real = np.arange(r_count) * cpr < N
    with np.errstate(invalid="ignore"):  # rows of one real code: inf - inf
        unique = real[None, :] & (srt[..., 1] - srt[..., 0] > 1e-6 * np.abs(srt[..., 0]))
    assert unique.sum() > 0.5 * Q * real.sum()
    np.testing.assert_array_equal(idx.numpy()[unique], want_r[unique])
    np.testing.assert_allclose(mins.numpy()[:, real], want_v[:, real], rtol=1e-6)
    assert (idx.numpy()[:, ~real] == -1).all()
    # The argmin is a real code of its row holding the minimum.
    pick = np.take_along_axis(sums, idx.numpy()[:, real].astype(np.int64), 1)
    np.testing.assert_allclose(pick, mins.numpy()[:, real], rtol=1e-6)


def test_flat_scan_float_minimum_is_rows_adc_distance():
    """Float minima equal rows_adc's distance of their argmin bit for bit,
    which makes the adc4 path's r-window screen exact."""
    _float_minimum_is_rows_adc_distance(lut_scan.flat_scan)


def test_flat_scan_query_minor_float_minimum_is_rows_adc_distance():
    _float_minimum_is_rows_adc_distance(lut_scan.flat_scan_query_minor_plain)


def _float_minimum_is_rows_adc_distance(scan):
    codes, tables = _codes(8), _tables4(16, True)
    tc, tt = torch.from_numpy(codes), torch.from_numpy(tables)
    mins, idx = scan(tc, tt, N, with_rows=True)
    from qadc_tpu_torch.index.ivf import tile_tables_rows

    tlo, thi = tile_tables_rows(tt)
    r_count = codes.shape[0]
    row = torch.arange(r_count, dtype=torch.int32).repeat(Q)
    pair = torch.arange(Q, dtype=torch.int32).repeat_interleave(r_count)
    d = lut_scan.rows_adc_plain(tc, row, pair, tlo, thi).reshape(Q, -1)
    real = torch.arange(r_count) * 16 < N
    assert torch.equal(torch.gather(d, 1, idx[:, real].long()), mins[:, real])


# ---------------------------------------------------------------- kernel 9


@pytest.mark.parametrize("m", [4, 8, 16, 32])
def test_flat8_members_are_the_reference_windows(m):
    c = N_PAD // lut_scan.FLAT8_WINDOW
    wid = jnp.arange(c, dtype=jnp.int32)
    want = np.asarray(jls.slots_to_rows(jls.window_slots(wid, 256, 16), 256, m))
    got = lut_scan.flat8_members(torch.arange(c), m).numpy()
    np.testing.assert_array_equal(got, np.sort(want, axis=1))
    assert (np.diff(got, axis=1) > 0).all()


def _tables8(m: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random((Q, m, 256)).astype(np.float32)


@pytest.mark.parametrize("m", [4, 8, 16, 32])
def test_flat_scan8_matches_reference(m):
    _flat_scan8_matches_reference(lut_scan.flat_scan8, m)


@pytest.mark.parametrize("m", [4, 8, 16, 32])
def test_flat_scan8_query_minor_matches_reference(m):
    _flat_scan8_matches_reference(lut_scan.flat_scan8_query_minor_plain, m)


def _flat_scan8_matches_reference(scan, m):
    codes = _codes(m)
    tables = _tables8(m, 50 + m)
    tb = torch.from_numpy(tables).to(torch.bfloat16)
    got_v, got_i = scan(torch.from_numpy(codes), tb, N)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    want_v, want_i = jls.lut_scan8_reduce(
        jnp.asarray(codes), jls.build_scan8_tables(jnp.asarray(tables)), m=m,
        interpret=True, transpose_out=True)
    want_v, want_i = np.asarray(want_v)[:Q], np.asarray(want_i)[:Q]
    members = lut_scan.flat8_members(torch.arange(N_PAD // 16), m).numpy()   # (C, 16)
    full = members.max(axis=1) < N
    dead = members.min(axis=1) >= N
    # Windows of m = 16 and 32 span rows 16 apart: each holds a real code.
    assert full.any() and dead.any() == (m <= 8) and not (full | dead).all()
    np.testing.assert_allclose(got_v[:, full], want_v[:, full], rtol=1e-5)
    assert np.isinf(got_v[:, dead]).all() and (got_i[:, dead] == -1).all()
    t = tb.double().numpy()
    code_bytes = codes.reshape(-1, m).astype(np.int64)
    sums = sum(t[:, b][:, code_bytes[:, b]] for b in range(m))          # (Q, N_pad)
    srt = np.sort(sums[:, members], axis=-1)
    clear = full[None, :] & (srt[..., 1] - srt[..., 0] > 1e-5 * np.abs(srt[..., 0]))
    assert clear.sum() > 0.9 * Q * full.sum()
    np.testing.assert_array_equal(got_i[clear], want_i[clear])
    # Every live argmin is a real member of its window holding the minimum.
    live = ~dead
    gi = got_i[:, live].astype(np.int64)
    assert (gi < N).all() and (gi >= 0).all()
    assert np.isin(gi, members[live]).all()
    np.testing.assert_allclose(np.take_along_axis(sums, gi, 1), got_v[:, live], rtol=1e-6)


def test_flat_scan8_last_code_flood():
    """16 code bytes, n = 812: the last real code (811, row 5 of block 3,
    position 3) is the best code, and the padding repeats it. In JAX's slot
    order window 3*16 + 5 runs rows 5 and 21 alternately, so the first copy
    of the best value is the padded code 936, which flat.py then masks: the
    reference loses code 811. The port's kernel leaves padding out of every
    minimum and returns 811."""
    m, n, n_pad = 16, 812, 1024
    codes = _codes(m, n=n, n_pad=n_pad)
    tables = 1.0 + _tables8(m, 7)
    last = codes.reshape(-1, m)[n - 1]
    tables[:, np.arange(m), last] = 0.0                       # code 811 scores 0
    tb = torch.from_numpy(tables).to(torch.bfloat16)
    v, i = lut_scan.flat_scan8(torch.from_numpy(codes), tb, n)
    win = 3 * 16 + 5
    assert (i[:, win] == n - 1).all() and (v[:, win] == 0).all()
    assert ((i < n) | (i == -1)).all()
    _, rows = jls.lut_scan8_reduce(jnp.asarray(codes), jls.build_scan8_tables(jnp.asarray(tables)),
                                   m=m, interpret=True, transpose_out=True)
    assert (np.asarray(rows)[:Q, win] == 936).all()            # the reference's padded argmin
