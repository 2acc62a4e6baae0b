"""The conventional-ADC scan kernels' plain versions vs the Pallas kernels in
interpret mode, on identical float tables and routed groups.

  M1 with float32 tables (grouped_scan_plain) vs lut_scan_grouped_prefetch
    and lut_scan_grouped_tq with acc_dtype_name="float32", sq_count 16 and
    32: per-(pair, row) minima of every valid window, rtol 1e-6 (the Pallas
    kernels sum by a one-hot matmul, the port in rows_adc's fixed order).
    The port's minima equal rows_adc_plain's distances bit for bit.
  grouped_scan8_plain vs lut_scan8_grouped_prefetch (sq_count 4, 8, 16) and
    lut_scan8_grouped_tq (byte-planes, sq_count 8): per-(pair, window)
    minima rtol 1e-6 on windows whose codes are all real, the JAX slots
    mapped to code indices with slots_to_rows, argmins equal where the
    minimum is unique (no other member within 1e-5 of it).
The synthetic indexes carry an empty partition and random sizes, so rows
and windows past a partition's size (trimmed) are in every case.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.index import ivf as jivf
from qadc_tpu.index.routing import route_queries as j_route
from qadc_tpu.kernels import lut_scan as jls
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.index.routing import route_queries
from qadc_tpu_torch.kernels import lut_scan
from torch_parity import EMPTY_PART, synthetic_index, to_port, trained_index

G = 8  # group size: small keeps the interpret-mode kernels quick


def _case(jindex, queries, q, ma, k, seed):
    parts, _ = jivf.assign_queries(jindex, queries[:q], ma)
    parts = np.asarray(parts).astype(np.int32)
    # Non-negative, as distance tables are: sums have no cancellation.
    tables = np.random.default_rng(seed).random(
        size=(q * ma, jindex.pq.sq_count, k)).astype(np.float32)
    return parts, tables


def _port_groups(tindex, parts):
    routed = route_queries(torch.from_numpy(parts), tindex.part_count, G)
    return routed, (routed.group_part, routed.slot_pairs(), ivf._group_sizes(tindex, routed))


def _pair_rows(routed, qa):
    return np.asarray(routed.qa_group.reshape(qa) * G + routed.qa_slot.reshape(qa))


# ---------------------------------------------------------------- M1, float32


def _jax_m1_f32(jindex, parts, tables):
    """(QA, C) float window minima of the JAX grouped kernel, window = cpr."""
    qa = parts.size
    part_pad, cb = jindex.part_pad, jindex.pq.code_size
    window = 128 // cb
    block_n = math.gcd(2048, part_pad)
    routed = j_route(jnp.asarray(parts), jindex.part_count, G)
    nblk = jivf._group_nblk(jindex.part_sizes, routed.group_part, block_n,
                            part_pad // block_n)
    if jindex.planes is not None:
        tcat = jls.build_scan_tables_tq(jnp.asarray(tables), q_pad=qa).astype(jnp.float32)
        (gcat,) = jivf._group_table_slabs_tq(routed, tcat)
        vals = jls.lut_scan_grouped_tq(
            jindex.planes, routed.group_part, gcat, rows_per_group=part_pad, cb=cb,
            block_n=block_n, window=window, interpret=True, acc_dtype_name="float32",
            group_nblk=nblk)
    else:
        tlo, thi = jls.build_scan_tables(jnp.asarray(tables), q_pad=qa)
        glo, ghi = jivf._group_table_slabs(routed, tlo.T.astype(jnp.float32),
                                           thi.T.astype(jnp.float32))
        vals = jls.lut_scan_grouped_prefetch(
            jindex.codes.reshape(-1, 128), routed.group_part, glo, ghi,
            rows_per_group=part_pad, cb=cb, block_n=block_n, window=window,
            interpret=True, transpose_out=True, acc_dtype_name="float32",
            group_nblk=nblk)
    return np.asarray(vals)[_pair_rows(routed, qa)]


def _m1_case(kind):
    if kind == "row128":
        jindex, queries, _ = trained_index()
        assert jindex.planes is None  # the JAX side runs lut_scan_grouped_prefetch
        return jindex, *_case(jindex, queries, 6, 4, 16, 1)
    jindex, queries = synthetic_index(m=32 if kind == "tq32" else 16)
    assert jindex.planes is not None  # the JAX side runs lut_scan_grouped_tq
    return jindex, *_case(jindex, queries, 4, jindex.part_count, 16, 2)


@pytest.mark.parametrize("kind", ["row128", "tq16", "tq32"])
def test_grouped_scan_f32_matches_reference(kind):
    jindex, parts, tables = _m1_case(kind)
    tindex = to_port(jindex)
    _, args = _port_groups(tindex, parts)
    got = lut_scan.grouped_scan(tindex.codes, torch.from_numpy(tables), *args)
    assert got.dtype == torch.float32
    sz = tindex.part_sizes[torch.from_numpy(parts.reshape(-1)).long()]
    valid = ivf._window_valid_mask(sz, tindex.codes.shape[1], tindex.cpr).numpy()
    got = got.numpy()
    assert valid.any() and np.isinf(got[~valid]).all()   # trimmed rows: +inf
    want = _jax_m1_f32(jindex, parts, tables)
    np.testing.assert_allclose(got[valid], want[valid], rtol=1e-6)
    if kind != "row128":  # the empty partition's pairs have no valid window
        empty = parts.reshape(-1) == EMPTY_PART
        assert empty.any() and not valid[empty].any()


@pytest.mark.parametrize("m", [16, 32])
def test_grouped_scan_f32_equals_rows_adc_bit_for_bit(m):
    jindex, queries = synthetic_index(m=m)
    tindex = to_port(jindex)
    parts, tables = _case(jindex, queries, 4, 3, 16, 3)
    _, args = _port_groups(tindex, parts)
    tab = torch.from_numpy(tables)
    got = lut_scan.grouped_scan(tindex.codes, tab, *args)         # (QA, rpp)
    qa, rpp = got.shape
    cpr = tindex.cpr
    pair = torch.arange(qa, dtype=torch.int32).repeat_interleave(rpp)
    part = torch.from_numpy(parts.reshape(-1)).long()
    rows = (part[:, None] * rpp + torch.arange(rpp)).reshape(-1).to(torch.int32)
    tlo, thi = ivf.tile_tables_rows(tab)
    d = lut_scan.rows_adc_plain(tindex.codes.reshape(-1, 128), rows, pair, tlo, thi)
    code = torch.arange(rpp * cpr).reshape(rpp, cpr)
    sz = tindex.part_sizes[part]
    d = torch.where(code[None] < sz[:, None, None], d.reshape(qa, rpp, cpr), torch.inf)
    want = d.amin(dim=-1)
    assert torch.isfinite(want).any()
    assert torch.equal(got, want)


def test_grouped_scan_int8_trims_and_masks_padded_codes():
    """int8 tables: rows past the size hold TRIM_SENTINEL and a padded code
    never wins a row (the row is made all-pad but for its first code)."""
    jindex, queries = synthetic_index()
    tindex = to_port(jindex)
    parts = np.array([[0]], np.int32)
    codes = tindex.codes.clone()
    codes[0, 0, 8:] = 0                                  # codes 1..15 of row 0
    qt = torch.full((1, 16, 16), 100, dtype=torch.int8)
    qt[:, :, 0] = 0                                      # the all-zero code scores 0
    routed = route_queries(torch.from_numpy(parts), tindex.part_count, G)
    sizes = torch.where(routed.group_valid, 1, 0).to(torch.int32)  # one real code
    out = lut_scan.grouped_scan(codes, qt, routed.group_part, routed.slot_pairs(), sizes)
    code0 = codes[0, 0, :8].long()
    want = int((qt[0, 0::2].long().gather(1, (code0 & 15)[:, None]).sum()
                + qt[0, 1::2].long().gather(1, (code0 >> 4)[:, None]).sum()))
    assert int(out[0, 0]) == want > 0
    assert (out[0, 1:] == lut_scan.TRIM_SENTINEL).all()


# ---------------------------------------------------------------- 5 + 6


def _jax_scan8(jindex, parts, tables, tq: bool):
    """(QA, C) minima and code indices of the JAX grouped 8-bit kernel, with
    its windows renumbered to the port's (row * cs + c0)."""
    qa = parts.size
    m, part_pad = jindex.pq.sq_count, jindex.part_pad
    cpr = 128 // m
    window = min(cpr, 8)
    block_n = math.gcd(1024, part_pad)
    routed = j_route(jnp.asarray(parts), jindex.part_count, G)
    nblk = jivf._group_nblk(jindex.part_sizes, routed.group_part, block_n,
                            part_pad // block_n)
    t8 = jls.build_scan8_tables(jnp.asarray(tables), q_pad=qa).T   # (QA, m*256)
    if tq:
        assert jindex.planes is not None and jindex.tq_block_n() == block_n
        (tg,) = jivf._group_table_slabs_tq(routed, t8)
        vals, slots = jls.lut_scan8_grouped_tq(
            jindex.planes, routed.group_part, tg, rows_per_group=part_pad, m=m,
            block_n=block_n, window=window, interpret=True, group_nblk=nblk)
    else:
        (tg,) = jivf._group_table_slabs(routed, t8)
        vals, slots = jls.lut_scan8_grouped_prefetch(
            jindex.codes.reshape(-1, 128), routed.group_part, tg,
            rows_per_group=part_pad, m=m, block_n=block_n, window=window,
            interpret=True, transpose_out=True, group_nblk=nblk)
    rows = _pair_rows(routed, qa)
    vals = np.asarray(vals)[rows]
    idx = np.asarray(jls.slots_to_rows(jnp.asarray(np.asarray(slots)[rows]), block_n, m))
    # JAX window j: block j // gr, in-block slot s = j % gr covers storage
    # row s % R of the block, positions (s // R) + k * cs.
    c = part_pad // window
    gr, r_blk, cs = block_n // window, block_n // cpr, cpr // window
    j = np.arange(c)
    port_w = ((j // gr) * r_blk + (j % gr) % r_blk) * cs + (j % gr) // r_blk
    out_v = np.empty_like(vals)
    out_i = np.empty_like(idx)
    out_v[:, port_w] = vals
    out_i[:, port_w] = idx
    return out_v, out_i


def _member_sums(tindex, parts, tables):
    """(QA, part_pad) float64 distance of every code from the bf16 tables."""
    m = tindex.pq.sq_count
    t = torch.from_numpy(tables).to(torch.bfloat16).double().numpy()
    codes = tindex.codes.numpy().reshape(tindex.part_count, -1, m)[parts.reshape(-1)]
    return sum(np.take_along_axis(t[:, b], codes[..., b].astype(np.int64), 1)
               for b in range(m))


def _scan8_compare(jindex, parts, tables, tq: bool):
    tindex = to_port(jindex)
    m = tindex.pq.sq_count
    window, cs = lut_scan.scan8_windows(m)
    _, args = _port_groups(tindex, parts)
    got_v, got_i = lut_scan.grouped_scan8(
        tindex.codes, torch.from_numpy(tables).to(torch.bfloat16), *args)
    got_v, got_i = got_v.numpy(), got_i.numpy()
    want_v, want_i = _jax_scan8(jindex, parts, tables, tq)
    # Members of each port window, as code indices: (C, window).
    cpr = 128 // m
    w = np.arange(got_v.shape[1])
    members = (w // cs * cpr + w % cs)[:, None] + np.arange(window) * cs
    sz = tindex.part_sizes.numpy()[parts.reshape(-1)]
    full = members.max(axis=1)[None, :] < sz[:, None]        # every member real
    dead = members.min(axis=1)[None, :] >= sz[:, None]       # no member real
    assert full.any() and dead.any()
    np.testing.assert_allclose(got_v[full], want_v[full], rtol=1e-6)
    assert np.isinf(got_v[dead]).all() and (got_i[dead] == -1).all()
    sums = _member_sums(tindex, parts, tables)[:, members]    # (QA, C, window)
    srt = np.sort(sums, axis=-1)
    unique = full & (srt[..., 1] - srt[..., 0] > 1e-5 * np.abs(srt[..., 0]))
    assert unique.sum() > 0.9 * full.sum()
    np.testing.assert_array_equal(got_i[unique], want_i[unique])
    # The port's argmin is a member of its window holding the minimum.
    live = ~dead
    pick = np.take_along_axis(sums, ((got_i - members[None, :, 0]) // cs)[..., None]
                              .clip(0), -1)[..., 0]
    np.testing.assert_allclose(pick[live], got_v[live], rtol=1e-6)


@pytest.mark.parametrize("m", [4, 8, 16])
def test_grouped_scan8_matches_prefetch_kernel(m):
    jindex, queries = synthetic_index(m=m, sq_bits=8)
    parts, tables = _case(jindex, queries, 3, jindex.part_count, 256, m)
    _scan8_compare(jindex, parts, tables, tq=False)


def test_grouped_scan8_matches_tq_kernel():
    jindex, queries = synthetic_index(m=8, sq_bits=8)
    parts, tables = _case(jindex, queries, 3, 4, 256, 80)
    _scan8_compare(jindex, parts, tables, tq=True)


def test_grouped_scan8_padded_codes_never_win():
    """A partition whose padding repeats a code that beats all its real
    codes: no window reports a padded code, and a window holding only
    padding is +inf / -1."""
    jindex, queries = synthetic_index(m=8, sq_bits=8)
    tindex = to_port(jindex)
    m = 8
    codes = tindex.codes.clone().reshape(tindex.part_count, -1, m)
    codes[0, 20:] = 7                                     # pads (size 20) all code 7
    tables = torch.ones((1, m, 256), dtype=torch.bfloat16)
    tables[:, :, 7] = 0                                   # code 7 scores 0
    codes[0, :20] = torch.where(codes[0, :20] == 7, 8, codes[0, :20])
    routed = route_queries(torch.zeros((1, 1), dtype=torch.int32), tindex.part_count, G)
    sizes = torch.where(routed.group_valid, 20, 0).to(torch.int32)
    v, i = lut_scan.grouped_scan8(codes.reshape(tindex.codes.shape), tables,
                                  routed.group_part, routed.slot_pairs(), sizes)
    live = i[0] >= 0
    assert int(live.sum()) == 4                           # rows 0, 1: two classes each
    assert (i[0][live] < 20).all() and (v[0][live] == m).all()
    assert torch.isinf(v[0][~live]).all()
