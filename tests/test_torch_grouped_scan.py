"""Kernel M1 (grouped_scan): the plain version vs the Pallas grouped scans
in interpret mode, on IDENTICAL int8 tables and routed groups.

  trained index (planes None) -> lut_scan_grouped_prefetch (row128 storage)
  synthetic index (planes)    -> lut_scan_grouped_tq (byte-planes)

Both are compared as per-pair (QA, C) window minima after the callers' size
mask (_window_valid_mask), so trimmed blocks and sentinels do not enter.
Tolerance: bit-exact (int32 sums of int8 entries).
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

WINDOW, G = 16, 128
MASKED = -1


def _jax_minima(jindex, parts, qtables):
    """(QA, C) masked window minima from the JAX grouped kernel."""
    q, ma = parts.shape
    qa = q * ma
    part_pad, cb = jindex.part_pad, jindex.pq.code_size
    block_n = math.gcd(2048, part_pad)
    routed = j_route(jnp.asarray(parts), jindex.part_count, G)
    nblk = jivf._group_nblk(jindex.part_sizes, routed.group_part, block_n,
                            part_pad // block_n)
    if jindex.planes is not None:
        tcat = jls.build_scan_tables_tq(jnp.asarray(qtables), q_pad=qa)
        (gcat,) = jivf._group_table_slabs_tq(routed, tcat)
        vals = jls.lut_scan_grouped_tq(
            jindex.planes, routed.group_part, gcat, rows_per_group=part_pad,
            cb=cb, block_n=block_n, window=WINDOW, interpret=True, group_nblk=nblk)
    else:
        tlo, thi = jls.build_scan_tables(jnp.asarray(qtables), q_pad=qa)
        glo, ghi = jivf._group_table_slabs(routed, tlo.T, thi.T)
        vals = jls.lut_scan_grouped_prefetch(
            jindex.codes.reshape(-1, 128), routed.group_part, glo, ghi,
            rows_per_group=part_pad, cb=cb, block_n=block_n, window=WINDOW,
            interpret=True, transpose_out=True, group_nblk=nblk)
    c = part_pad // WINDOW
    cv = np.asarray(vals[routed.qa_group.reshape(qa) * G + routed.qa_slot.reshape(qa)])
    sz = jindex.part_sizes[jnp.asarray(parts.reshape(qa))]
    valid = np.asarray(jivf._window_valid_mask(sz, c, block_n, WINDOW, cb))
    return np.where(valid, cv, MASKED), valid


def _port_minima(tindex, parts, qtables):
    q, ma = parts.shape
    qa = q * ma
    cpr = tindex.cpr
    routed = route_queries(torch.from_numpy(parts), tindex.part_count, G)
    out = lut_scan.grouped_scan(
        tindex.codes, torch.from_numpy(qtables), routed.group_part,
        routed.slot_pairs(), ivf._group_sizes(tindex, routed))
    sz = tindex.part_sizes[torch.from_numpy(parts.reshape(qa)).long()]
    valid = ivf._window_valid_mask(sz, tindex.codes.shape[1], cpr)
    return np.where(valid.numpy(), out.numpy(), MASKED), valid.numpy()


def _case(kind):
    if kind == "row128":
        jindex, queries, _ = trained_index()
        assert jindex.planes is None  # the JAX side runs lut_scan_grouped_prefetch
        q, ma = 8, 4
    else:
        jindex, queries = synthetic_index()
        assert jindex.planes is not None  # the JAX side runs lut_scan_grouped_tq
        q, ma = 6, jindex.part_count     # every partition, the empty one too
    parts, _ = jivf.assign_queries(jindex, queries[:q], ma)
    parts = np.asarray(parts).astype(np.int32)
    qtables = np.random.default_rng(q * ma).integers(
        0, 128, size=(q * ma, jindex.pq.sq_count, 16)).astype(np.int8)
    return jindex, parts, qtables


@pytest.mark.parametrize("kind", ["row128", "tq"])
def test_grouped_scan_bit_exact(kind):
    jindex, parts, qtables = _case(kind)
    want, jvalid = _jax_minima(jindex, parts, qtables)
    got, tvalid = _port_minima(to_port(jindex), parts, qtables)
    np.testing.assert_array_equal(tvalid, jvalid)
    assert jvalid.any()
    np.testing.assert_array_equal(got, want)
    if kind == "tq":  # the empty partition's pairs have no valid window
        empty = (parts.reshape(-1) == EMPTY_PART)
        assert empty.any() and not tvalid[empty].any()


def test_grouped_scan_trims_rows_past_size():
    jindex, parts, qtables = _case("tq")
    tindex = to_port(jindex)
    routed = route_queries(torch.from_numpy(parts), tindex.part_count, 4)
    sizes = torch.full((routed.gcap,), 3 * tindex.cpr, dtype=torch.int32)  # 3 rows
    out = lut_scan.grouped_scan(tindex.codes, torch.from_numpy(qtables),
                                routed.group_part, routed.slot_pairs(), sizes)
    assert (out[:, 3:] == lut_scan.TRIM_SENTINEL).all()
    assert (out[:, :3] < lut_scan.TRIM_SENTINEL).all()
    assert (out[:, :3] <= 127 * qtables.shape[1]).all()
