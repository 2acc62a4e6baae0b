"""Kernel M3 (direct_scan): the plain version vs qadc_tpu's
rows_adc_grouped_prefetch in interpret mode (compact_out, mask_sizes,
tile_min=32), its (QA*cpr, rpp) c-major output mapped to code order.

Tolerance: rtol 1e-6, atol 1e-5 * max (float32 sums of 16 terms in another
order); MASK_BIG placement exact; the port's 32-code tile minima equal the
minima of its own output exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.index import ivf as jivf
from qadc_tpu.kernels import lut_scan as jls
from qadc_tpu_torch.kernels import lut_scan
from qadc_tpu_torch.ops.topk import exact_screen_smallest, exact_tile_screen
from torch_parity import EMPTY_PART, TINY_PART, TINY_SIZE, synthetic_index, to_port, trained_index


def _pairs(kind):
    if kind == "trained":
        jindex, queries, _ = trained_index()
        q, ma = 2, 6
    else:
        jindex, queries = synthetic_index()
        q, ma = 2, jindex.part_count          # empty and tiny partitions too
    parts, rot = jivf.assign_queries(jindex, queries[:q], ma)
    tables = jivf.adc_tables(rot, jindex.pq.centroids)
    qa, m = q * ma, jindex.pq.sq_count
    tlo, thi = jivf.tile_tables_rows(tables.reshape(qa, m, 16))
    pflat = np.asarray(parts).reshape(qa).astype(np.int32)
    return jindex, pflat, np.array(tlo), np.array(thi)


@pytest.mark.parametrize("kind", ["trained", "synthetic"])
def test_direct_scan_matches_reference(kind):
    jindex, pflat, tlo, thi = _pairs(kind)
    qa = pflat.shape[0]
    cpr, cb = jindex.cpr, jindex.pq.code_size
    rpp = jindex.part_pad // cpr
    sizes = np.asarray(jindex.part_sizes)[pflat]
    jd, _ = jls.rows_adc_grouped_prefetch(
        jindex.codes.reshape(-1, 128), jnp.asarray(pflat), jnp.asarray(tlo),
        jnp.asarray(thi), rpp, cb=cb, interpret=True, compact_out=True,
        mask_sizes=jnp.asarray(sizes), tile_min=32)
    want = np.asarray(jd).reshape(qa, cpr, rpp).transpose(0, 2, 1).reshape(qa, -1)

    tindex = to_port(jindex)
    got, mins = lut_scan.direct_scan(
        tindex.codes, torch.from_numpy(pflat), torch.from_numpy(tlo),
        torch.from_numpy(thi), torch.from_numpy(sizes))
    got, mins = got.numpy(), mins.numpy()
    big = want == jls.MASK_BIG
    np.testing.assert_array_equal(got == lut_scan.MASK_BIG, big)
    assert big.any() and not big.all()
    real = ~big
    np.testing.assert_allclose(got[real], want[real], rtol=1e-6,
                               atol=1e-5 * np.abs(want[real]).max())
    np.testing.assert_array_equal(mins, got.reshape(qa, -1, 32).min(axis=-1))
    if kind == "synthetic":
        assert (got[pflat == EMPTY_PART] == lut_scan.MASK_BIG).all()
        tiny = pflat == TINY_PART
        assert (got[tiny] < lut_scan.MASK_BIG).sum() == TINY_SIZE * tiny.sum()


def test_direct_scan_checks_part_pad():
    codes = torch.zeros((2, 8, 128), dtype=torch.uint8)  # part_pad 128
    t = torch.zeros((1, 128))
    with pytest.raises(ValueError):
        lut_scan.direct_scan(codes, torch.zeros(1, dtype=torch.int32), t, t,
                             torch.zeros(1, dtype=torch.int32))


def test_direct_path_uses_tile_minima_exactly():
    """The direct search's screen over (distances, tile minima) equals the
    exact screen over the distances alone."""
    jindex, pflat, tlo, thi = _pairs("synthetic")
    tindex = to_port(jindex)
    sizes = tindex.part_sizes[torch.from_numpy(pflat).long()]
    d, mins = lut_scan.direct_scan(tindex.codes, torch.from_numpy(pflat),
                                   torch.from_numpy(tlo), torch.from_numpy(thi), sizes)
    q = 2
    row = d.reshape(q, -1)
    sv, idx = exact_tile_screen(row, 100, mins=mins.reshape(q, -1))
    ev, eidx = exact_screen_smallest(row, 100)
    torch.testing.assert_close(sv, ev, rtol=0, atol=0)
    torch.testing.assert_close(idx, eidx, rtol=0, atol=0)
