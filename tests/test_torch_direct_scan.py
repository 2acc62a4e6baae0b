"""Kernel M3 (direct_scan): the plain version vs qadc_tpu's
rows_adc_grouped_prefetch in interpret mode (compact_out, mask_sizes,
tile_min=32), its (QA*cpr, rpp) c-major output mapped to code order.

Tolerance: rtol 1e-6, atol 1e-5 * max (float32 sums of 16 terms in another
order); MASK_BIG placement exact; the port's 32-code tile minima equal the
minima of its own output exactly.

The chunked kernel's walk (lut_scan.direct_scan_items_plain: items of a pair
and rounds x 1024 codes, 4 codes a lane, the tables staged transposed, the
tile minima over 8 lanes) equals direct_scan_plain bit for bit at every
number of rounds, with empty and partial partitions, and the reference at
the same tolerance; direct_scan_rounds picks the rounds by the grid.

The b=1 tie case: integer-valued centroids and query make many probed codes
share a distance. Distances equal the reference's exactly; labels are compared
by distance plateau, because neither package orders a plateau by a rule: both
rank through exact_tile_screen (a cut over tile minima, then a top-k over the
kept tiles), and neither result is the stable sort of its own column order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.index import ivf as jivf
from qadc_tpu.kernels import lut_scan as jls
from qadc_tpu.quantizers.pq import ProductQuantizer
from qadc_tpu_torch.index import ivf
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


@pytest.mark.parametrize("rounds", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["trained", "synthetic"])
def test_direct_scan_walk_matches_reference(kind, rounds):
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
    args = (to_port(jindex).codes, torch.from_numpy(pflat), torch.from_numpy(tlo),
            torch.from_numpy(thi), torch.from_numpy(sizes))
    got, mins = lut_scan.direct_scan_items_plain(*args, rounds)
    plain = lut_scan.direct_scan_plain(*args)
    assert torch.equal(got, plain[0]) and torch.equal(mins, plain[1])
    got = got.numpy()
    big = want == jls.MASK_BIG
    np.testing.assert_array_equal(got == lut_scan.MASK_BIG, big)
    np.testing.assert_allclose(got[~big], want[~big], rtol=1e-6,
                               atol=1e-5 * np.abs(want[~big]).max())


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("rounds", [1, 2, 4])
@pytest.mark.parametrize("part_pad", [256, 768, 2048, 4352])
def test_direct_scan_walk_equals_plain(cb, rounds, part_pad):
    """Partitions of size 0, 1, 31, 33, full and one short of full; part_pad
    less than a round, a partial round and several rounds."""
    g = np.random.default_rng([cb, rounds, part_pad])
    parts, qa = 6, 9
    codes = torch.from_numpy(g.integers(0, 256, (parts, part_pad * cb // 128, 128),
                                        dtype=np.uint8))
    part_sizes = np.array([0, 1, 31, 33, part_pad, part_pad - 1], np.int32)
    pp = g.integers(0, parts, qa).astype(np.int32)
    pp[:parts] = np.arange(parts)
    args = (codes, torch.from_numpy(pp),
            torch.from_numpy(g.uniform(0, 30, (qa, 16 * cb)).astype(np.float32)),
            torch.from_numpy(g.uniform(0, 30, (qa, 16 * cb)).astype(np.float32)),
            torch.from_numpy(part_sizes[pp]))
    got = lut_scan.direct_scan_items_plain(*args, rounds)
    want = lut_scan.direct_scan_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (got[0][0] == lut_scan.MASK_BIG).all()              # the empty partition
    dispatched = lut_scan.direct_scan(*args)                   # the wrapper on the CPU
    assert torch.equal(dispatched[0], want[0]) and torch.equal(dispatched[1], want[1])


def test_direct_scan_rounds_fill_the_sms():
    """One round where four would leave an SM of 132 without a block (b=1:
    24 pairs); four otherwise; never more than a pair's rounds."""
    sms = 132
    assert lut_scan.direct_scan_rounds(24, 4096, sms) == 1
    assert lut_scan.direct_scan_rounds(24, 12288, sms) == 1
    assert lut_scan.direct_scan_rounds(768, 4096, sms) == 4
    assert lut_scan.direct_scan_rounds(768, 12288, sms) == 4
    assert lut_scan.direct_scan_rounds(3072, 4096, sms) == 4
    assert lut_scan.direct_scan_rounds(3072, 12288, sms) == 4
    assert lut_scan.direct_scan_rounds(131, 4096, sms) == 1
    assert lut_scan.direct_scan_rounds(132, 4096, sms) == 4
    assert lut_scan.direct_scan_rounds(10 ** 6, 1024, sms) == 1
    assert lut_scan.direct_scan_rounds(10 ** 6, 2048, sms) == 2


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


def _tie_index(seed):
    """A JAX IVF index (4 partitions of 512 slots: full, partial, empty,
    small; 16x4 PQ, dim 32) whose centroids are 0/1-valued and whose coarse
    centroids and query are small integers: every distance is a small integer."""
    rng = np.random.default_rng(seed)
    parts, part_pad, dim, m = 4, 512, 32, 16
    sizes = np.array([512, 300, 0, 77], np.int32)
    codes = rng.integers(0, 256, size=(parts, part_pad, 8), dtype=np.uint8)
    labels = rng.permutation(parts * part_pad).astype(np.int32).reshape(parts, part_pad)
    for p, size in enumerate(sizes):  # tail padding repeats the last code / label
        codes[p, size:] = codes[p, size - 1] if size else 0
        labels[p, size:] = labels[p, size - 1] if size else 0
    index = jivf.IVFIndex(
        pq=ProductQuantizer(centroids=jnp.asarray(
            rng.integers(0, 2, size=(m, 16, dim // m)).astype(np.float32)), sq_bits=4),
        coarse_centroids=jnp.asarray(rng.integers(-2, 3, size=(parts, dim)).astype(np.float32)),
        codes=jnp.asarray(codes.reshape(parts, -1, 128)), labels=jnp.asarray(labels),
        part_sizes=jnp.asarray(sizes), n=int(sizes.sum()), max_part_size=512)
    return index, rng.integers(-1, 2, size=(1, dim)).astype(np.float32)


@pytest.mark.parametrize("r", [20, 100])
@pytest.mark.parametrize("seed", [21, 22, 23])
def test_direct_b1_ties_labels_match_reference(seed, r):
    jindex, query = _tie_index(seed)
    ma = 3
    jd, jl = jivf.search_qadc(jindex, jnp.asarray(query), r=r, ma=ma, keep=0.05, direct=True,
                              interpret=True)
    td, tl = ivf.search_qadc(to_port(jindex), query, r=r, ma=ma, keep=0.05, direct=True)
    jd, jl, td, tl = np.asarray(jd)[0], np.asarray(jl)[0], td.numpy()[0], tl.numpy()[0]
    np.testing.assert_array_equal(td, jd)              # integer sums: no rounding anywhere
    values, counts = np.unique(jd, return_counts=True)
    assert counts.max() >= 3 and len(values) < r       # plateaus, not a strict ranking
    # Every real probed code's distance, by label: what a plateau may hold.
    parts, rot = jivf.assign_queries(jindex, jnp.asarray(query), ma)
    tables = np.asarray(jivf.adc_tables(rot, jindex.pq.centroids)).reshape(ma, 16, 16)
    exact = {}
    for a, p in enumerate(np.asarray(parts).reshape(ma)):
        size = int(jindex.part_sizes[p])
        code = np.asarray(jindex.codes).reshape(4, 512, 8)[p, :size].astype(np.int64)
        d = sum(tables[a, 2 * b][code[:, b] & 15] + tables[a, 2 * b + 1][code[:, b] >> 4]
                for b in range(8))
        exact.update(zip(np.asarray(jindex.labels)[p, :size].tolist(), d.tolist()))
    for labels in (jl, tl):                            # each label carries its own distance
        assert len(set(labels.tolist())) == r
        np.testing.assert_array_equal([exact[label] for label in labels.tolist()], jd)
    # Plateaus wholly inside the cut hold the same labels in both packages;
    # the last one is cut somewhere inside a tie, where any of its codes is right.
    for value in values[:-1]:
        assert set(jl[jd == value].tolist()) == set(tl[td == value].tolist()), value
    below = sum(1 for d in exact.values() if d < values[-1])
    assert below == int((jd < values[-1]).sum())
