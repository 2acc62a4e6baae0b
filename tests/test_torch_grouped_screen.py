"""The grouped Quick-ADC screen on M1's tile minima (index/ivf.py,
ops/topk.py:exact_tile_screen).

Where the screen tiles a query's ma*C windows (ops/topk.tiles_shrink), M1
writes each 32-row tile's float minimum beside its int32 rows and the screen
reads the rows at the winning tiles only; below, it sorts the row whole. On
the CPU (no JAX): the search returns (dists, labels) equal bit for bit to the
route it replaced (the rows cast to float, masked by each partition's size,
tiled and reduced by the screen itself), with and without saturate, reranked
or not, at CB 8 and 16, above and below the tiling width; `screen.scan_tiles`
counts the tile minima the screen took from a kernel. On the card (skipped
without CUDA; run with --noconftest): the search with the kernels equals the
search with their plain versions, and the replaced route with the kernels,
on the card. Tolerance: exact everywhere.
"""

import numpy as np
import pytest
import torch

from qadc_tpu_torch.convert import ivf_index_from_arrays
from qadc_tpu_torch.eval.synth import _ivf_arrays
from qadc_tpu_torch.eval.trace import recording
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.kernels import lut_scan
from qadc_tpu_torch.ops.topk import exact_tile_screen, tiles_shrink

torch.set_num_threads(1)

R, KEEP, G = 20, 0.05, 128
WIDE = 8                     # ma: 8 x 256 or 512 rows tile at r = 20, 1,024 windows do not


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels run only there")
    return torch.device("cuda", 0)


def sized_index(m: int, device="cpu"):
    """Eight partitions of the bench geometry (16x4 or 32x4: 256 or 512
    rows), random codes in the padding too, sizes drawn: one empty, one
    full, one a code past a row."""
    rng = np.random.default_rng(m)
    arrays, meta = _ivf_arrays(rng, 8, m, 4)
    cpr = 256 // m
    pad = arrays["labels"].shape[1]
    sizes = rng.integers(1, pad, 8).astype(np.int32)
    sizes[:3] = [0, pad, 5 * cpr + 1]
    arrays["part_sizes"] = sizes
    meta = {**meta, "max_part_size": int(sizes.max())}
    queries = torch.from_numpy(rng.normal(size=(6, 128)).astype(np.float32))
    return ivf_index_from_arrays(arrays, meta, device), queries.to(device)


def old_route(index, queries, ma, rerank, saturate, kernels=lut_scan.PLAIN):
    """The grouped search as it screened before M1 wrote tile minima: the
    (QA, C) rows cast to float, clamped with saturate, masked by each pair's
    partition size, and screened (tiled and reduced) by exact_tile_screen."""
    prefix_pad = min(max(1, int(index.max_part_size * KEEP)), index.part_pad)
    parts, tables, qtables, tiles = ivf._quantized_tables(index, queries, R, ma, KEEP,
                                                          prefix_pad, kernels)
    qa, m, c = queries.shape[0] * ma, index.pq.sq_count, index.codes.shape[1]
    routed, pairs, group_sizes = ivf._route(index, parts, G)
    vals = kernels.grouped_scan(index.codes, qtables.reshape(qa, m, 16), routed.group_part,
                                pairs, group_sizes)
    cv = vals.to(torch.float32)
    if saturate:
        cv = torch.clamp(cv, max=127.0)
    sz = index.part_sizes[parts.reshape(qa).long()]
    cv = torch.where(ivf._window_valid_mask(sz, c, index.cpr), cv, torch.inf)
    screen_v, sel_pair, sel_part, sel_wi, sel_sz = ivf._screen(cv, parts, sz, min(R, ma * c))
    tw_src = tables if rerank else qtables.to(torch.float32)
    return ivf.window_rerank(index.codes, index.labels, tw_src, screen_v, sel_part, sel_pair,
                             sel_wi, sel_sz, R, kernels, tiles=tiles if rerank else None,
                             clamp127=saturate and not rerank)


def search(index, queries, ma, rerank, saturate, kernels=lut_scan.DISPATCH):
    """The grouped search (direct=False: on a card a small probed volume
    would take the direct path)."""
    return ivf.search_qadc(index, queries, r=R, ma=ma, keep=KEEP, rerank=rerank,
                           saturate=saturate, direct=False, grouped=True, group_size=G,
                           kernels=kernels)


def narrow(index) -> int:
    return 1024 // index.codes.shape[1]


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("wide", [True, False])
@pytest.mark.parametrize("rerank,saturate", [(True, False), (True, True), (False, False),
                                             (False, True)])
def test_grouped_search_equals_the_route_it_replaced(m, wide, rerank, saturate):
    index, queries = sized_index(m)
    c = index.codes.shape[1]
    ma = WIDE if wide else narrow(index)
    assert tiles_shrink(ma * c, R) == wide
    with recording() as rec:
        got = search(index, queries, ma, rerank, saturate)
    want = old_route(index, queries, ma, rerank, saturate)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.isinf(got[0]).sum() < got[0].numel()          # real candidates came through
    took = [c.value for c in rec.counts if c.name == "screen.scan_tiles"]
    assert took == ([queries.shape[0] * ma * c // lut_scan.TILE] if wide else [])


def test_scan_tiles_counts_the_tile_minima_taken():
    """screen.scan_tiles is Q * ma * C / 32 in a grouped search that tiles
    (tiles of 32 rows), Q * ma * part_pad / 32 in a direct one (tiles of 32
    codes)."""
    index, queries = sized_index(16)
    q = queries.shape[0]
    for direct, width in ((False, index.codes.shape[1]), (True, index.part_pad)):
        with recording() as rec:
            ivf.search_qadc(index, queries, r=R, ma=WIDE, keep=KEEP, direct=direct)
        got = [c.value for c in rec.counts if c.name == "screen.scan_tiles"]
        assert got == [q * WIDE * width // lut_scan.TILE], direct


def test_tile_screen_reads_int_rows_at_the_winning_tiles_only():
    """With mins and a cast, exact_tile_screen over int32 rows equals the
    screen of the cast rows that reduces the minima itself, ties included."""
    rng = np.random.default_rng(3)
    rows = torch.from_numpy(rng.integers(0, 60, (5, 64 * 40)).astype(np.int32))
    rows[:, 32 * 7:32 * 9] = lut_scan.TRIM_SENTINEL            # two tiles with no real row
    rows[0, 5::97] = lut_scan.TRIM_SENTINEL

    def cast(x):
        return ivf._screened(x, False)

    k = 24
    assert tiles_shrink(rows.shape[1], k)
    dense = cast(rows)
    mins = dense.reshape(5, -1, 32).amin(-1)
    got = exact_tile_screen(rows, k, mins=mins, cast=cast)
    want = exact_tile_screen(dense, k)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_screened_clamps_and_masks_rows_and_tiles():
    x = torch.tensor([0, 126, 127, 128, 4064, lut_scan.TRIM_SENTINEL], dtype=torch.int32)
    inf = float("inf")
    assert ivf._screened(x, False).tolist() == [0, 126, 127, 128, 4064, inf]
    assert ivf._screened(x, True).tolist() == [0, 126, 127, 127, 127, inf]
    t = torch.tensor([3.0, 200.0, inf])
    assert ivf._screened(t, True).tolist() == [3.0, 127.0, inf]


@pytest.mark.parametrize("m", [16, 32])
@pytest.mark.parametrize("saturate", [False, True])
def test_grouped_search_on_the_card_equals_its_plain_twin(cuda, m, saturate):
    """The search with M1's tile minima on the card equals the same search
    with the plain versions of its kernels, and the route it replaced with
    the kernels, on the card."""
    index, queries = sized_index(m, cuda)
    for ma in (WIDE, narrow(index)):
        got = search(index, queries, ma, True, saturate)
        for want in (search(index, queries, ma, True, saturate, kernels=lut_scan.PLAIN),
                     old_route(index, queries, ma, True, saturate, kernels=lut_scan.DISPATCH)):
            assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), ma
