"""The 8-bit conventional-ADC search's spans and counter
(qadc_tpu_torch/index/ivf.py:_search_adc8_grouped_impl, kernels/lut_scan.py:
grouped_scan8), on the CPU.

In a recording, `ivf.search_adc` over an IVF index of 8x8 codes records a
`search` span (path `ivf.adc8`) whose children are the front's spans,
`route`, `scan`, `screen` and `rerank` (the window expansion, the code
gather, the float gathers and the final top r), and counts `route.groups`
and `scan.rows`: the real storage rows of the groups with a live slot
(the rows whose codes kernel 5 loads, each counted once), grouped_scan_rows
summed, which is ceil(size / cpr) of each probed list when every list is
one group. With no recording open, grouped_scan8 counts nothing and does
not compute the count. The answers are the same with the recording on and
off, and follow the benchmark's plain reference (portbench/reference/
search.py:search_adc8). The 4-bit grouped ADC path (float tables) records
the same spans and no `scan.rows`, as before. Indexes: IVF-8, PQ 8x8 and
16x4 over 4,000 x 32 vectors (numpy seed 24), trained by the port.

    python -m pytest tests/test_torch_adc8_spans.py
"""

import numpy as np
import pytest
import torch

from portbench.reference import search as reference
from qadc_tpu_torch.eval.trace import recording
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.kernels import lut_scan
from qadc_tpu_torch.quantizers.pq import train_pq

torch.set_num_threads(1)

R, MA, Q = 20, 3, 8
FRONT = {"front.assign", "front.rotate", "front.tables"}
TAIL = {"route", "scan", "screen", "rerank"}


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(24)
    base = rng.normal(size=(4000, 32)).astype(np.float32)
    queries = torch.from_numpy(base[:Q] + 0.05 * rng.normal(size=(Q, 32)).astype(np.float32))
    coarse = ivf.train_coarse(1, base, 8, iters=4, device="cpu")
    out = {}
    for bits, m in ((8, 8), (4, 16)):
        pq = train_pq(0, base, m, bits, iters=3, device="cpu")
        out[bits] = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
    return out, queries


def _state(index) -> reference.State:
    cb = index.pq.code_size
    return reference.State(coarse=index.coarse_centroids, rotation=torch.eye(index.pq.dim),
                           codebooks=index.pq.centroids,
                           codes=index.codes.reshape(index.codes.shape[0], -1, cb),
                           labels=index.labels.to(torch.int64),
                           sizes=index.part_sizes.to(torch.int64))


def test_the_8bit_search_records_its_spans_and_counters(built):
    index, queries = built[0][8], built[1]
    assert (index.pq.sq_count, index.pq.sq_bits) == (8, 8) and index.part_pad % 512 == 0
    with recording() as rec:
        ivf.search_adc(index, queries, r=R, ma=MA)
    (search,) = [s for s in rec.spans if s.name == "search"]
    assert search.attrs == {"path": "ivf.adc8"}
    children = {s.name for s in rec.spans if s.parent == search.id}
    assert children == FRONT | TAIL
    assert {s.name for s in rec.spans} == {"search"} | FRONT | TAIL
    assert all(s.batch == search.batch for s in rec.spans)
    (rerank,) = [s for s in rec.spans if s.name == "rerank"]
    (screen,) = [s for s in rec.spans if s.name == "screen"]
    assert screen.end_ns <= rerank.start_ns <= rerank.end_ns <= search.end_ns

    # scan.rows: grouped_scan_rows summed over the routed groups, and by
    # hand ceil(size / cpr) of each probed list (one group each here).
    parts, _ = ivf.assign_queries(index, queries, MA)
    routed = ivf.route_queries(parts, index.part_count, 128)
    sizes = ivf._group_sizes(index, routed)
    rows = lut_scan.grouped_scan_rows(routed.slot_pairs(), sizes, index.codes.shape[1],
                                      128 // 8)
    probed = torch.unique(parts.long())
    by_hand = int(((index.part_sizes[probed] + index.cpr - 1) // index.cpr).sum())
    got = {c.name: c.value for c in rec.counts}
    assert [c.name for c in rec.counts] == ["route.groups", "scan.rows"]
    assert got == {"route.groups": probed.numel(), "scan.rows": int(rows.sum())}
    assert got["scan.rows"] == by_hand
    assert all(c.batch == search.batch for c in rec.counts)


def test_no_recording_counts_nothing(built, monkeypatch):
    index, queries = built[0][8], built[1]

    def no_count(*args):
        raise AssertionError("grouped_scan8 computed its count with no recording open")

    monkeypatch.setattr(lut_scan, "grouped_scan_rows", no_count)
    ivf.search_adc(index, queries, r=R, ma=MA)
    with recording() as rec:
        pass
    assert rec.counts == [] and rec.spans == []


def test_the_answers_are_unchanged_and_follow_the_reference(built):
    """Bit for bit the same with the recording on and off; against
    reference.search_adc8: labels equal but where the screen's cut is tied,
    distances within 1e-6 relative (float32 sums in the same order)."""
    index, queries = built[0][8], built[1]
    d_off, l_off = ivf.search_adc(index, queries, r=R, ma=MA)
    with recording():
        d_on, l_on = ivf.search_adc(index, queries, r=R, ma=MA)
    assert torch.equal(d_on, d_off) and torch.equal(l_on, l_off)
    with reference.precision():
        want = reference.search_adc8(_state(index), queries, R, MA)
    assert torch.isfinite(want.dists).all()
    torch.testing.assert_close(d_on, want.dists, rtol=1e-6, atol=0.0)
    differ = (l_on.to(torch.int64) != want.labels).any(-1)
    tied = (want.code_class == reference.TIED).flatten(1).any(-1)
    assert not (differ & ~tied).any()


def test_the_4bit_adc_path_records_no_scan_rows(built):
    """M1 with float tables (adc4) counts no `scan.rows`, as before."""
    index, queries = built[0][4], built[1]
    with recording() as rec:
        ivf.search_adc(index, queries, r=R, ma=MA)
    assert {s.name for s in rec.spans} == {"search"} | FRONT | TAIL
    assert [c.name for c in rec.counts] == ["route.groups"]
    assert {s.attrs.get("path") for s in rec.spans if s.name == "search"} == {"ivf.adc4"}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernel 5 runs only there")
    return torch.device("cuda", 0)


def test_kernel_5_counts_the_same_rows_on_the_card(cuda, built):
    """On the card grouped_scan8 launches kernel 5 and counts as `scan.rows`
    (a device tensor read when the recording closes) the real rows of the
    groups with a live slot, counted by hand from the routing; its minima
    equal the plain version's."""
    from qadc_tpu_torch.ops.tables import adc_tables

    index, queries = built[0][8], built[1]
    parts, rot = ivf.assign_queries(index, queries, MA)
    tables = adc_tables(rot, index.pq.centroids).reshape(Q * MA, 8, 256).to(torch.bfloat16)
    routed, pairs, sizes = ivf._route(index, parts, 128)
    args = (index.codes, tables, routed.group_part, pairs, sizes)
    rpp, cpr = index.codes.shape[1], 128 // 8
    by_hand = sum(min(-(-size // cpr), rpp)
                  for live, size in zip(pairs.tolist(), sizes.tolist()) if max(live) >= 0)
    want, _ = lut_scan.grouped_scan8(*args)
    with recording() as card:
        got, _ = lut_scan.grouped_scan8(*[a.to(cuda) for a in args])
        torch.cuda.synchronize()
    assert [(c.name, c.value) for c in card.counts] == [("scan.rows", by_hand)]
    assert by_hand > 0
    assert torch.equal(got.cpu(), want)
