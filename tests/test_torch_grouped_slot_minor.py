"""The slot-minor grouped scans' walk (csrc/grouped_scan_sm.cu,
grouped_scan8_sm.cu) in PyTorch, held to the plain versions on the CPU.

grouped_scan_slot_minor_plain and grouped_scan8_slot_minor_plain run the
kernels' own walk: a group's slots taken in windows of 4, each window's live
slots gathered in slot order and their tables staged slot-minor, a thread's
lookup of an entry's 4 slots at once and its running minima with a strict <.
They must equal grouped_scan_plain / grouped_scan8_plain with torch.equal
(minima and argmin ids): the sums run in the same order, so no tolerance.
Tables are small integers held in float32 / bf16, so equal sums (ties) are
common.

The routed groups with chosen live-slot counts (groups_with_live_counts,
scatter_slots) serve the card tests of tests/test_torch_cuda_kernels.py too.
"""

import numpy as np
import pytest
import torch

from qadc_tpu_torch.index.routing import route_queries
from qadc_tpu_torch.kernels import lut_scan, scan_lab

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

# Live-slot counts of a group the tests cover: 1 to 3 as at IVF-256, ma=24,
# b=32; 12 as at b=128; the edges of a 4-slot width and of a 32-slot pass;
# a whole group of 128 (a hot partition).
LIVE_COUNTS = (1, 3, 4, 5, 12, 31, 32, 33, 128)


def groups_with_live_counts(counts, rpp: int, cpr: int, seed: int, group_size: int = 128):
    """(group_part, slot_pair, group_sizes, qa): route_queries over pairs of
    which partition j takes counts[j], shuffled. A count above group_size
    fills several groups; the groups past n_groups stay unused. Partition
    sizes cycle through a size short of a whole row, an empty partition, a
    full one and a few codes."""
    rng = np.random.default_rng(seed)
    parts = len(counts)
    pids = np.repeat(np.arange(parts, dtype=np.int32), counts)
    rng.shuffle(pids)
    routed = route_queries(torch.from_numpy(pids.reshape(-1, 1)), parts, group_size)
    cycle = [rpp * cpr - 5, 0, rpp * cpr, 17, cpr + 1]
    sizes = torch.tensor([cycle[j % len(cycle)] for j in range(parts)], dtype=torch.int32)
    g_sz = torch.where(routed.group_valid, sizes[routed.group_part.long()], 0).to(torch.int32)
    return routed.group_part, routed.slot_pairs(), g_sz, pids.size


def scatter_slots(slot_pair: torch.Tensor, seed: int) -> torch.Tensor:
    """The same groups with each group's slots in another order: live slots
    spread over the row, as no routing lays them out."""
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([row[torch.randperm(row.numel(), generator=gen)] for row in slot_pair])


RPP = 12  # storage rows a partition: small keeps the walks quick

# Each live count alone, and all of them in one batch.
CASES = [(n,) for n in LIVE_COUNTS] + [LIVE_COUNTS]
CASE_IDS = [f"live{c[0]}" for c in CASES[:-1]] + ["mixed"]


def _codes(seed, parts):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(0, 256, (parts, RPP, 128), dtype=np.uint8))


def _int_tables(seed, qa, m, k, dtype):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.integers(0, 4, (qa, m, k)).astype(np.float32)).to(dtype)


@pytest.mark.parametrize("counts", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("m", [16, 32])          # 16x4 and 32x4 PQ
def test_m1_slot_minor_walk_equals_plain(counts, m):
    cpr = 128 // (m // 2)
    *groups, qa = groups_with_live_counts(counts, RPP, cpr, seed=m)
    args = [_codes(m, len(counts)), _int_tables(m + 1, qa, m, 16, torch.float32), *groups]
    want = lut_scan.grouped_scan_plain(*args)
    got = lut_scan.grouped_scan_slot_minor_plain(*args)
    assert torch.equal(got, want)
    assert torch.isfinite(want).any()


@pytest.mark.parametrize("counts", CASES, ids=CASE_IDS)
@pytest.mark.parametrize("m", [4, 8, 16])
def test_scan8_slot_minor_walk_equals_plain(counts, m):
    *groups, qa = groups_with_live_counts(counts, RPP, 128 // m, seed=100 + m)
    args = [_codes(100 + m, len(counts)), _int_tables(m, qa, m, 256, torch.bfloat16), *groups]
    want = lut_scan.grouped_scan8_plain(*args)
    got = lut_scan.grouped_scan8_slot_minor_plain(*args)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert (want[1] >= 0).any()


@pytest.mark.parametrize("m", [4, 8, 16])
def test_scan8_ties_go_to_the_lower_code(m):
    """Every table entry equal: every code of a window ties, so the argmin is
    the window's first real code, c0 of its row."""
    *groups, qa = groups_with_live_counts((5, 33), RPP, 128 // m, seed=3)
    args = [_codes(3, 2), torch.ones((qa, m, 256), dtype=torch.bfloat16), *groups]
    mins, idx = lut_scan.grouped_scan8_slot_minor_plain(*args)
    want = lut_scan.grouped_scan8_plain(*args)
    assert torch.equal(mins, want[0]) and torch.equal(idx, want[1])
    cpr = 128 // m
    cs = lut_scan.scan8_windows(m)[1]
    win = torch.arange(RPP * cs)
    first = (win // cs) * cpr + win % cs
    live = idx >= 0
    assert live.any()
    assert torch.equal(idx[live], first.expand_as(idx)[live].to(torch.int32))


@pytest.mark.parametrize("m", [16, 32])
def test_m1_slot_minor_walk_with_unused_and_small_groups(m):
    """group_size 4: a partition's pairs span several groups, and the
    capacity leaves groups past n_groups, whose size is 0."""
    cpr = 128 // (m // 2)
    *groups, qa = groups_with_live_counts((1, 9, 4), RPP, cpr, seed=7, group_size=4)
    group_part, slot_pair, sizes = groups
    assert (slot_pair[:, 0] < 0).any()          # unused groups
    args = [_codes(7, 3), _int_tables(8, qa, m, 16, torch.float32), *groups]
    assert torch.equal(lut_scan.grouped_scan_slot_minor_plain(*args),
                       lut_scan.grouped_scan_plain(*args))


@pytest.mark.parametrize("m", [16, 32])
def test_walks_take_live_slots_anywhere(m):
    """The kernels' contract holds for any placement of the live slots."""
    cpr = 128 // (m // 2)
    group_part, slot_pair, sizes, qa = groups_with_live_counts((3, 33, 128), RPP, cpr, seed=9)
    spread = scatter_slots(slot_pair, 9)
    assert not torch.equal(spread, slot_pair)
    args = [_codes(9, 3), _int_tables(9, qa, m, 16, torch.float32), group_part, spread, sizes]
    assert torch.equal(lut_scan.grouped_scan_slot_minor_plain(*args),
                       lut_scan.grouped_scan_plain(*args))
    mm = m // 4                                       # 4 and 8 sub-quantizers of 8 bits
    args[1] = _int_tables(10, qa, mm, 256, torch.bfloat16)
    got, want = (lut_scan.grouped_scan8_slot_minor_plain(*args),
                 lut_scan.grouped_scan8_plain(*args))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("counts", CASES, ids=CASE_IDS)
def test_routing_fills_slots_as_a_prefix(counts):
    """The kernels take live slots wherever they lie; routing puts them
    first, so a group's live slots fill its first slot windows."""
    _, slot_pair, _, qa = groups_with_live_counts(counts, RPP, 16, seed=1)
    live = slot_pair >= 0
    n = live.sum(1, keepdim=True)
    assert torch.equal(live, torch.arange(slot_pair.shape[1])[None, :] < n)
    assert int(n.sum()) == qa and sorted(n[n > 0].tolist()) == sorted(
        [c for c in counts for c in [128] * (c // 128) + [c % 128] if c])


@pytest.mark.parametrize("live", [0, 1, 3, 4, 5, 33, 128])
@pytest.mark.parametrize("prefix", [True, False])
def test_slot_windows_cut_the_slots(live, prefix):
    """Windows of 4 slots in slot order, live ones only; the live slots a
    prefix (as routed) or spread over the row."""
    row = torch.full((128,), -1, dtype=torch.int32)
    gen = torch.Generator().manual_seed(live)
    at = torch.arange(live) if prefix else torch.randperm(128, generator=gen)[:live].sort().values
    row[at] = torch.arange(100, 100 + live, dtype=torch.int32)
    windows = lut_scan.slot_windows(row)
    assert lut_scan.GROUPED_WINDOW_SLOTS == 4
    assert sum(p.numel() for p in windows) == live
    if live:
        assert torch.equal(torch.cat(windows), row[row >= 0].long())
    if prefix:
        assert len(windows) == -(-live // 4)
    assert all(1 <= p.numel() <= 4 for p in windows)


@pytest.mark.parametrize("n", [1, 3, 4])
def test_to_slot_minor_layout(n):
    t = torch.arange(n * 2 * 5, dtype=torch.float32).reshape(n, 2, 5)
    sm = lut_scan.to_slot_minor(t)
    assert sm.shape == (10, 4)
    for s in range(n):
        assert torch.equal(sm[:, s], t[s].reshape(-1))
    assert (sm[:, n:] == 0).all()


@pytest.mark.parametrize("mode", list(scan_lab.GROUPED_LAB_MODES))
def test_grouped_lab_modes_on_the_cpu(mode):
    """copy has a plain version (the sentinels) and quad the scan's; the
    other modes exist to be timed on the card and raise here. Wrong tables
    raise for every mode."""
    scan, number, _ = scan_lab.GROUPED_LAB_MODES[mode]
    *groups, qa = groups_with_live_counts((3,), RPP, 16, seed=2)
    codes = _codes(2, 1)
    tables = (torch.zeros((qa, 16, 16)) if scan == "f32"
              else torch.zeros((qa, 8, 256), dtype=torch.bfloat16))
    if number == 4:
        assert torch.equal(scan_lab.grouped_lab(codes, tables, *groups, mode),
                           lut_scan.grouped_scan_plain(codes, tables, *groups))
    elif number == 1:
        out = scan_lab.grouped_lab(codes, tables, *groups, mode)
        mins = out if scan == "f32" else out[0]
        assert torch.isinf(mins).all()
        assert scan == "f32" or (out[1] == -1).all()
    else:
        with pytest.raises(RuntimeError):
            scan_lab.grouped_lab(codes, tables, *groups, mode)
    with pytest.raises((TypeError, ValueError)):
        scan_lab.grouped_lab(codes, torch.zeros((qa, 32, 16)), *groups, mode)


def test_search_adc_through_the_slot_minor_walks_equals_plain():
    """search_adc at 4 and 8 bits with the walks as its grouped kernels
    returns the plain search's result exactly, at G = 128 with every query
    probing every partition: 40 live slots a group, more than one slot window."""
    from qadc_tpu_torch.convert import ivf_index_from_arrays
    from qadc_tpu_torch.eval.synth import bench_ivf8_arrays, bench_ivf_arrays
    from qadc_tpu_torch.index import ivf

    rng = np.random.default_rng(0)
    walks = lut_scan.PLAIN._replace(grouped_scan=lut_scan.grouped_scan_slot_minor_plain,
                                    grouped_scan8=lut_scan.grouped_scan8_slot_minor_plain)
    for make in (bench_ivf_arrays, bench_ivf8_arrays):
        index = ivf_index_from_arrays(*make(rng, parts=8), "cpu")
        queries = torch.from_numpy(rng.normal(size=(40, 128)).astype(np.float32))
        parts, _ = ivf.assign_queries(index, queries, 8)
        routed = route_queries(parts, index.part_count, 128)
        assert int((routed.slot_pairs() >= 0).sum(1).max()) > 32
        got = ivf.search_adc(index, queries, r=20, ma=8, kernels=walks)
        want = ivf.search_adc(index, queries, r=20, ma=8, kernels=lut_scan.PLAIN)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
