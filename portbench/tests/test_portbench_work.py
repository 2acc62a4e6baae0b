"""The roofline counts against a hand count at one small shape."""

from types import SimpleNamespace

import torch

from portbench import harness, peaks
from portbench.reference.search import State

PB = harness.ROOT / "portbench"


def _dep(coarse, sizes, code_bytes, pool, cfg):
    part_pad = 64
    state = State(coarse=coarse, rotation=torch.eye(coarse.shape[1] if coarse is not None else 4),
                  codebooks=torch.zeros(2 * code_bytes, 16, 1),
                  codes=torch.zeros(len(sizes), part_pad, code_bytes, dtype=torch.uint8),
                  labels=torch.zeros(len(sizes), part_pad, dtype=torch.int64),
                  sizes=torch.tensor(sizes))
    return SimpleNamespace(state=lambda: state, pool=pool, cfg=cfg)


def test_ivf_scan_count_by_hand():
    count = harness.load_module(PB / "work" / "scan_ivf" / "count.py", "w_ivf").count
    # Four partitions on a line; two queries probe the two nearest each.
    coarse = torch.tensor([[0.0, 0], [10, 0], [20, 0], [30, 0]])
    pool = torch.tensor([[1.0, 0], [29.0, 0]])
    dep = _dep(coarse, [40, 17, 33, 8], 8, pool, {"ma": 2})
    moved, ops = count(dep, [0, 1])
    # query 0 probes partitions 0, 1; query 1 probes 3, 2: all four, once.
    codes = (40 + 17 + 33 + 8) * 8
    tables = 4 * 16 * 16                      # 4 pairs x 16 sub-quantizers x 16 entries
    minima = (3 + 2 + 1 + 3) * 4              # ceil(size / 16) windows a pair, int32
    assert moved == codes + tables + minima
    assert ops == (40 + 17 + 8 + 33) * 16
    # One query alone reads only its own two partitions.
    moved1, ops1 = count(dep, [0])
    assert moved1 == (40 + 17) * 8 + 2 * 16 * 16 + (3 + 2) * 4 and ops1 == 57 * 16


def test_flat_scan_count_by_hand():
    count = harness.load_module(PB / "work" / "scan_flat" / "count.py", "w_flat").count
    dep = _dep(None, [1000], 16, None, {})
    moved, ops = count(dep, list(range(3)))
    assert moved == 1000 * 16 + 3 * 32 * 16 + 3 * 125 * 4   # 8 codes a window
    assert ops == 3 * 1000 * 32


def test_least_time_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == 1.0
    assert peaks.least_seconds(0, 1.979e15) == 1.0
    assert peaks.bound_of(3.35e12, 1) == "bytes"
    assert peaks.bound_of(1, 1.979e15) == "operations"
