"""Kernel M2's tile and run bookkeeping (csrc/rows_adc.cu:rows_adc_kernel),
modelled in PyTorch where no card is.

The staged kernel takes ROWS_ADC_TILE entries a block, finds the runs of
equal pair ids in each tile with one ballot, stages each run's two tables
once into a slot of shared memory (rows_adc_layout) and looks each code up
in its run's slot. lut_scan.rows_adc_staged_plain walks the same indices;
here it is held to rows_adc_plain bit for bit at the id lists the kernel
must take (ID_LISTS; the card tests and test_torch_rows_adc.py use them
too), and the layout's bank arithmetic is checked lane by lane: a warp's
lookups at one byte position (CB = 8) and its staging stores (CB = 8 and 16)
meet no bank conflict. Tolerance: exact (one sum order).
"""

import numpy as np
import pytest
import torch

from qadc_tpu_torch.kernels import lut_scan

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

R_ROWS, PAIRS = 97, 40
TILE = lut_scan.ROWS_ADC_TILE


def _runs(a, length, offset):
    """Pair ids in runs of `length`, the first cut short by `offset`, so tile
    boundaries cut runs."""
    return ((np.arange(a) + offset) // length % PAIRS).astype(np.int32)


# name -> (row ids, pair ids) for A entries, from a generator.
ID_LISTS = {
    "one_pair": lambda g, a: (g.integers(0, R_ROWS, a), np.full(a, 7)),
    "runs_2": lambda g, a: (g.integers(0, R_ROWS, a), _runs(a, 2, offset=1)),
    "runs_625": lambda g, a: (np.arange(a) % R_ROWS, _runs(a, 625, offset=13)),
    "distinct": lambda g, a: (g.integers(0, R_ROWS, a), np.arange(a) % PAIRS),
    "descending": lambda g, a: (g.integers(0, R_ROWS, a), np.sort(g.integers(0, PAIRS, a))[::-1]),
    "random": lambda g, a: (g.integers(0, R_ROWS, a), g.integers(0, PAIRS, a)),
    "repeated_rows": lambda g, a: (np.full(a, 5), g.integers(0, 3, a)),
}
# Entry counts of each list: a partial tile, several tiles, one entry, none.
ID_COUNTS = {"one_pair": (33, 700), "runs_2": (63, 301), "runs_625": (1875,),
             "distinct": (40, 97), "descending": (200,), "random": (1, 0, 129),
             "repeated_rows": (65,)}
ID_CASES = [(name, a) for name, counts in ID_COUNTS.items() for a in counts]


def id_list_inputs(name: str, a: int, cb: int, seed: int = 0):
    """(codes (R_ROWS, 128) uint8, row_ids, pair_ids (A,) int32, tlo, thi
    (PAIRS, 16*cb) float32) as CPU tensors, made with numpy from a seed."""
    g = np.random.default_rng([seed, cb, a, len(name)])
    codes = g.integers(0, 256, (R_ROWS, 128), dtype=np.uint8)
    rows, pairs = ID_LISTS[name](g, a)
    tlo = g.uniform(0, 30, (PAIRS, 16 * cb)).astype(np.float32)
    thi = g.uniform(0, 30, (PAIRS, 16 * cb)).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in
            (codes, rows.astype(np.int32), pairs.astype(np.int32), tlo, thi)]


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("name,a", ID_CASES)
def test_staged_walk_equals_plain(name, a, cb):
    args = id_list_inputs(name, a, cb)
    got = lut_scan.rows_adc_staged_plain(*args)
    want = lut_scan.rows_adc_plain(*args)
    assert got.shape == (a, 128 // cb) and got.dtype == torch.float32
    assert torch.equal(got, want)


def _python_runs(pairs):
    """The ballot of the kernel, lane by lane in Python: per tile, the bit
    mask of run starts and each live entry's slot (popc of the mask up to
    and including it, less one)."""
    starts, slots = [], []
    for t0 in range(0, len(pairs), TILE):
        tile = pairs[t0:t0 + TILE]
        mask = sum(1 << e for e in range(len(tile)) if e == 0 or tile[e] != tile[e - 1])
        starts.append(mask)
        slots.append([bin(mask & ((2 << e) - 1)).count("1") - 1 for e in range(len(tile))])
    return starts, slots


@pytest.mark.parametrize("name,a", [c for c in ID_CASES if c[1]])
def test_runs_match_the_ballot(name, a):
    pairs = id_list_inputs(name, a, 8)[2]
    starts, slot = lut_scan.rows_adc_runs(pairs)
    want_masks, want_slots = _python_runs(pairs.tolist())
    got_masks = [sum(1 << e for e in range(TILE) if row[e]) for row in starts.tolist()]
    assert got_masks == want_masks
    for row, want in zip(slot.tolist(), want_slots):
        assert row[:len(want)] == want and all(s == -1 for s in row[len(want):])
    # A run cut by a tile boundary starts again in the next tile; a tile
    # stages one slot a run.
    assert bool(starts[:, 0].all())
    runs = starts.sum(1)
    assert int(runs.max()) <= TILE and torch.equal(slot.amax(1) + 1, runs)


def _banks(words):
    """Wavefronts of one warp-wide 4-byte shared-memory access: the most
    distinct words that fall in one bank (equal words are one broadcast)."""
    by_bank = {}
    for w in words:
        by_bank.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in by_bank.values())


@pytest.mark.parametrize("name,a", [c for c in ID_CASES if c[1]])
def test_lookups_are_one_wavefront_at_cb8(name, a):
    """At CB = 8 a warp holds two rows (two half-warps of 16 codes); their
    slots are equal or consecutive, and a slot is 16 (mod 32) words, so each
    lookup of one byte position is one wavefront whatever the nibbles."""
    cb, cpr = 8, 16
    hi_off, slot_words = lut_scan.rows_adc_layout(cb)
    assert slot_words % 32 == 16
    _, slot = lut_scan.rows_adc_runs(id_list_inputs(name, a, cb)[2])
    g = np.random.default_rng(a)
    for tile in slot.tolist():
        for w0 in range(0, TILE, 32 // cpr):                  # the rows of one warp
            rows = [s for s in tile[w0:w0 + 32 // cpr] if s >= 0]
            for b in range(cb):
                for off in (0, hi_off):
                    nib = g.integers(0, 16, (len(rows), cpr))  # any nibbles
                    words = [s * slot_words + off + lut_scan.rows_adc_word(b, int(n))
                             for s, ns in zip(rows, nib) for n in ns]
                    assert _banks(words) == 1 if words else True


@pytest.mark.parametrize("cb", [8, 16])
def test_staged_layout_and_stores(cb):
    """rows_adc_word places each (b, j) once, a byte position's 16 centroids
    in 16 consecutive words; a staging store (lane l holds float4 32h + l of
    a table: centroid j = 4f / cb, byte positions 4f % cb .. + 3) meets no
    bank conflict."""
    hi_off, slot_words = lut_scan.rows_adc_layout(cb)
    words = {lut_scan.rows_adc_word(b, j) for b in range(cb) for j in range(16)}
    assert words == set(range(16 * cb)) and hi_off + 16 * cb + 16 == slot_words
    for b in range(cb):
        assert sorted(lut_scan.rows_adc_word(b, j) for j in range(16)) == list(
            range(lut_scan.rows_adc_word(b, 0) & ~15, (lut_scan.rows_adc_word(b, 0) & ~15) + 16))
    for slot in range(TILE):
        for off in (0, hi_off):
            for h in range(cb // 8):
                for k in range(4):
                    f = [32 * h + lane for lane in range(32)]
                    store = [slot * slot_words + off + lut_scan.rows_adc_word(4 * x % cb + k, 4 * x // cb)
                             for x in f]
                    assert _banks(store) == 1
