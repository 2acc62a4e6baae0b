"""Code packing and row128 layout: qadc_tpu_torch.core vs qadc_tpu.core.

Tolerance: bit-exact (integer bit manipulation).
"""

import numpy as np
import pytest
import torch

from qadc_tpu.core import layout as jlayout
from qadc_tpu.core import packing as jpacking
from qadc_tpu_torch.core import layout, packing

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)


@pytest.mark.parametrize("m", [2, 16, 32])
def test_pack_codes_matches_reference(m):
    idx = np.random.default_rng(m).integers(0, 16, size=(50, m)).astype(np.int32)
    want = np.asarray(jpacking.pack_codes(idx, 4))
    got = packing.pack_codes(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)
    # Even sub-quantizer in the LOW nibble (reference quantizers.hpp:49-68).
    assert got[0, 0] == (idx[0, 0] | (idx[0, 1] << 4))


@pytest.mark.parametrize("cb", [1, 8, 16])
def test_unpack_codes_matches_reference(cb):
    packed = np.random.default_rng(cb).integers(0, 256, size=(7, 5, cb), dtype=np.uint8)
    want = np.asarray(jpacking.unpack_codes(packed, 2 * cb, 4))
    got = packing.unpack_codes(torch.from_numpy(packed))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(packing.pack_codes(got).numpy(), packed)


def test_pack_rejects_odd_sq_count():
    with pytest.raises(ValueError):
        packing.pack_codes(torch.zeros((3, 5), dtype=torch.int32))


@pytest.mark.parametrize("cb", [1, 4, 8, 16, 32, 128])
def test_codes_per_row_matches_reference(cb):
    assert layout.codes_per_row(cb) == jlayout.codes_per_row(cb)


def test_codes_per_row_rejects_non_divisor():
    with pytest.raises(ValueError):
        layout.codes_per_row(12)


def test_row128_views_match_reference():
    cb, n = 8, 64
    codes = np.random.default_rng(1).integers(0, 256, size=(3, n, cb), dtype=np.uint8)
    want = np.stack([jlayout.to_row128(c) for c in codes])
    rows = layout.row128_view(torch.from_numpy(codes), cb)
    np.testing.assert_array_equal(rows.numpy(), want)
    back = layout.code_view(rows, cb).numpy()
    np.testing.assert_array_equal(
        back, np.stack([jlayout.from_row128(r, cb) for r in want]))


@pytest.mark.parametrize("bits,m", [(8, 8), (8, 16), (16, 2), (16, 8)])
def test_wide_pack_round_trip_matches_reference(bits, m):
    idx = np.random.default_rng(bits + m).integers(0, 1 << bits, size=(4, 9, m)).astype(np.int32)
    want = np.asarray(jpacking.pack_codes(idx, bits))
    got = packing.pack_codes(torch.from_numpy(idx), bits)
    assert got.dtype == torch.uint8 and got.shape[-1] == m * bits // 8
    np.testing.assert_array_equal(got.numpy(), want)
    back = packing.unpack_codes(got, m, bits)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), np.asarray(jpacking.unpack_codes(want, m, bits)))
    np.testing.assert_array_equal(back.numpy(), idx)
    if bits == 16:  # little-endian uint16: [lo0, hi0, lo1, hi1, ...]
        assert got[0, 0, 0] == idx[0, 0, 0] & 0xFF and got[0, 0, 1] == idx[0, 0, 0] >> 8


def test_unpack_rejects_a_wrong_sq_count():
    with pytest.raises(ValueError):
        packing.unpack_codes(torch.zeros((2, 8), dtype=torch.uint8), 4, 8)


@pytest.mark.parametrize("code_size", [4, 8, 16])
def test_gather_codes_row128_matches_reference(code_size):
    g = np.random.default_rng(code_size)
    rows = g.integers(0, 256, size=(12, 128), dtype=np.uint8)
    ids = g.integers(0, 12 * 128 // code_size, size=(3, 7)).astype(np.int32)
    want = np.asarray(jpacking.gather_codes_row128(rows, ids, code_size))
    got = packing.gather_codes_row128(torch.from_numpy(rows), torch.from_numpy(ids), code_size)
    np.testing.assert_array_equal(got.numpy(), want)
