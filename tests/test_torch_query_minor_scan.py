"""The query-minor flat scans (csrc/flat_scan_qm.cuh, flat_scan8_qm.cuh) on
the CPU: their walk in PyTorch against the plain versions that are the
contract, their layout and chunk helpers, and the CPU side of their lab.

  flat_scan_query_minor_plain vs flat_scan_plain (float32 tables) and
    flat_scan8_query_minor_plain vs flat_scan8_plain: minima and argmin ids
    with torch.equal (the same float32 additions in the same order, so bit
    for bit), at 16x4 and 32x4 PQ and m = 4, 8, 16, 32 code bytes, batches on
    both sides of a warp and of a chunk, n not a multiple of cpr with a tail
    of empty rows, n = 0, and tables of small integers that tie.
  to_query_minor / from_query_minor: the identity at every chunk the
    launchers can pick; every pick fits the 227 KB a block may take.
The kernels themselves run only on a card (tests/test_torch_cuda_kernels.py);
the JAX kernels hold the same plain versions in tests/test_torch_flat_kernels.py.
"""

import numpy as np
import pytest
import torch

from qadc_tpu_torch.kernels import lut_scan, scan_lab

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

BATCHES = [1, 31, 32, 33, 128]


def _tables(g, shape, ties: bool) -> torch.Tensor:
    if ties:  # small integer-valued floats: many equal sums inside a row or window
        return torch.from_numpy(g.integers(0, 3, shape).astype(np.float32))
    return torch.from_numpy(g.random(shape).astype(np.float32))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("q", BATCHES)
@pytest.mark.parametrize("m", [16, 32])
def test_flat_scan_query_minor_plain_equals_plain(m, q, ties):
    g = np.random.default_rng(10 * m + q)
    cpr = 256 // m
    r_count = 45
    codes = torch.from_numpy(g.integers(0, 256, (r_count, 128), dtype=np.uint8))
    tables = _tables(g, (q, m, 16), ties)
    n = r_count * cpr - 4 * cpr - 3                # a partly real row, then empty rows
    want_v, want_i = lut_scan.flat_scan_plain(codes, tables, n, True)
    got_v, got_i = lut_scan.flat_scan_query_minor_plain(codes, tables, n, True)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert torch.isinf(got_v[:, -4:]).all() and (got_i[:, -4:] == -1).all()
    mins_only, none = lut_scan.flat_scan_query_minor_plain(codes, tables, n)
    assert none is None and torch.equal(mins_only, want_v)


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("q", BATCHES)
@pytest.mark.parametrize("m", [4, 8, 16, 32])
def test_flat_scan8_query_minor_plain_equals_plain(m, q, ties):
    g = np.random.default_rng(20 * m + q)
    n_pad = 256 * 3
    codes = torch.from_numpy(g.integers(0, 256, (n_pad * m // 128, 128), dtype=np.uint8))
    tables = _tables(g, (q, m, 256), ties).to(torch.bfloat16)
    n = n_pad - 256 - 37                           # a partly real block, then an empty one
    want_v, want_i = lut_scan.flat_scan8_plain(codes, tables, n)
    got_v, got_i = lut_scan.flat_scan8_query_minor_plain(codes, tables, n)
    assert torch.equal(got_v, want_v) and torch.equal(got_i, want_i)
    assert torch.isinf(got_v[:, -16:]).all() and (got_i[:, -16:] == -1).all()
    assert ((got_i < n) & (got_i >= -1)).all()


@pytest.mark.parametrize("scan,tables", [
    (lut_scan.flat_scan_query_minor_plain, torch.ones((3, 16, 16))),
    (lut_scan.flat_scan8_query_minor_plain, torch.ones((3, 8, 256), dtype=torch.bfloat16)),
], ids=["f32", "u8"])
def test_query_minor_plain_with_no_real_code(scan, tables):
    codes = torch.zeros((32, 128), dtype=torch.uint8)
    out = scan(codes, tables, 0, True) if tables.dtype == torch.float32 else scan(codes, tables, 0)
    assert torch.isinf(out[0]).all() and (out[1] == -1).all()


@pytest.mark.parametrize("q", [1, 7, 8, 9, 31, 32, 33, 64, 65, 128, 300])
@pytest.mark.parametrize("kind,m", [("f32", 16), ("f32", 32), ("u8", 4), ("u8", 8), ("u8", 16),
                                    ("u8", 32)])
def test_query_minor_layout_round_trip_and_fit(kind, m, q):
    """[q][m][k] -> query-minor -> back is the identity at the chunk the
    launcher picks, and that chunk's shared memory fits a block."""
    g = np.random.default_rng(q + m)
    if kind == "f32":
        chunk = lut_scan.flat_scan_chunk(q, m)
        tables = torch.from_numpy(g.random((q, m, 16)).astype(np.float32))
        smem = lut_scan.flat_scan_smem_bytes(m, chunk, with_rows=True)
        assert chunk in (32, 64, 128) and chunk * m * 64 <= lut_scan.QUERY_MINOR_TABLE_BYTES
    else:
        chunk = lut_scan.flat_scan8_chunk(q, m)
        tables = torch.from_numpy(g.random((q, m, 256)).astype(np.float32)).to(torch.bfloat16)
        smem = lut_scan.flat_scan8_smem_bytes(m, chunk)
        assert chunk in (8, 16, 32, 64) and chunk * m * 512 <= lut_scan.QUERY_MINOR_TABLE_BYTES
    assert smem <= lut_scan.SMEM_BLOCK_BYTES
    assert chunk >= min(q, lut_scan.QUERY_MINOR_TABLE_BYTES // (tables[0].numel()
                                                              * tables.element_size()))
    qm = lut_scan.to_query_minor(tables, chunk)
    assert qm.shape == (-(-q // chunk), m, tables.shape[2], chunk) and qm.is_contiguous()
    assert torch.equal(qm[0, 1, 2, 0], tables[0, 1, 2])
    assert torch.equal(qm[-1, 1, 2, (q - 1) % chunk], tables[q - 1, 1, 2])
    assert (qm.permute(0, 3, 1, 2).reshape(-1, m, tables.shape[2])[q:] == 0).all()
    assert torch.equal(lut_scan.from_query_minor(qm, q), tables)


def test_query_minor_chunk_rejects_a_table_too_wide():
    with pytest.raises(ValueError):
        lut_scan.query_minor_chunk(4, 64 * 1024, 8)


def test_wrappers_and_arms_run_the_plain_versions_on_the_cpu():
    g = np.random.default_rng(3)
    codes = torch.from_numpy(g.integers(0, 256, (32, 128), dtype=np.uint8))
    t4 = torch.from_numpy(g.random((40, 16, 16)).astype(np.float32))
    t8 = torch.from_numpy(g.random((40, 8, 256)).astype(np.float32)).to(torch.bfloat16)
    before = dict(lut_scan.launches)
    want = lut_scan.flat_scan_plain(codes, t4, 500, True)
    for fn in (lut_scan.flat_scan, lut_scan.flat_scan_f32_lookup):
        got = fn(codes, t4, 500, True)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    want = lut_scan.flat_scan8_plain(codes, t8, 500)
    for fn in (lut_scan.flat_scan8, lut_scan.flat_scan8_lookup):
        got = fn(codes, t8, 500)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert lut_scan.launches == before            # no kernel was launched
    with pytest.raises(TypeError):                # the float arm takes float tables only
        lut_scan.flat_scan_f32_lookup(codes, torch.zeros((2, 16, 16), dtype=torch.int8), 500)


@pytest.mark.parametrize("mode", list(scan_lab.QM_LAB_MODES))
def test_query_minor_lab_modes_on_the_cpu(mode):
    """copy has a plain version (the sentinels); the other modes exist to be
    timed on the card and raise here. Wrong tables raise for every mode."""
    scan, number, _ = scan_lab.QM_LAB_MODES[mode]
    codes = torch.zeros((32, 128), dtype=torch.uint8)
    tables = (torch.zeros((3, 16, 16)) if scan == "f32"
              else torch.zeros((3, 8, 256), dtype=torch.bfloat16))
    if number == 1:
        out = scan_lab.query_minor_lab(codes, tables, 500, mode)
        mins = out if scan == "f32" else out[0]
        assert mins.shape == (3, 32) and torch.isinf(mins).all()
        assert scan == "f32" or (out[1] == -1).all()
    else:
        with pytest.raises(RuntimeError):
            scan_lab.query_minor_lab(codes, tables, 500, mode)
    with pytest.raises((TypeError, ValueError)):
        scan_lab.query_minor_lab(codes, torch.zeros((3, 32, 16)), 500, mode)


def test_query_minor_by_chunk_on_the_cpu_is_the_plain_version():
    g = np.random.default_rng(4)
    codes = torch.from_numpy(g.integers(0, 256, (32, 128), dtype=np.uint8))
    t4 = torch.from_numpy(g.random((5, 16, 16)).astype(np.float32))
    t8 = torch.from_numpy(g.random((5, 8, 256)).astype(np.float32)).to(torch.bfloat16)
    assert torch.equal(scan_lab.query_minor_by_chunk(codes, t4, 500, 64),
                       lut_scan.flat_scan_plain(codes, t4, 500)[0])
    got, want = scan_lab.query_minor_by_chunk(codes, t8, 500, 16), lut_scan.flat_scan8_plain(
        codes, t8, 500)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(RuntimeError):
        scan_lab.empty_kernel("cpu")
