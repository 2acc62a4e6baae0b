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
Every kernel wrapper of lut_scan on CPU tensors: its plain version, no launch,
and the table dtype it refuses (test_wrappers_run_the_plain_versions_on_the_cpu).
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


def _wrapper_case(name: str):
    """(wrapper, its arguments, its keyword arguments, the plain version,
    the index of the table argument, the table dtype the wrapper refuses or
    None where it takes both int8 and float32 tables) of one case of
    test_wrappers_run_the_plain_versions_on_the_cpu."""
    g = np.random.default_rng(5)
    i8 = lambda *shape: torch.from_numpy(g.integers(0, 128, shape).astype(np.int8))  # noqa: E731
    f32 = lambda *shape: torch.from_numpy(g.random(shape).astype(np.float32))  # noqa: E731
    bf16 = lambda *shape: f32(*shape).to(torch.bfloat16)  # noqa: E731
    i32 = lambda values: torch.tensor(values, dtype=torch.int32)  # noqa: E731
    rows = lambda r: torch.from_numpy(g.integers(0, 256, (r, 128), dtype=np.uint8))  # noqa: E731
    # Three partitions of 4 storage rows (64 8-byte codes), one group each.
    parts, groups = rows(12).reshape(3, 4, 128), (
        i32([0, 1, 2]), i32([[0, 1, -1, 2], [3, -1, -1, -1], [-1, 4, 5, -1]]), i32([64, 37, 5]))
    # Window scans: 1024 8-byte codes, 1000 of them real, block 1024, W 16.
    window = (rows(64),)
    window_rest = (1000, 1024, 16)
    lut = lut_scan
    if name.startswith("grouped_scan8"):
        return lut.grouped_scan8, (parts, bf16(6, 8, 256), *groups), {}, lut.grouped_scan8_plain, \
            1, torch.float32
    if name.startswith("grouped_scan"):
        tables = i8(6, 16, 16) if name.endswith("int8") else f32(6, 16, 16)
        return lut.grouped_scan, (parts, tables, *groups), {}, lut.grouped_scan_plain, 1, None
    if name == "rows_adc":
        return lut.rows_adc, (rows(10), i32([3, 3, 9, 0, 7]), i32([1, 1, 0, 4, 2]),
                              f32(5, 128), f32(5, 128)), {}, lut.rows_adc_plain, 3, torch.bfloat16
    if name == "direct_scan":
        return lut.direct_scan, (rows(48).reshape(3, 16, 128), i32([2, 0, 1, 2]), f32(4, 128),
                                 f32(4, 128), i32([256, 3, 0, 200])), {}, \
            lut.direct_scan_plain, 2, torch.bfloat16
    if name.startswith("flat_scan8"):
        fn = lut.flat_scan8_lookup if name.endswith("lookup") else lut.flat_scan8
        return fn, (rows(16), bf16(3, 8, 256), 250), {}, lut.flat_scan8_plain, 1, torch.float32
    if name == "flat_scan_f32_lookup":
        return lut.flat_scan_f32_lookup, (rows(9), f32(3, 16, 16), 130), {"with_rows": True}, \
            lut.flat_scan_plain, 1, torch.int8
    if name.startswith("flat_scan_window_regs"):
        return lut.flat_scan_window_regs, (*window, i8(3, 16, 16), *window_rest), {}, \
            lambda *a: lut.flat_scan_window_plain(*a)[0], 1, torch.float32
    if name == "flat_scan_window_f32_lookup":
        return lut.flat_scan_window_f32_lookup, (*window, f32(3, 16, 16), *window_rest), \
            {"with_rows": True}, lut.flat_scan_window_plain, 1, torch.int8
    if name.startswith("flat_scan_window"):
        kw = {"min": {}, "rows": {"with_rows": True}, "transposed": {"transpose_out": True},
              "float32": {"with_rows": True}}[name.split()[-1]]
        tables = f32(3, 16, 16) if name.endswith("float32") else i8(3, 16, 16)
        return lut.flat_scan_window, (*window, tables, *window_rest), kw, \
            lut.flat_scan_window_plain, 1, None
    tables = i8(3, 16, 16) if name.endswith("int8") else f32(3, 16, 16)
    return lut.flat_scan, (rows(9), tables, 130), {"with_rows": True}, lut.flat_scan_plain, 1, None


WRAPPER_CASES = ["grouped_scan int8", "grouped_scan float32", "grouped_scan8", "rows_adc",
                 "direct_scan", "flat_scan int8", "flat_scan float32", "flat_scan_f32_lookup",
                 "flat_scan8", "flat_scan8_lookup", "flat_scan_window int8 min",
                 "flat_scan_window int8 rows", "flat_scan_window int8 transposed",
                 "flat_scan_window float32", "flat_scan_window_f32_lookup",
                 "flat_scan_window_regs"]


@pytest.mark.parametrize("name", WRAPPER_CASES)
def test_wrappers_run_the_plain_versions_on_the_cpu(name):
    """Every kernel wrapper on CPU tensors returns its plain version's result
    bit for bit and launches nothing; a wrapper that takes one table dtype
    refuses the other with a TypeError."""
    fn, args, kw, plain, at, refused = _wrapper_case(name)
    before = dict(lut_scan.launches)
    got, want = fn(*args, **kw), plain(*args, **kw)
    got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a is b is None or torch.equal(a, b)
    assert lut_scan.launches == before            # no kernel was launched
    if refused is not None:
        wrong = list(args)
        wrong[at] = wrong[at].to(refused)
        with pytest.raises(TypeError):
            fn(*wrong, **kw)


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
