"""The port's public surface against the JAX package's, name for name.

- Every `__init__` of the JAX package has its twin in the port with the same
  `__all__`, every name resolves, and the version is equal. Importing the
  port initialises no CUDA and loads no kernel toolchain (a subprocess, so
  nothing imported earlier counts).
- Every public name a JAX module defines (an AST scan: functions, classes,
  their members, assignments) resolves in the port's module of the same
  path, except NOT_PORTED, the list in ROADMAP.md ("Not ported, on
  purpose").
- The names the port gained in this slice against their JAX counterparts on
  numpy-seeded inputs: code_bytes (value or ValueError) over every
  (sq_count, sq_bits) with sq_count <= 64, row128_to_codes,
  unpack_nibbles_split, window_min_reduce (ties included) and
  quantize_tables_int8 with its default qmin exact; decode_rows and
  ivf.rows_adc (the JAX Pallas kernel in interpret mode) rtol 1e-6.
- QADC_SCAN_BUDGET_BYTES overrides the scan budget of both indexes.
- The example: its stand-in equals the JAX example's, array for array (the
  ground truth too), and its main runs at a small size on the CPU.
- At GIST1M's dim (960), the flat and IVF searches at 32x4 (CB = 16) and
  16x8 (m = 16) against the JAX package's (interpret mode) on a small
  trained index: Quick ADC with rerank and float ADC distances rtol 1e-5,
  Quick ADC without rerank bit for bit on queries whose int8 tables agree,
  the screened 8-bit searches' top-1 equal and the exact oracle's top-r
  overlap >= 0.95.
"""

import ast
import functools
import importlib
import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qadc_tpu
import qadc_tpu_torch
from qadc_tpu.eval.synth import gist_moment_like
from qadc_tpu.index import flat as jflat
from qadc_tpu.index import ivf as jivf
from qadc_tpu.ops.knn import assign_nearest as jassign
from qadc_tpu.quantizers.pq import train_pq as jtrain_pq
from qadc_tpu_torch.convert import flat_index_from_arrays
from qadc_tpu_torch.core import packing
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.kernels.lut_scan import DISPATCH
from qadc_tpu_torch.ops import quantization, topk
from qadc_tpu_torch.quantizers import pq
from torch_parity import as_np, to_port
from torch_threads import ONE_THREAD_ENV, pin_one_thread

pin_one_thread()

REPO = Path(__file__).resolve().parents[1]
INITS = ("", "core", "eval", "index", "io", "kernels", "ops", "quantizers", "dist")
# ROADMAP.md, "Not ported, on purpose": TPU knobs and storage, the relay
# slope timer, the TPU-only screens, and the Pallas entry points of
# kernels/lut_scan.py with their TPU helpers (their CUDA counterparts have
# the port's own names: ROADMAP Queue 2).
NOT_PORTED = {
    "eval/timing.py": {"fori_slope_percentiles", "fori_slope_seconds", "make_time_call",
                       "slope_seconds"},
    "ops/topk.py": {"bf16_screen", "screen_smallest"},
    "index/flat.py": {"FlatIndex.tq_block_n", "FlatIndex.with_planes"},
    "index/ivf.py": {"IVFIndex.tq_block_n", "IVFIndex.with_planes"},
    "kernels/lut_scan.py": {
        "MAX_BLOCK_N", "build_scan8_tables", "build_scan_tables", "build_scan_tables_tq",
        "lut_scan8_grouped_prefetch", "lut_scan8_grouped_tq", "lut_scan8_reduce",
        "lut_scan_grouped_prefetch", "lut_scan_grouped_tq", "lut_scan_reduce", "lut_scan_tq",
        "lut_scan_vpu_reduce", "pick_block_n", "pick_block_n_tq", "rows_adc_accumulate",
        "rows_adc_block_rows", "rows_adc_grouped_prefetch", "to_planes"},
}


def _package(name, root):
    return importlib.import_module(f"{root}.{name}" if name else root)


@pytest.mark.parametrize("name", INITS)
def test_all_equals_the_jax_packages(name):
    jmod, tmod = _package(name, "qadc_tpu"), _package(name, "qadc_tpu_torch")
    assert tmod.__all__ == jmod.__all__
    for attr in tmod.__all__:
        assert getattr(tmod, attr) is not None, attr


def test_version_and_top_level_names():
    assert qadc_tpu_torch.__version__ == qadc_tpu.__version__ == "0.1.0"
    assert qadc_tpu_torch.train_opq is importlib.import_module(
        "qadc_tpu_torch.quantizers.opq").train_opq
    assert qadc_tpu_torch.FlatIndex is flat.FlatIndex and qadc_tpu_torch.IVFIndex is ivf.IVFIndex


def test_import_initialises_no_cuda():
    code = ("import sys, torch, qadc_tpu_torch, qadc_tpu_torch.dist, qadc_tpu_torch.io; "
            "assert not torch.cuda.is_initialized(); "
            "assert 'qadc_tpu_torch.kernels.build' not in sys.modules; "
            "assert 'qadc_tpu' not in sys.modules; "
            "print('ok')")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env={**os.environ, "PYTHONPATH": str(REPO), **ONE_THREAD_ENV},
                         timeout=120)
    assert out.stdout.strip() == "ok", out.stderr


def _defined(path: Path) -> set:
    """Public module-level definitions and assignments of a file, and the
    methods and properties of its classes (as Class.member)."""
    names = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
            if isinstance(node, ast.ClassDef):
                names |= {f"{node.name}.{m.name}" for m in node.body
                          if isinstance(m, ast.FunctionDef)}
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return {n for n in names if not n.split(".")[-1].startswith("_")}


def _resolves(module, name: str) -> bool:
    obj = module
    for part in name.split("."):
        if not hasattr(obj, part):
            return False
        obj = getattr(obj, part)
    return True


def test_public_names_diff_is_the_not_ported_list():
    """Each public name the JAX package defines, looked up in the port's
    module of the same path (a name the port imports there counts)."""
    missing = {}
    for path in sorted((REPO / "qadc_tpu").rglob("*.py")):
        rel = path.relative_to(REPO / "qadc_tpu")
        dotted = ".".join(("qadc_tpu_torch",) + rel.with_suffix("").parts)
        twin = importlib.import_module(dotted) if (REPO / "qadc_tpu_torch" / rel).exists() else None
        lacking = {n for n in _defined(path) if twin is None or not _resolves(twin, n)}
        if lacking:
            missing[str(rel)] = lacking
    assert missing == NOT_PORTED


# ---------------------------------------------------------------- new names


def test_code_bytes_matches_reference():
    from qadc_tpu.core.packing import code_bytes as jcode_bytes

    for sq_count in range(1, 65):
        for sq_bits in (1, 2, 3, 4, 8, 12, 16, 32):
            try:
                want = jcode_bytes(sq_count, sq_bits)
            except ValueError:
                with pytest.raises(ValueError):
                    packing.code_bytes(sq_count, sq_bits)
                continue
            assert packing.code_bytes(sq_count, sq_bits) == want


@pytest.mark.parametrize("code_size", [4, 8, 16, 32])
def test_row128_to_codes_and_nibble_split_match_reference(code_size):
    from qadc_tpu.core.packing import row128_to_codes, unpack_nibbles_split

    rows = np.random.default_rng(code_size).integers(0, 256, (7, 128), dtype=np.uint8)
    got = packing.row128_to_codes(torch.from_numpy(rows), code_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(row128_to_codes(rows, code_size)))
    for g, w in zip(packing.unpack_nibbles_split(got), unpack_nibbles_split(np.asarray(got))):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("m,bits", [(8, 8), (16, 4), (4, 16)])
def test_decode_rows_and_centroid_count_match_reference(m, bits):
    from qadc_tpu.index.flat import decode_rows as jdecode_rows
    from qadc_tpu.quantizers.pq import ProductQuantizer as JPQ

    g = np.random.default_rng(m)
    cent = g.normal(size=(m, 1 << bits, 32 // m)).astype(np.float32)
    idx = g.integers(0, 1 << bits, (5, 3, m)).astype(np.int32)
    tq = pq.ProductQuantizer(centroids=torch.from_numpy(cent), sq_bits=bits)
    jq = JPQ(centroids=jnp.asarray(cent), sq_bits=bits)
    assert tq.sq_centroid_count == jq.sq_centroid_count == 1 << bits
    got = flat.decode_rows(tq, torch.from_numpy(idx))
    np.testing.assert_allclose(got.numpy(), np.asarray(jdecode_rows(jq, jnp.asarray(idx))),
                               rtol=1e-6)


@pytest.mark.parametrize("cb", [8, 16])
@pytest.mark.parametrize("a", [1, 37, 600])
def test_rows_adc_matches_reference(cb, a):
    g = np.random.default_rng(cb * 1000 + a)
    rows = g.integers(0, 256, (a, 128), dtype=np.uint8)
    tlo = g.random((a, 16 * cb)).astype(np.float32) * 4
    thi = g.random((a, 16 * cb)).astype(np.float32) * 4
    want = np.asarray(jivf.rows_adc(jnp.asarray(rows), jnp.asarray(tlo), jnp.asarray(thi), cb,
                                    interpret=True))
    got = ivf.rows_adc(*(torch.from_numpy(t) for t in (rows, tlo, thi)), cb)
    assert got.shape == (a, 128 // cb) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_rows_adc_checks_its_widths():
    rows = torch.zeros((4, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):
        ivf.rows_adc(rows, torch.zeros((4, 128)), torch.zeros((4, 128)), 16)
    with pytest.raises(ValueError):  # M2 takes 8 or 16 code bytes
        ivf.rows_adc(rows, torch.zeros((4, 64)), torch.zeros((4, 64)), 4)


@pytest.mark.parametrize("window,base_index", [(1, 0), (4, 0), (8, 1000), (24, 7)])
def test_window_min_reduce_matches_reference(window, base_index):
    from qadc_tpu.ops.topk import window_min_reduce as jwmr

    g = np.random.default_rng(window)
    d = g.integers(0, 6, (96, 5)).astype(np.float32)     # many ties inside a window
    jv, ji = jwmr(jnp.asarray(d), window, base_index)
    tv, ti = topk.window_min_reduce(torch.from_numpy(d), window, base_index)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    with pytest.raises(ValueError):
        topk.window_min_reduce(torch.from_numpy(d), 7)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_tables_default_qmin_matches_reference(seed):
    from qadc_tpu.ops.quantization import QMAX_GUARD, quantize_tables_int8

    g = np.random.default_rng(seed)
    tables = (g.random((6, 16, 16)) * 50 - (5 if seed else 0)).astype(np.float32)
    qmax = np.float32(30.0 + seed)
    want = np.asarray(quantize_tables_int8(jnp.asarray(tables), qmax))
    got = quantization.quantize_tables_int8(torch.from_numpy(tables), qmax)
    np.testing.assert_array_equal(got.numpy(), want)
    assert quantization.QMAX_GUARD == QMAX_GUARD


def test_format_version_and_shard_axis():
    from qadc_tpu.dist.mesh import SHARD_AXIS
    from qadc_tpu.io.checkpoint import FORMAT_VERSION

    from qadc_tpu_torch import convert
    from qadc_tpu_torch.dist import mesh
    from qadc_tpu_torch.io import checkpoint

    assert checkpoint.FORMAT_VERSION is convert.FORMAT_VERSION
    assert checkpoint.FORMAT_VERSION == FORMAT_VERSION
    assert mesh.SHARD_AXIS == SHARD_AXIS


def test_scan_budget_env_override(monkeypatch):
    cpu = torch.device("cpu")
    ivf._default_scan_budget.cache_clear()
    try:
        assert ivf._default_scan_budget(cpu) == ivf.SCAN_BUDGET_BYTES
        monkeypatch.setenv("QADC_SCAN_BUDGET_BYTES", "12345")
        assert ivf._default_scan_budget(cpu) == ivf.SCAN_BUDGET_BYTES  # read once, cached
        ivf._default_scan_budget.cache_clear()
        assert ivf._default_scan_budget(cpu) == 12345
        index = flat.FlatIndex.create(pq.ProductQuantizer(torch.zeros((16, 16, 2)), 4))
        assert flat._scan_budget(index, None) == 12345
        assert flat._scan_budget(index, 99) == 99
    finally:
        ivf._default_scan_budget.cache_clear()


def test_scan_budget_env_chunks_a_search(monkeypatch):
    """A budget of one byte from the environment runs the IVF search one
    query at a time, as scan_budget_bytes=1 does: the same results."""
    from torch_parity import synthetic_index

    jindex, queries = synthetic_index()
    tindex = to_port(jindex)
    want = ivf.search_qadc(tindex, queries, r=20, ma=3, scan_budget_bytes=1)
    monkeypatch.setenv("QADC_SCAN_BUDGET_BYTES", "1")
    ivf._default_scan_budget.cache_clear()
    try:
        got = ivf.search_qadc(tindex, queries, r=20, ma=3)
    finally:
        ivf._default_scan_budget.cache_clear()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# ---------------------------------------------------------------- the example


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _examples():
    return (_load(REPO / "examples" / "sift_pipeline.py", "jax_sift_pipeline"),
            _load(REPO / "examples" / "torch_sift_pipeline.py", "torch_sift_pipeline"))


def test_example_stand_in_equals_the_jax_examples():
    jex, tex = _examples()
    want = jex.load_or_synthesize(None)
    got = tex.load_or_synthesize(None, torch.device("cpu"))
    assert got[4] == want[4] == "synthetic"
    for g, w in zip(got[:3], want[:3]):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), w)
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))


def test_example_main_runs_small_on_the_cpu(capsys):
    _, tex = _examples()
    out = tex.main(["--device", "cpu", "--learn", "6000", "--base", "8000",
                    "--queries", "16"])
    assert out["name"] == "synthetic" and 0.3 <= out["recall"] <= 1.0
    assert set(out["seconds"]) == {"coarse k-means", "OPQ 16x4 training", "encode+add",
                                   "search"}
    assert "recall@100" in capsys.readouterr().out


# ---------------------------------------------------------------- dim 960


@functools.cache
def _gist():
    """GIST-like vectors of the JAX package's generator: 3,000 base vectors
    of dim 960 (the first 2,000 the learn set) and 8 queries."""
    return gist_moment_like(np.random.default_rng(0), 3000, nq=8)


@functools.cache
def _gist_flat(m, bits):
    base, _ = _gist()
    q = jtrain_pq(jax.random.PRNGKey(0), base[:2000], m, bits, iters=4)
    jindex = jflat.add(jflat.FlatIndex.create(q), base)
    arrays = {"codes": np.asarray(jindex.codes),
              "pq_centroids": np.asarray(jindex.pq.centroids, np.float32)}
    meta = {"n": jindex.n, "pq": {"sq_bits": bits}}
    return jindex, flat_index_from_arrays(arrays, meta, torch.device("cpu"))


@functools.cache
def _gist_ivf(m, bits):
    base, _ = _gist()
    learn = base[:2000]
    coarse = jivf.train_coarse(jax.random.PRNGKey(0), learn, 8, iters=5)
    res = learn - np.asarray(coarse)[np.asarray(jassign(learn, coarse))]
    q = jtrain_pq(jax.random.PRNGKey(1), res, m, bits, iters=4)
    jindex = jivf.add(jivf.IVFIndex.create(q, coarse), base)
    if jindex.planes is not None:
        jindex = jindex.__class__(**{**jindex.__dict__, "planes": None})
    return jindex, to_port(jindex)


def _assert_close_labels(gd, gl, wd, wl, rtol=1e-5):
    """Distances within rtol; labels equal wherever a distance stands
    apart from its row neighbours by more than rtol."""
    assert np.array_equal(np.isfinite(gd), np.isfinite(wd))
    fin = np.isfinite(wd)
    np.testing.assert_allclose(gd[fin], wd[fin], rtol=rtol)
    pad = np.concatenate([np.full_like(wd[:, :1], -np.inf), wd, wd[:, -1:]], axis=1)
    with np.errstate(invalid="ignore"):
        gap = np.minimum(np.abs(pad[:, 1:-1] - pad[:, :-2]), np.abs(pad[:, 2:] - pad[:, 1:-1]))
    clear = fin & (gap > rtol * np.abs(wd))
    assert clear.mean() > 0.3
    np.testing.assert_array_equal(gl[clear], wl[clear])


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)])


@pytest.mark.parametrize("rerank", [True, False])
def test_gist_flat_32x4_qadc_matches_reference(rerank):
    jindex, tindex = _gist_flat(32, 4)
    _, queries = _gist()
    kw = dict(r=20, keep=0.05, rerank=rerank)
    gd, gl = map(as_np, flat.search_qadc(tindex, torch.from_numpy(queries), **kw))
    wd, wl = map(np.asarray, jflat.search_qadc(jindex, queries, interpret=True, **kw))
    if rerank:
        _assert_close_labels(gd, gl, wd, wl)
    else:
        np.testing.assert_array_equal(gd, wd)
        np.testing.assert_array_equal(gl, wl)


def test_gist_flat_16x8_adc_matches_reference():
    jindex, tindex = _gist_flat(16, 8)
    _, queries = _gist()
    gd, gl = map(as_np, flat.search_adc(tindex, torch.from_numpy(queries), r=20))
    wd, wl = map(np.asarray, jflat.search_adc(jindex, queries, r=20, interpret=True))
    od, ol = map(np.asarray, jflat.search_adc(jindex, queries, r=20))    # exact per-code
    np.testing.assert_array_equal(gl[:, 0], wl[:, 0])
    np.testing.assert_allclose(gd[:, 0], wd[:, 0], rtol=1e-5)
    assert _overlap(gl, ol) >= 0.95


@pytest.mark.parametrize("rerank", [True, False])
def test_gist_ivf_32x4_qadc_matches_reference(rerank):
    jindex, tindex = _gist_ivf(32, 4)
    _, queries = _gist()
    kw = dict(r=20, ma=3, keep=0.05, rerank=rerank, grouped=True, direct=False)
    gd, gl = map(as_np, ivf.search_qadc(tindex, torch.from_numpy(queries), **kw))
    wd, wl = map(np.asarray, jivf.search_qadc(jindex, jnp.asarray(queries), interpret=True,
                                              grouped_window=8, block_n=2048, **kw))  # window = cpr
    if rerank:
        _assert_close_labels(gd, gl, wd, wl)
        return
    prefix_pad = min(max(1, int(jindex.max_part_size * 0.05)), jindex.part_pad)
    _, _, jq, _ = jivf._quantized_tables(jindex, jnp.asarray(queries), 20, 3, 0.05,
                                         prefix_pad, interpret=True)
    _, _, tq, _ = ivf._quantized_tables(tindex, torch.from_numpy(queries), 20, 3, 0.05,
                                        prefix_pad, DISPATCH)
    same = (np.asarray(jq) == as_np(tq)).reshape(queries.shape[0], -1).all(axis=1)
    assert same.mean() >= 0.75, same.mean()
    np.testing.assert_array_equal(gd[same], wd[same])
    np.testing.assert_array_equal(gl[same], wl[same])


def test_gist_ivf_32x4_direct_matches_reference():
    jindex, tindex = _gist_ivf(32, 4)
    _, queries = _gist()
    kw = dict(r=20, ma=3, keep=0.05, direct=True)
    gd, gl = map(as_np, ivf.search_qadc(tindex, torch.from_numpy(queries[:1]), **kw))
    wd, wl = map(np.asarray, jivf.search_qadc(jindex, jnp.asarray(queries[:1]),
                                              interpret=True, **kw))
    _assert_close_labels(gd, gl, wd, wl)


def test_gist_ivf_16x8_adc_matches_reference():
    jindex, tindex = _gist_ivf(16, 8)
    _, queries = _gist()
    kw = dict(r=20, ma=3)
    gd, gl = map(as_np, ivf.search_adc(tindex, torch.from_numpy(queries), grouped=True, **kw))
    wd, wl = map(np.asarray, jivf.search_adc(jindex, jnp.asarray(queries), grouped=True,
                                             interpret=True, **kw))
    od, ol = map(np.asarray, jivf.search_adc(jindex, jnp.asarray(queries), grouped=False,
                                             **kw))
    np.testing.assert_array_equal(gl[:, 0], wl[:, 0])
    np.testing.assert_array_equal(gl[:, 0], ol[:, 0])
    np.testing.assert_allclose(gd[:, 0], od[:, 0], rtol=1e-5)
    assert _overlap(gl, ol) >= 0.95
