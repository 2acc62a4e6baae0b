"""The port's builders, checkpoint writer and layout helpers vs the JAX
package, with JAX-trained coarse centroids and quantizers carried across.

Tolerance: exact. Given the same trained state, ivf.add and flat.add must
give the JAX package's codes, labels, part_sizes, n and max_part_size (an
encode mismatch could only come from a float32 near-tie between two
centroids; none occurs on these seeds), three streamed chunks must equal
one shot, and an index saved by either package must load in the other and
search to the same labels.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.core import layout as jlayout
from qadc_tpu.index import build as jbuild
from qadc_tpu.index import flat as jflat
from qadc_tpu.index import ivf as jivf
from qadc_tpu.io import checkpoint as jckpt
from qadc_tpu.ops.knn import assign_nearest as jassign
from qadc_tpu.quantizers.opq import train_opq as jtrain_opq
from qadc_tpu.quantizers.pq import ProductQuantizer as JPQ
from qadc_tpu.quantizers.pq import train_pq as jtrain_pq
from qadc_tpu_torch.convert import index_to_arrays, quantizer_from_arrays
from qadc_tpu_torch.core import layout
from qadc_tpu_torch.index import build, flat, ivf
from qadc_tpu_torch.io.checkpoint import load_index, save_index
from torch_parity import as_np, index_arrays

torch.set_num_threads(1)

DIM, PARTS, N = 32, 12, 5000


@functools.cache
def _trained(m: int, bits: int, kind: str):
    """(base, queries, JAX coarse centroids, JAX quantizer trained on residuals)."""
    g = np.random.default_rng(m + bits)
    centers = g.normal(scale=3.0, size=(PARTS, DIM)).astype(np.float32)
    base = (centers[g.integers(0, PARTS, N)] + g.normal(size=(N, DIM))).astype(np.float32)
    queries = (centers[g.integers(0, PARTS, 8)] + g.normal(size=(8, DIM))).astype(np.float32)
    learn = base[:2000]
    coarse = jivf.train_coarse(jax.random.PRNGKey(0), learn, PARTS, iters=5)
    res = learn - np.asarray(coarse)[np.asarray(jassign(learn, coarse))]
    if kind == "random":  # 16 bits: a drawn codebook and fewer vectors keep the CPU run short
        cent = g.normal(size=(m, 1 << bits, DIM // m)).astype(np.float32)
        return base[:600], queries, coarse, JPQ(centroids=jnp.asarray(cent), sq_bits=bits)
    if kind == "opq":
        jq = jtrain_opq(jax.random.PRNGKey(1), res, m, bits, opq_iters=2, kmeans_iters=3)
    else:
        jq = jtrain_pq(jax.random.PRNGKey(1), res, m, bits, iters=4)
    return base, queries, coarse, jq


def _port_quantizer(jq):
    arrays = {"pq_centroids": np.asarray(jq.centroids)}
    if getattr(jq, "rotation", None) is not None:
        arrays["pq_rotation"] = np.asarray(jq.rotation)
    return quantizer_from_arrays(arrays, {"pq": {"sq_bits": jq.sq_bits}}, "cpu")


def _assert_same_ivf(tindex, jindex):
    for name in ("codes", "labels", "part_sizes", "coarse_centroids"):
        np.testing.assert_array_equal(as_np(getattr(tindex, name)),
                                      np.asarray(getattr(jindex, name)), err_msg=name)
    assert (tindex.n, tindex.max_part_size) == (jindex.n, jindex.max_part_size)
    assert tindex.codes.dtype == torch.uint8 and tindex.labels.dtype == torch.int32
    assert tindex.part_sizes.dtype == torch.int32


GEOMETRIES = [(16, 4, "pq"), (16, 4, "opq"), (8, 8, "pq"), (4, 16, "random")]


@pytest.mark.parametrize("m,bits,kind", GEOMETRIES)
def test_ivf_add_matches_reference(m, bits, kind):
    base, _, coarse, jq = _trained(m, bits, kind)
    jindex = jivf.add(jivf.IVFIndex.create(jq, coarse), base)
    tindex = ivf.add(ivf.IVFIndex.create(_port_quantizer(jq), np.asarray(coarse)), base)
    _assert_same_ivf(tindex, jindex)
    assert tindex.part_pad % ivf.PART_ALIGN == 0 and tindex.part_pad >= tindex.max_part_size


@pytest.mark.parametrize("m,bits,kind", GEOMETRIES)
def test_flat_add_matches_reference(m, bits, kind):
    base, _, _, jq = _trained(m, bits, kind)
    jindex = jflat.add(jflat.FlatIndex.create(jq), base)
    tindex = flat.add(flat.FlatIndex.create(_port_quantizer(jq)), torch.from_numpy(base))
    np.testing.assert_array_equal(as_np(tindex.codes), np.asarray(jindex.codes))
    assert tindex.n == jindex.n == len(base) and tindex.n_pad == jindex.n_pad
    np.testing.assert_array_equal(as_np(tindex.labels), np.asarray(jindex.labels))


@pytest.mark.parametrize("encode_batch", [262144, 700])
def test_streamed_chunks_equal_one_shot(encode_batch):
    base, _, coarse, jq = _trained(16, 4, "pq")
    tq = _port_quantizer(jq)
    one = ivf.add(ivf.IVFIndex.create(tq, np.asarray(coarse)), base, encode_batch=encode_batch)
    b = build.IVFBuilder(tq, np.asarray(coarse))
    for lo, hi in ((0, 100), (100, 3100), (3100, N)):   # the second chunk grows the buffers
        b.add(base[lo:hi], encode_batch=encode_batch)
    b.add(base[:0])
    streamed = b.finalize()
    stepwise = ivf.IVFIndex.create(tq, np.asarray(coarse))
    for lo, hi in ((0, 100), (100, 3100), (3100, N)):   # add() on a non-empty index
        stepwise = ivf.add(stepwise, base[lo:hi])
    for other in (streamed, stepwise):
        _assert_same_ivf(other, one)
    fone = flat.add(flat.FlatIndex.create(tq), base, encode_batch=encode_batch)
    fb = build.FlatBuilder(tq)
    for lo, hi in ((0, 100), (100, 3100), (3100, N)):
        fb.add(base[lo:hi])
    fstep = flat.add(flat.add(flat.FlatIndex.create(tq), base[:1234]), base[1234:])
    for other in (fb.finalize(), fstep):
        assert torch.equal(other.codes, fone.codes) and other.n == fone.n


def test_tail_padding_repeats_the_last_code():
    base, _, coarse, jq = _trained(16, 4, "pq")
    tq = _port_quantizer(jq)
    index = ivf.add(ivf.IVFIndex.create(tq, np.asarray(coarse)), base)
    codes = index.codes.reshape(PARTS, index.part_pad, tq.code_size)
    for p, size in enumerate(index.part_sizes.tolist()):
        assert 0 < size < index.part_pad
        assert (codes[p, size:] == codes[p, size - 1]).all()
        assert (index.labels[p, size:] == index.labels[p, size - 1]).all()
    assert sorted(torch.cat([index.labels[p, :s] for p, s in
                             enumerate(index.part_sizes.tolist())]).tolist()) == list(range(N))
    findex = flat.add(flat.FlatIndex.create(tq), base)
    fcodes = findex.codes.reshape(-1, tq.code_size)
    assert findex.n_pad == 5120 and (fcodes[N:] == fcodes[N - 1]).all()
    assert (findex.labels[N:] == N - 1).all()


def test_empty_builders_and_the_empty_partition_warning(capsys):
    base, _, coarse, jq = _trained(16, 4, "pq")
    tq = _port_quantizer(jq)
    empty = build.IVFBuilder(tq, np.asarray(coarse)).finalize()
    _assert_same_ivf(empty, jivf.IVFIndex.create(jq, coarse))
    assert capsys.readouterr().err == ""
    fempty = build.FlatBuilder(tq).finalize()
    assert fempty.n == 0 and torch.equal(fempty.codes, flat.FlatIndex.create(tq).codes)
    far = np.concatenate([np.asarray(coarse), np.full((1, DIM), 1e4, np.float32)])
    index = ivf.add(ivf.IVFIndex.create(tq, far), base)
    assert "warning: 1/13 partitions are empty" in capsys.readouterr().err
    assert int(index.part_sizes[-1]) == 0 and index.n == N


@pytest.mark.parametrize("part_pad", [1024, 2048])
def test_repad_partitions_matches_reference(part_pad):
    base, _, coarse, jq = _trained(16, 4, "pq")
    jindex = jivf.add(jivf.IVFIndex.create(jq, coarse), base)
    tindex = ivf.add(ivf.IVFIndex.create(_port_quantizer(jq), np.asarray(coarse)), base)
    _assert_same_ivf(build.repad_partitions(tindex, part_pad),
                     jbuild.repad_partitions(jindex, part_pad))
    assert build.repad_partitions(tindex, part_pad).part_pad == part_pad


def test_repad_partitions_errors():
    base, _, coarse, jq = _trained(16, 4, "pq")
    tindex = ivf.add(ivf.IVFIndex.create(_port_quantizer(jq), np.asarray(coarse)), base)
    jindex = jivf.add(jivf.IVFIndex.create(jq, coarse), base)
    with pytest.raises(ValueError, match="multiple of 512"):
        build.repad_partitions(tindex, 1000)
    with pytest.raises(ValueError, match="multiple of 512"):
        jbuild.repad_partitions(jindex, 1000)
    small = dataclasses.replace(tindex, max_part_size=600)
    with pytest.raises(ValueError, match="silently drop"):
        build.repad_partitions(small, 512)
    with pytest.raises(ValueError, match="silently drop"):
        jbuild.repad_partitions(dataclasses.replace(jindex, max_part_size=600), 512)


def test_set_quantizer_and_keep_for_init():
    base, _, coarse, jq = _trained(16, 4, "pq")
    tq = _port_quantizer(jq)
    empty = ivf.IVFIndex.create(tq, np.asarray(coarse))
    other = _port_quantizer(_trained(8, 8, "pq")[3])
    swapped = ivf.set_quantizer(empty, other)
    assert swapped.pq is other and swapped.n == 0
    assert swapped.codes.shape == (PARTS, ivf.PART_ALIGN // 16, 128)
    with pytest.raises(ValueError, match="non-empty"):
        ivf.set_quantizer(ivf.add(empty, base[:50]), other)
    wrong = dataclasses.replace(other, centroids=other.centroids[:, :, :2])
    with pytest.raises(ValueError, match="quantizer dim"):
        ivf.set_quantizer(empty, wrong)
    assert ivf.keep_for_init(2130, 256, 24, 1_000_000) == jivf.keep_for_init(
        2130, 256, 24, 1_000_000)
    for bad in ((0, 256, 24, 10), (5, 0, 24, 10), (5, 256, 0, 10), (5, 256, 24, 0)):
        with pytest.raises(ValueError, match="must be positive"):
            ivf.keep_for_init(*bad)
    res = ivf.compute_residuals(empty, base[:5], np.array([0, 1, 2, 3, 4]))
    np.testing.assert_array_equal(
        res.numpy(), np.asarray(jivf.compute_residuals(
            jivf.IVFIndex.create(jq, coarse), base[:5], jnp.arange(5))))


def test_train_coarse_balances_and_defaults_to_the_card():
    base, _, _, _ = _trained(16, 4, "pq")
    x = torch.from_numpy(base[:2000])
    cent = ivf.train_coarse(0, x, PARTS, iters=5, balance_cap=1.5)
    assert cent.shape == (PARTS, DIM) and cent.dtype == torch.float32
    counts = np.bincount(np.asarray(jassign(base[:2000], cent.numpy())), minlength=PARTS)
    assert counts.max() <= int(1.5 * 2000 / PARTS) + 2     # +2: float32 near-ties
    assert torch.equal(cent, ivf.train_coarse(0, x, PARTS, iters=5, balance_cap=1.5))
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            ivf.train_coarse(0, base[:200], 4, iters=1)
    assert ivf.train_coarse(0, base[:200], 4, iters=1, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("m,bits,kind", GEOMETRIES)
def test_port_saved_ivf_index_loads_in_reference(tmp_path, m, bits, kind):
    base, queries, coarse, jq = _trained(m, bits, kind)
    tindex = ivf.add(ivf.IVFIndex.create(_port_quantizer(jq), np.asarray(coarse)), base)
    save_index(str(tmp_path), tindex)
    jloaded = jckpt.load_index(str(tmp_path))
    _assert_same_ivf(tindex, jloaded)
    assert type(jloaded.pq).__name__ == type(jq).__name__
    back = load_index(str(tmp_path), device="cpu")
    _assert_same_ivf(back, jloaded)
    want_arrays, want_meta = index_arrays(jloaded)
    arrays, manifest = index_to_arrays(tindex)
    assert set(arrays) == set(want_arrays)
    assert manifest == {"format": 1, "type": "ivf", **want_meta,
                        "pq": {"sq_bits": bits, "type": "opq" if kind == "opq" else "pq"}}
    jd, jl = jivf.search_adc(jloaded, jnp.asarray(queries), r=20, ma=4, grouped=False)
    td, tl = ivf.search_adc(tindex, queries, r=20, ma=4, grouped=False)
    np.testing.assert_allclose(as_np(td), np.asarray(jd), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(as_np(tl)[:, :5], np.asarray(jl)[:, :5])


@pytest.mark.parametrize("m,bits,kind", [(16, 4, "opq"), (8, 8, "pq")])
def test_port_saved_flat_index_loads_in_reference(tmp_path, m, bits, kind):
    base, queries, _, jq = _trained(m, bits, kind)
    tindex = flat.add(flat.FlatIndex.create(_port_quantizer(jq)), base)
    save_index(str(tmp_path), tindex)
    jloaded = jckpt.load_index(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jloaded.codes), as_np(tindex.codes))
    assert jloaded.n == N and type(jloaded.pq).__name__ == type(jq).__name__
    back = load_index(str(tmp_path), device="cpu")
    assert torch.equal(back.codes, tindex.codes) and back.n == N
    jd, jl = jflat.search_adc(jloaded, jnp.asarray(queries), r=20, interpret=True)
    td, tl = flat.search_adc(tindex, queries, r=20)
    np.testing.assert_allclose(as_np(td), np.asarray(jd), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(as_np(tl)[:, :5], np.asarray(jl)[:, :5])


def test_save_index_rejects_other_objects(tmp_path):
    with pytest.raises(TypeError, match="unsupported index type"):
        save_index(str(tmp_path), object())
    assert not list(tmp_path.iterdir())


@pytest.mark.parametrize("n,cb", [(0, 8), (5, 8), (1024, 16), (1500, 4)])
def test_layout_helpers_match_reference(n, cb):
    g = np.random.default_rng(n + cb)
    codes = g.integers(0, 256, (n, cb), dtype=np.uint8)
    labels = g.integers(0, 1000, (n,)).astype(np.int32)
    assert layout.padded_count(n) == jlayout.padded_count(n)
    assert layout.padded_count(n, 512) == jlayout.padded_count(n, 512)
    padded = layout.pad_codes_to_block(codes)
    np.testing.assert_array_equal(padded, jlayout.pad_codes_to_block(codes))
    np.testing.assert_array_equal(layout.pad_labels_to_block(labels),
                                  jlayout.pad_labels_to_block(labels))
    rows = layout.to_row128(padded)
    np.testing.assert_array_equal(rows, jlayout.to_row128(padded))
    np.testing.assert_array_equal(layout.from_row128(rows, cb), padded)
    with pytest.raises(ValueError):
        layout.to_row128(padded[:3])
    with pytest.raises(ValueError):
        layout.from_row128(rows[:, :64], cb)
