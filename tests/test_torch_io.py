"""The port's vecs and quantizer files against qadc_tpu's.

Files are bytes, so every comparison is exact: the same arrays, and files
written by one package byte-equal to the other's and readable by it. The
byte-level fixtures are those of tests/test_io.py (laid down with
struct/tofile from the reference's documented formats). The native (C++)
and numpy paths of the port are held equal too. Tolerance: exact.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from qadc_tpu.io import quantizer_files as jqf
from qadc_tpu.io import vecs as jvecs
from qadc_tpu.quantizers.opq import train_opq as jtrain_opq
from qadc_tpu.quantizers.pq import train_pq as jtrain_pq
from qadc_tpu_torch.io import native, vecs
from qadc_tpu_torch.io.quantizer_files import load_quantizer_file, save_quantizer_file
from qadc_tpu_torch.io.stream import VectorStream
from qadc_tpu_torch.quantizers.opq import OPQQuantizer, train_opq
from qadc_tpu_torch.quantizers.pq import ProductQuantizer, encode_indices

# The suite runs in several worker processes on shared cores; one PyTorch
# thread per worker keeps each from crowding the others.
torch.set_num_threads(1)

FIXDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")
KINDS = [(".fvecs", np.float32), (".ivecs", np.int32), (".bvecs", np.uint8)]


def _data(rng, dtype, n=57, dim=12):
    if dtype == np.float32:
        return rng.normal(size=(n, dim)).astype(dtype)
    return rng.integers(0, 200, size=(n, dim)).astype(dtype)


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_native_library_builds_into_the_checkout():
    """Under build/native/ of the checkout, never the JAX package's
    ~/.cache/qadc_tpu."""
    assert native.get_lib() is not None
    assert (native.BUILD_DIR / "libqadc_io.so").exists()
    assert native.BUILD_DIR == native.ROOT / "build" / "native"


@pytest.mark.parametrize("ext,dtype", KINDS)
@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_vecs_roundtrip_matches_reference(tmp_path, ext, dtype, use_native):
    rng = np.random.default_rng(1)
    data = _data(rng, dtype)
    ours, theirs = str(tmp_path / f"ours{ext}"), str(tmp_path / f"theirs{ext}")
    vecs.save_vectors(ours, data, native=use_native)
    jvecs.save_vectors(theirs, data)
    assert _bytes(ours) == _bytes(theirs)
    assert vecs.vecs_info(theirs, native=use_native) == jvecs.vecs_info(ours) == (12, 57)
    got = vecs.load_vectors(theirs, to_float=False, native=use_native)
    assert got.dtype == dtype
    np.testing.assert_array_equal(got, data)
    for off, count in ((0, None), (10, 20), (56, 1), (57, 0)):
        a = vecs.load_vectors(ours, off, count, native=use_native)
        b = jvecs.load_vectors(ours, off, count)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="outside"):
        vecs.load_vectors(ours, 50, 10, native=use_native)


@pytest.mark.parametrize("ext,dtype", KINDS)
def test_native_and_numpy_paths_agree(tmp_path, ext, dtype):
    data = _data(np.random.default_rng(2), dtype, n=301, dim=7)
    a, b = str(tmp_path / f"a{ext}"), str(tmp_path / f"b{ext}")
    vecs.save_vectors(a, data, native=True)
    vecs.save_vectors(b, data, native=False)
    assert _bytes(a) == _bytes(b)
    for to_float in (True, False):
        x = vecs.load_vectors(a, 3, 200, to_float=to_float, native=True)
        y = vecs.load_vectors(a, 3, 200, to_float=to_float, native=False)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_split_vecs_matches_reference(tmp_path, use_native):
    src = str(tmp_path / "x.bvecs")
    data = _data(np.random.default_rng(3), np.uint8, n=100, dim=8)
    vecs.save_vectors(src, data)
    for chunk_id in (0, 1, 3):  # the last chunk is cut at the end of the file
        ours, theirs = str(tmp_path / "o.bvecs"), str(tmp_path / "t.bvecs")
        vecs.split_vecs(src, ours, chunk_id, 30, native=use_native)
        jvecs.split_vecs(src, theirs, chunk_id, 30)
        assert _bytes(ours) == _bytes(theirs)
    np.testing.assert_array_equal(vecs.load_vectors(ours, to_float=False), data[90:])
    with pytest.raises(IOError):
        vecs.split_vecs(src, ours, 4, 30, native=use_native)


def test_vector_stream_concatenates_to_the_file(tmp_path):
    path = str(tmp_path / "x.fvecs")
    data = _data(np.random.default_rng(4), np.float32, n=100, dim=8)
    vecs.save_vectors(path, data)
    chunks = list(VectorStream(path, chunk_size=32))
    assert [off for off, _ in chunks] == [0, 32, 64, 96]
    np.testing.assert_array_equal(np.concatenate([c for _, c in chunks]), data)
    stream = VectorStream(path, chunk_size=100)
    assert (stream.dim, stream.count) == (8, 100)
    assert [off for off, _ in stream] == [0]


def test_vector_stream_releases_its_thread_on_early_exit(tmp_path):
    path = str(tmp_path / "x.fvecs")
    vecs.save_vectors(path, _data(np.random.default_rng(5), np.float32, n=200, dim=4))
    before = threading.active_count()
    for off, _ in VectorStream(path, chunk_size=10):
        if off == 20:
            break
    assert threading.active_count() == before


def test_vector_stream_raises_the_readers_error(tmp_path, monkeypatch):
    path = str(tmp_path / "x.fvecs")
    vecs.save_vectors(path, _data(np.random.default_rng(6), np.float32, n=50, dim=4))
    stream = VectorStream(path, chunk_size=20)

    def broken(*args, **kwargs):
        raise IOError("disk gone")

    monkeypatch.setattr("qadc_tpu_torch.io.stream.load_vectors", broken)
    with pytest.raises(IOError, match="disk gone"):
        list(stream)


# ---- the reference's byte-level fixtures, read by both packages ----


def _fixture_centroids():
    c = np.zeros((4, 16, 2), np.float32)
    for i in range(4):
        for j in range(16):
            for d in range(2):
                c[i, j, d] = i * 1000 + j * 10 + d
    return c


@pytest.mark.parametrize("suffix", ["pq.data", "opq.data"])
def test_fixture_quantizers_read_equal_in_both_packages(tmp_path, suffix):
    path = os.path.join(FIXDIR, f"interop_tiny.{suffix}")
    ours = load_quantizer_file(path, device="cpu")
    theirs = jqf.load_quantizer_file(path)
    assert (ours.dim, ours.sq_count, ours.sq_bits) == (theirs.dim, theirs.sq_count,
                                                       theirs.sq_bits) == (8, 4, 4)
    np.testing.assert_array_equal(ours.centroids.numpy(), np.asarray(theirs.centroids))
    np.testing.assert_array_equal(ours.centroids.numpy(), _fixture_centroids())
    assert isinstance(ours, OPQQuantizer) == (suffix == "opq.data")
    if suffix == "opq.data":
        np.testing.assert_array_equal(ours.rotation.numpy(), np.asarray(theirs.rotation))
    # The port's writer gives the fixture's bytes back.
    out = str(tmp_path / f"rt.{suffix}")
    save_quantizer_file(out, ours)
    assert _bytes(out) == _bytes(path)
    # Vector v's sub-quantizer i sits on centroid (v*3+i) % 16 (test_io.py).
    fv = os.path.join(FIXDIR, "interop_tiny.fvecs")
    x = vecs.load_vectors(fv)
    np.testing.assert_array_equal(x, jvecs.load_vectors(fv))
    if suffix == "opq.data":
        x = np.roll(x, 1, axis=1)
    want = np.array([[(v * 3 + i) % 16 for i in range(4)] for v in range(3)])
    np.testing.assert_array_equal(encode_indices(ours, torch.from_numpy(x)).numpy(), want)


def test_quantizer_files_cross_packages(tmp_path):
    """A file saved by either package loads in the other to equal arrays, and
    both write the same bytes for the same quantizer."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(400, 16)).astype(np.float32)
    jpq = jtrain_pq(jax.random.PRNGKey(0), x, 4, 4, iters=3)
    jopq = jtrain_opq(jax.random.PRNGKey(1), x, 4, 4, opq_iters=2, kmeans_iters=3)
    opq = train_opq(0, x, 8, 4, opq_iters=2, kmeans_iters=3, device="cpu")
    for name, q in (("j.pq.data", jpq), ("j.opq.data", jopq)):
        path = str(tmp_path / name)
        jqf.save_quantizer_file(path, q)
        ours = load_quantizer_file(path, device="cpu")
        np.testing.assert_array_equal(ours.centroids.numpy(), np.asarray(q.centroids))
        out = str(tmp_path / f"again.{name}")
        save_quantizer_file(out, ours)
        assert _bytes(out) == _bytes(path)
    path = str(tmp_path / "p.opq.data")
    save_quantizer_file(path, opq)
    theirs = jqf.load_quantizer_file(path)
    np.testing.assert_array_equal(np.asarray(theirs.centroids), opq.centroids.numpy())
    np.testing.assert_array_equal(np.asarray(theirs.rotation), opq.rotation.numpy())
    assert _bytes(path)[:12] == np.array([16, 8, 4], np.int32).tobytes()
    with pytest.raises(ValueError, match="OPQ"):
        save_quantizer_file(str(tmp_path / "wrong.pq.data"), opq)
    plain = ProductQuantizer(centroids=opq.centroids, sq_bits=4)
    with pytest.raises(ValueError, match="OPQ filename"):
        save_quantizer_file(str(tmp_path / "wrong.opq.data"), plain)
    with pytest.raises(ValueError, match="suffix"):
        load_quantizer_file(str(tmp_path / "q.bin"), device="cpu")

