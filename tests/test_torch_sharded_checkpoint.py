"""Sharded IVF checkpoints cross between the packages both ways
(qadc_tpu_torch/io/checkpoint.py: save_index_sharded, load_index_shard,
load_index_rows against qadc_tpu/io/checkpoint.py's).

Tolerance: exact. The port's loaders give the JAX loaders' arrays over
ranges that span shard files and run into the zero-filled tail; the port
writes the same arrays and the same manifest.json, byte for byte, as the
JAX package.
"""

import json
import os

import numpy as np
import pytest

from qadc_tpu.io import checkpoint as jck
from qadc_tpu_torch.io import checkpoint as tck
from test_torch_checkpoint import _opq_index
from torch_parity import as_np, synthetic_index, to_port, trained_index

FIELDS = ("codes", "labels", "part_sizes", "coarse_centroids")
# (lo, hi) partition rows of a checkpoint of 16 partitions in 3 files of 6
# (18 stored: 2 empty): within a file, across files, into the tail, all
# tail, the whole and empty.
RANGES = [(0, 6), (4, 11), (15, 22), (19, 25), (0, 18), (7, 7)]


def _index(kind):
    if kind == "trained":
        return trained_index()[0]
    if kind == "opq":
        return _opq_index()[0]
    return synthetic_index()[0]


def _assert_same_index(got, want):
    for name in FIELDS:
        np.testing.assert_array_equal(as_np(getattr(got, name)), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(as_np(got.pq.centroids), np.asarray(want.pq.centroids))
    rot = getattr(want.pq, "rotation", None)
    assert (getattr(got.pq, "rotation", None) is None) == (rot is None)
    if rot is not None:
        np.testing.assert_array_equal(as_np(got.pq.rotation), np.asarray(rot))
    assert (got.n, got.max_part_size) == (want.n, want.max_part_size)


@pytest.fixture(scope="module")
def jax_saved(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jax_sharded") / "ck")
    jck.save_index_sharded(path, trained_index()[0], num_shards=3)
    return path


@pytest.mark.parametrize("lo,hi", RANGES)
def test_port_loads_jax_rows(jax_saved, lo, hi):
    got, manifest = tck.load_index_rows(jax_saved, lo, hi, device="cpu")
    want, jmanifest = jck.load_index_rows(jax_saved, lo, hi)
    assert manifest == jmanifest and manifest["parts_per_shard"] == 6
    assert got.codes.shape[0] == hi - lo and got.codes.device.type == "cpu"
    _assert_same_index(got, want)


@pytest.mark.parametrize("shard", [0, 1, 2])
def test_port_loads_jax_shard(jax_saved, shard):
    got, manifest = tck.load_index_shard(jax_saved, shard, device="cpu")
    want, jmanifest = jck.load_index_shard(jax_saved, shard)
    assert manifest == jmanifest
    _assert_same_index(got, want)


@pytest.mark.parametrize("kind,shards", [("trained", 3), ("opq", 3), ("synthetic", 4)])
def test_port_save_matches_jax_save(tmp_path, kind, shards):
    """The port's files hold the JAX package's arrays (same keys, order and
    dtypes) and its manifest byte for byte; the JAX loaders read them."""
    jindex = _index(kind)
    tpath, jpath = str(tmp_path / "port"), str(tmp_path / "jax")
    tck.save_index_sharded(tpath, to_port(jindex), num_shards=shards)
    jck.save_index_sharded(jpath, jindex, num_shards=shards)
    with open(os.path.join(tpath, "manifest.json")) as f, \
            open(os.path.join(jpath, "manifest.json")) as g:
        assert f.read() == g.read()
    names = ["shared.npz"] + [f"shard_{s:05d}.npz" for s in range(shards)]
    assert sorted(os.listdir(tpath)) == sorted(names + ["manifest.json"])
    for name in names:
        with np.load(os.path.join(tpath, name)) as a, np.load(os.path.join(jpath, name)) as b:
            assert a.files == b.files
            for key in a.files:
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
    with open(os.path.join(tpath, "manifest.json")) as f:
        per = json.load(f)["parts_per_shard"]
    for s in range(shards):
        got, _ = jck.load_index_shard(tpath, s)
        want, _ = tck.load_index_shard(jpath, s, device="cpu")
        assert got.codes.shape[0] == per
        _assert_same_index(want, got)
    got, _ = jck.load_index_rows(tpath, 1, per * shards + 2)
    want, _ = tck.load_index_rows(tpath, 1, per * shards + 2, device="cpu")
    _assert_same_index(want, got)


def test_sharded_loaders_reject(tmp_path, jax_saved):
    """A bad range, and a checkpoint that is not sharded, raise in both."""
    for lo, hi in ((3, 2), (-1, 2)):
        with pytest.raises(ValueError, match="bad row range"):
            tck.load_index_rows(jax_saved, lo, hi, device="cpu")
        with pytest.raises(ValueError, match="bad row range"):
            jck.load_index_rows(jax_saved, lo, hi)
    whole = str(tmp_path / "whole")
    jck.save_index(whole, trained_index()[0])
    for load in (lambda: tck.load_index_rows(whole, 0, 1, device="cpu"),
                 lambda: tck.load_index_shard(whole, 0, device="cpu")):
        with pytest.raises(ValueError, match="not a sharded checkpoint"):
            load()
    with pytest.raises(ValueError, match="not a sharded checkpoint"):
        jck.load_index_rows(whole, 0, 1)
    with pytest.raises(TypeError):
        tck.save_index_sharded(str(tmp_path / "flat"), object(), 2)
