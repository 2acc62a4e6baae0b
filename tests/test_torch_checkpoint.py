"""An index saved by qadc_tpu.io.checkpoint.save_index loads in the port.

Tolerance: exact (the same arrays; the same search on them).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.index import ivf as jivf
from qadc_tpu.io.checkpoint import save_index
from qadc_tpu.quantizers.opq import OPQQuantizer as JOPQ
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.io.checkpoint import load_index
from qadc_tpu_torch.quantizers.opq import OPQQuantizer
from torch_parity import as_np, index_arrays, synthetic_index, to_port, trained_index


def _opq_index():
    """The synthetic index with a random orthonormal OPQ rotation."""
    jindex, queries = synthetic_index()
    dim = jindex.pq.dim
    rot, _ = np.linalg.qr(np.random.default_rng(2).normal(size=(dim, dim)))
    pq = JOPQ(centroids=jindex.pq.centroids, sq_bits=4,
              rotation=jnp.asarray(rot.astype(np.float32)))
    return dataclasses.replace(jindex, pq=pq), queries


@pytest.mark.parametrize("kind", ["trained", "opq"])
def test_saved_index_loads_with_equal_arrays(tmp_path, kind):
    if kind == "trained":
        jindex, queries, _ = trained_index()
    else:
        jindex, queries = _opq_index()
    save_index(str(tmp_path), jindex)
    loaded = load_index(str(tmp_path))
    direct = to_port(jindex)
    arrays, meta = index_arrays(jindex)
    for name in ("codes", "labels", "part_sizes", "coarse_centroids"):
        np.testing.assert_array_equal(as_np(getattr(loaded, name)), arrays[name])
    np.testing.assert_array_equal(as_np(loaded.pq.centroids), arrays["pq_centroids"])
    assert (loaded.n, loaded.max_part_size) == (meta["n"], meta["max_part_size"])
    assert isinstance(loaded.pq, OPQQuantizer) == (kind == "opq")
    if kind == "opq":
        np.testing.assert_array_equal(as_np(loaded.pq.rotation), arrays["pq_rotation"])
    for kw in (dict(direct=True), dict(grouped=True, direct=False)):
        a = ivf.search_qadc(loaded, queries[:4], r=50, ma=3, keep=0.05, **kw)
        b = ivf.search_qadc(direct, queries[:4], r=50, ma=3, keep=0.05, **kw)
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_opq_search_matches_reference():
    """OPQ rotation of the residuals: the direct path against the JAX one."""
    jindex, queries = _opq_index()
    jd, jl = jivf.search_qadc(jindex, jnp.asarray(queries[:3]), r=50, ma=3, keep=0.05,
                              direct=True, interpret=True, grouped_window=16,
                              block_n=2048)
    td, tl = ivf.search_qadc(to_port(jindex), queries[:3], r=50, ma=3, keep=0.05,
                             direct=True)
    np.testing.assert_allclose(as_np(td), np.asarray(jd), rtol=1e-5)
    np.testing.assert_array_equal(as_np(tl)[:, :10], np.asarray(jl)[:, :10])


def test_load_rejects_other_checkpoints(tmp_path):
    (tmp_path / "manifest.json").write_text('{"format": 1, "type": "ivf_sharded"}')
    with pytest.raises(ValueError):
        load_index(str(tmp_path))
