"""The slice as a whole: train -> build -> save -> load -> search, each
package with its own PRNG, on the same 20,000 x 64-d SIFT-moment vectors.

Trainings differ (another PRNG, another seeding), so the comparison is by
recall@100 against true neighbours: the port's within 0.05 of the JAX
package's, and each Quick-ADC recall within 0.05 of the float-ADC recall on
the same index. The generators are the port's own copies: equal draw for
draw to the JAX package's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.eval import synth as jsynth
from qadc_tpu.eval.recall import recall_at_r as jrecall
from qadc_tpu.index import flat as jflat
from qadc_tpu.index import ivf as jivf
from qadc_tpu.ops.knn import assign_nearest as jassign
from qadc_tpu.ops.knn import exact_knn as jknn
from qadc_tpu.quantizers.opq import train_opq as jtrain_opq
from qadc_tpu_torch.eval import synth
from qadc_tpu_torch.eval.recall import recall_at_r
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.io.checkpoint import load_index, save_index
from qadc_tpu_torch.ops.knn import assign_nearest
from qadc_tpu_torch.quantizers.opq import train_opq

torch.set_num_threads(1)

N, NQ, DIM, PARTS, R, MA, KEEP = 20_000, 64, 64, 64, 100, 8, 0.02
LEARN = 8000


@functools.cache
def _data():
    base, queries = synth.sift_moment_like(np.random.default_rng(0), N, nq=NQ, clusters=256,
                                           dim=DIM)
    gt = assign_nearest(torch.from_numpy(queries), torch.from_numpy(base)).numpy()
    return base, queries, gt


@pytest.mark.parametrize("name", ["sift_moment_like", "gist_moment_like"])
def test_generators_equal_the_reference_draw_for_draw(name):
    kw = dict(nq=7, clusters=16, dim=64 if name.startswith("sift") else 96)
    got = getattr(synth, name)(np.random.default_rng(3), 50, **kw)
    want = getattr(jsynth, name)(np.random.default_rng(3), 50, **kw)
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, b)


def test_ground_truth_matches_reference():
    base, queries, gt = _data()
    _, want = jknn(queries, base, 1)
    np.testing.assert_array_equal(gt, np.asarray(want)[:, 0])


@functools.cache
def _port_recalls(tmp):
    base, queries, gt = _data()
    learn = torch.from_numpy(base[:LEARN])
    out = {}
    opq88 = train_opq(0, learn, 8, 8, opq_iters=3, kmeans_iters=6)
    save_index(f"{tmp}/flat", flat.add(flat.FlatIndex.create(opq88), base))
    f88 = load_index(f"{tmp}/flat", device="cpu")
    out["flat_adc"] = recall_at_r(flat.search_adc(f88, queries, r=R)[1].numpy(), gt)
    coarse = ivf.train_coarse(2, learn, PARTS, iters=10, balance_cap=3.0)
    res = learn - coarse[assign_nearest(learn, coarse).long()]
    r164 = train_opq(4, res, 16, 4, opq_iters=3, kmeans_iters=6)
    save_index(f"{tmp}/ivf", ivf.add(ivf.IVFIndex.create(r164, coarse), base))
    i164 = load_index(f"{tmp}/ivf", device="cpu")
    assert i164.n == N and int(i164.part_sizes.sum()) == N
    out["ivf_qadc"] = recall_at_r(
        ivf.search_qadc(i164, queries, r=R, ma=MA, keep=KEEP)[1].numpy(), gt)
    out["ivf_adc"] = recall_at_r(ivf.search_adc(i164, queries, r=R, ma=MA)[1].numpy(), gt)
    return out


@functools.cache
def _reference_recalls():
    base, queries, gt = _data()
    learn = base[:LEARN]
    out = {}
    opq88 = jtrain_opq(jax.random.PRNGKey(0), learn, 8, 8, opq_iters=3, kmeans_iters=6)
    f88 = jflat.add(jflat.FlatIndex.create(opq88), base)
    out["flat_adc"] = jrecall(np.asarray(
        jflat.search_adc(f88, jnp.asarray(queries), r=R, interpret=True)[1]), gt)
    coarse = jivf.train_coarse(jax.random.PRNGKey(2), learn, PARTS, iters=10, balance_cap=3.0)
    res = learn - np.asarray(coarse)[np.asarray(jassign(learn, coarse))]
    r164 = jtrain_opq(jax.random.PRNGKey(4), res, 16, 4, opq_iters=3, kmeans_iters=6)
    i164 = jivf.add(jivf.IVFIndex.create(r164, coarse), base)
    qj = jnp.asarray(queries)
    out["ivf_qadc"] = jrecall(np.asarray(
        jivf.search_qadc(i164, qj, r=R, ma=MA, keep=KEEP, interpret=True)[1]), gt)
    out["ivf_adc"] = jrecall(np.asarray(
        jivf.search_adc(i164, qj, r=R, ma=MA, interpret=True)[1]), gt)
    return out


@pytest.fixture(scope="module")
def recalls(tmp_path_factory):
    return _port_recalls(str(tmp_path_factory.mktemp("ckpt"))), _reference_recalls()


@pytest.mark.parametrize("path", ["flat_adc", "ivf_qadc", "ivf_adc"])
def test_recall_close_to_reference(recalls, path):
    port, ref = recalls
    assert port[path] >= 0.5, port            # a trained index, not a random one
    assert abs(port[path] - ref[path]) <= 0.05, (path, port, ref)


def test_quick_adc_recall_close_to_float_adc(recalls):
    for got in recalls:
        assert abs(got["ivf_qadc"] - got["ivf_adc"]) <= 0.05, got
