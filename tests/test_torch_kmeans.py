"""ops/kmeans.py and ops/knn.assign_nearest vs the JAX package.

The two packages draw from different PRNGs, so seeding and whole trainings
are held by property (rows of the data, equal seeds, quantization error
within 5%, balance), and everything deterministic given state exactly or to
float32 rounding: assign_nearest equal; a Lloyd step and lloyd_refine from
the same centroids rtol 1e-5 (the port sums each cluster by a one-hot GEMM
at K <= 256 and by index_add_ above, JAX by a scatter-add: another order);
median_split's pair rtol 1e-3 as a set (eight power iterations from another
random start end on the same axis up to sign).
"""

import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.ops.knn import assign_nearest as jassign
from qadc_tpu_torch.core.tensors import as_generator
from qadc_tpu_torch.ops.knn import assign_nearest

# Both packages' ops export the function `kmeans` under the module's name.
jkm = importlib.import_module("qadc_tpu.ops.kmeans")
tkm = importlib.import_module("qadc_tpu_torch.ops.kmeans")

torch.set_num_threads(1)


def _blobs(seed=0, n=3000, dim=12, k=16):
    g = np.random.default_rng(seed)
    centers = g.normal(scale=4.0, size=(k, dim)).astype(np.float32)
    x = (centers[g.integers(0, k, n)] + g.normal(size=(n, dim))).astype(np.float32)
    return x, centers


def _sse(x, centroids):
    d = ((x[:, None, :] - np.asarray(centroids)[None]) ** 2).sum(-1)
    return float(d.min(axis=1).sum())


def _assert_nearest(x, centroids, assign):
    """Every point's assigned centroid is its nearest, to the float32
    rounding of 2 x.c - |c|^2 (relative to the norms, not the distance)."""
    c = np.asarray(centroids, np.float64)
    d = ((x[:, None, :].astype(np.float64) - c[None]) ** 2).sum(-1)
    mine = d[np.arange(len(x)), np.asarray(assign)]
    slack = 1e-5 * ((x.astype(np.float64) ** 2).sum(-1) + (c ** 2).sum(-1).max())
    assert (mine <= d.min(axis=1) + slack).all()


def test_assign_nearest_matches_reference():
    x, centers = _blobs()
    centers[3] = centers[1]          # a duplicated centroid: ties to the lower index
    got = assign_nearest(torch.from_numpy(x), torch.from_numpy(centers))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jassign(x, centers)))
    assert not (got == 3).any()


@pytest.mark.parametrize("k", [16, 300], ids=["onehot", "index_add"])
@pytest.mark.parametrize("iters", [1, 2])
def test_lloyd_refine_matches_reference(k, iters):
    x, _ = _blobs(n=2000)
    start = x[np.random.default_rng(1).choice(len(x), k, replace=False)]
    assert (k <= tkm.ONE_HOT_MAX_K) == (k == 16)
    got = tkm.lloyd_refine(torch.from_numpy(x), torch.from_numpy(start), iters=iters)
    want = jkm.lloyd_refine(jnp.asarray(x), jnp.asarray(start), iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_lloyd_refine_batched_equals_one_by_one():
    xs = np.stack([_blobs(seed=s, n=500, dim=4)[0] for s in range(3)])
    start = xs[:, :8].copy()
    got = tkm.lloyd_refine(torch.from_numpy(xs), torch.from_numpy(start), iters=3)
    for b in range(3):
        one = tkm.lloyd_refine(torch.from_numpy(xs[b]), torch.from_numpy(start[b]), iters=3)
        torch.testing.assert_close(got[b], one, rtol=1e-6, atol=1e-6)


def test_empty_cluster_keeps_its_centroid():
    x, _ = _blobs(n=400, k=4)
    start = np.concatenate([x[:4], np.full((1, x.shape[1]), 1e4, np.float32)])
    got = tkm.lloyd_refine(torch.from_numpy(x), torch.from_numpy(start), iters=2).numpy()
    want = np.asarray(jkm.lloyd_refine(jnp.asarray(x), jnp.asarray(start), iters=2))
    np.testing.assert_array_equal(got[4], start[4])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_plusplus_returns_rows_of_the_data():
    x, _ = _blobs(n=500)
    xt = torch.from_numpy(x)
    a = tkm.kmeans_plusplus_init(7, xt, 20)
    b = tkm.kmeans_plusplus_init(torch.Generator().manual_seed(7), xt, 20)
    c = tkm.kmeans_plusplus_init(8, xt, 20)
    assert a.shape == (20, x.shape[1]) and torch.equal(a, b) and not torch.equal(a, c)
    rows = {r.tobytes() for r in x}
    assert all(r.tobytes() in rows for r in a.numpy())
    assert len({r.tobytes() for r in a.numpy()}) == 20      # D^2 weights: no repeats


def test_plusplus_survives_identical_points():
    """Every remaining distance is 0: the draw falls back to uniform."""
    x = torch.full((50, 3), 2.5)
    got = tkm.kmeans_plusplus_init(0, x, 6)
    assert torch.equal(got, torch.full((6, 3), 2.5))
    want = jkm.kmeans_plusplus_init(jax.random.PRNGKey(0), jnp.asarray(x.numpy()), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_plusplus_batched_draws_each_problem_from_its_own_data():
    xs = np.stack([_blobs(seed=s, n=300, dim=5)[0] + 100.0 * s for s in range(4)])
    got = tkm.kmeans_plusplus_init(3, torch.from_numpy(xs), 9).numpy()
    assert got.shape == (4, 9, 5)
    for b in range(4):
        rows = {r.tobytes() for r in xs[b]}
        assert all(r.tobytes() in rows for r in got[b])


def test_generator_device_must_match_the_data():
    gen = torch.Generator()
    assert tkm.kmeans_plusplus_init(gen, torch.zeros((4, 2)), 2).shape == (2, 2)
    with pytest.raises(ValueError, match="generator is on"):
        as_generator(gen, "meta")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kmeans_sse_close_to_reference(seed):
    """On data without cluster structure the optimum is flat: two seedings
    end within a few percent of each other. (On well separated blobs one
    unlucky seeding costs a whole cluster, in either package.)"""
    x = np.random.default_rng(seed).normal(size=(3000, 8)).astype(np.float32)
    cent, assign = tkm.kmeans(seed, torch.from_numpy(x), 16, iters=15)
    jc, ja = jkm.kmeans(jax.random.PRNGKey(seed), jnp.asarray(x), 16, iters=15)
    assert cent.shape == (16, x.shape[1]) and assign.dtype == torch.int32
    _assert_nearest(x, cent.numpy(), assign.numpy())              # the final assignment
    ours, theirs = _sse(x, cent.numpy()), _sse(x, jc)
    assert abs(ours - theirs) <= 0.05 * theirs, (ours, theirs)


def test_kmeans_default_device_is_the_card():
    """numpy data goes to the card unless the caller names the CPU; with no
    card the copy raises, and nothing falls back."""
    x, _ = _blobs(n=100)
    if torch.cuda.is_available():
        assert tkm.kmeans(0, x, 4, iters=1)[0].device.type == "cuda"
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            tkm.kmeans(0, x, 4, iters=1)
    assert tkm.kmeans(0, x, 4, iters=1, device="cpu")[0].device.type == "cpu"


# An odd count's middle point falls to the half the axis' random sign names
# "left", so the two packages' halves may differ by that one point.
@pytest.mark.parametrize("count,tol", [(8192, 1e-3), (1000, 1e-3), (999, 5e-2)])
def test_median_split_matches_reference(count, tol):
    g = np.random.default_rng(4)
    scale = np.array([9.0, 1.0, 0.5, 0.5, 0.3, 0.3], np.float32)   # one dominant axis
    xs = (g.normal(size=(count, 6)).astype(np.float32) * scale + 3.0).astype(np.float32)
    got = tkm.median_split(0, torch.from_numpy(xs)).numpy()
    want = np.asarray(jkm.median_split(jax.random.PRNGKey(5), jnp.asarray(xs)))
    order = lambda pair: pair[np.argsort(pair[:, 0])]      # noqa: E731 (a set of two)
    np.testing.assert_allclose(order(got), order(want), rtol=tol, atol=tol)
    # Each half holds at most ceil(S / 2) points: the halves' means average
    # to the mean of all with weights n1, n2.
    mu = xs.mean(axis=0)
    w = np.linalg.lstsq(got.T.astype(np.float64), mu.astype(np.float64), rcond=None)[0]
    n1, n2 = w * count
    assert max(n1, n2) <= math.ceil(count / 2) + 0.5, (n1, n2)
    assert abs(n1 + n2 - count) < 1.0


def test_median_split_cuts_an_even_count_between_the_middle_values():
    """jnp.median averages the two middle values (torch.median returns the
    lower): both halves of four points on a line hold two."""
    xs = np.array([[0.0, 0], [1, 0], [10, 0], [11, 0]], np.float32)
    got = tkm.median_split(0, torch.from_numpy(xs)).numpy()
    want = np.asarray(jkm.median_split(jax.random.PRNGKey(0), jnp.asarray(xs)))
    assert sorted(got[:, 0].tolist()) == [0.5, 10.5] == sorted(want[:, 0].tolist())


@pytest.mark.parametrize("settle", [0, 1])
def test_balance_centroids_caps_the_largest_cell(settle):
    g = np.random.default_rng(6)
    ball = g.normal(size=(6000, 8)).astype(np.float32)
    satellite = (g.normal(size=(200, 8)) * 0.1 + 30.0).astype(np.float32)
    x = np.concatenate([ball, satellite])
    k, cap_ratio = 8, 2.0
    start = np.concatenate([x[:2], satellite[:6]])   # six centroids on the satellite
    cap = int(cap_ratio * len(x) / k)
    before = np.bincount(np.asarray(jassign(x, start)), minlength=k)
    assert before.max() > cap
    cent, assign = tkm.balance_centroids(0, torch.from_numpy(x), torch.from_numpy(start),
                                         cap_ratio=cap_ratio, settle_iters=settle,
                                         split_sample=1024)
    assert cent.shape == (k, 8) and assign.dtype == torch.int32
    counts = np.bincount(assign.numpy(), minlength=k)
    if settle == 0:
        assert counts.max() <= cap, counts
    _assert_nearest(x, cent.numpy(), assign.numpy())
    jc, _ = jkm.balance_centroids(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(start),
                                  cap_ratio=cap_ratio, settle_iters=settle, split_sample=1024)
    jcounts = np.bincount(np.asarray(jassign(x, jc)), minlength=k)
    if settle == 0:
        assert jcounts.max() <= cap


def test_balance_centroids_leaves_a_balanced_start_alone():
    x, centers = _blobs(n=1600, k=16)
    start = torch.from_numpy(centers)
    cent, _ = tkm.balance_centroids(0, torch.from_numpy(x), start, cap_ratio=3.0)
    assert torch.equal(cent, start)
