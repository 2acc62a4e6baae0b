"""PQ / OPQ training, encode and decode of the port vs the JAX package.

With JAX-trained codebooks carried across, everything deterministic must
match: encode_indices / encode equal at 4 and 8 bits (a mismatch is allowed
only where a vector's two nearest centroids differ by < 1e-5 relative in
distance, and is counted), decode exact, the 16-bit K-chunked path equal at
K = 65536 with duplicated centroids (ties to the lowest index), and one OPQ
round from the same state (rotation atol 1e-3, orthonormal to 1e-4; the two
SVDs differ in rounding only). Whole trainings use each package's own PRNG
and are held by property: quantization error within 5% of JAX's, OPQ's no
worse than PQ's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qadc_tpu.quantizers import opq as jopq
from qadc_tpu.quantizers import pq as jpq
from qadc_tpu_torch.quantizers import opq, pq

torch.set_num_threads(1)

DIM = 32


def _data(seed=0, n=4000, dim=DIM):
    """Correlated data: a random linear mix of a few latent factors plus noise."""
    g = np.random.default_rng(seed)
    mix = g.normal(size=(8, dim)).astype(np.float32)
    return (g.normal(size=(n, 8)).astype(np.float32) @ mix
            + 0.3 * g.normal(size=(n, dim)).astype(np.float32))


def _port_pq(jq):
    cent = torch.from_numpy(np.asarray(jq.centroids))
    if getattr(jq, "rotation", None) is not None:
        return opq.OPQQuantizer(centroids=cent, sq_bits=jq.sq_bits,
                                rotation=torch.from_numpy(np.asarray(jq.rotation)))
    return pq.ProductQuantizer(centroids=cent, sq_bits=jq.sq_bits)


def _quant_error(x, rotated, recon):
    return float(((np.asarray(rotated) - np.asarray(recon)) ** 2).sum() / len(x))


def _near_tie(jq, rotated, idx_a, idx_b):
    """Where two index sets differ: is the distance gap < 1e-5 relative?"""
    c = np.asarray(jq.centroids, np.float64)
    sub = np.asarray(rotated, np.float64).reshape(len(rotated), c.shape[0], c.shape[2])
    bad = np.argwhere(idx_a != idx_b)
    for n, m in bad:
        da = ((sub[n, m] - c[m, idx_a[n, m]]) ** 2).sum()
        db = ((sub[n, m] - c[m, idx_b[n, m]]) ** 2).sum()
        assert abs(da - db) <= 1e-5 * max(da, db), (n, m, da, db)
    return len(bad)


@pytest.mark.parametrize("m,bits", [(16, 4), (8, 8), (4, 8)])
@pytest.mark.parametrize("kind", ["pq", "opq"])
def test_encode_and_decode_match_reference(m, bits, kind):
    x = _data()
    if kind == "pq":
        jq = jpq.train_pq(jax.random.PRNGKey(0), x[:2000], m, bits, iters=4)
    else:
        jq = jopq.train_opq(jax.random.PRNGKey(0), x[:2000], m, bits, opq_iters=2,
                            kmeans_iters=3)
    tq = _port_pq(jq).validate()
    assert (tq.sq_count, tq.sq_dim, tq.dim, tq.code_size) == (
        jq.sq_count, jq.sq_dim, jq.dim, jq.code_size)
    xt = torch.from_numpy(x)
    want_idx = np.asarray(jpq.encode_indices(jq, x))
    got_idx = pq.encode_indices(tq, xt)
    assert got_idx.dtype == torch.int32 and got_idx.shape == (len(x), m)
    mismatches = _near_tie(jq, jq.rotate(x), got_idx.numpy(), want_idx)
    assert mismatches <= 2, mismatches
    codes = pq.encode(tq, xt)
    want_codes = np.asarray(jpq.encode(jq, x))
    assert codes.dtype == torch.uint8 and codes.shape == want_codes.shape
    assert (codes.numpy() != want_codes).any(axis=1).sum() <= mismatches
    np.testing.assert_array_equal(pq.decode(tq, torch.from_numpy(want_codes)).numpy(),
                                  np.asarray(jpq.decode(jq, want_codes)))
    np.testing.assert_allclose(tq.unrotate(tq.rotate(xt)).numpy(), x, atol=1e-3)
    np.testing.assert_allclose(tq.rotate(xt).numpy(), np.asarray(jq.rotate(x)),
                               rtol=1e-5, atol=1e-5)


def test_encode_16bit_chunked_path_matches_reference():
    """K = 65536 runs in 16 chunks of 4096; centroid 50000 duplicates centroid
    7 and 4100 duplicates 4099 (across and inside chunks): ties to the lowest."""
    g = np.random.default_rng(1)
    cent = g.normal(size=(2, 1 << 16, 2)).astype(np.float32)
    cent[:, 50000] = cent[:, 7]
    cent[:, 4100] = cent[:, 4099]
    x = g.normal(size=(300, 4)).astype(np.float32)
    x[:50, :2] = cent[0, 7] + 1e-3                  # nearest: the duplicated pair
    x[50:100, 2:] = cent[1, 4099] - 1e-3
    jq = jpq.ProductQuantizer(centroids=jnp.asarray(cent), sq_bits=16)
    tq = pq.ProductQuantizer(centroids=torch.from_numpy(cent), sq_bits=16).validate()
    assert cent.shape[1] > pq.ENCODE_K_CHUNK == jpq.ENCODE_K_CHUNK
    want = np.asarray(jpq.encode_indices(jq, x))
    got = pq.encode_indices(tq, torch.from_numpy(x)).numpy()
    assert _near_tie(jq, x, got, want) == 0
    assert (got[:50, 0] == 7).all() and (got[50:100, 1] == 4099).all()
    np.testing.assert_array_equal(pq.encode(tq, torch.from_numpy(x)).numpy(),
                                  np.asarray(jpq.encode(jq, x)))
    np.testing.assert_array_equal(
        pq.decode(tq, pq.encode(tq, torch.from_numpy(x))).numpy(),
        np.asarray(jpq.decode(jq, jpq.encode(jq, x))))


@pytest.mark.parametrize("m,bits", [(8, 4), (4, 8)])
def test_one_opq_round_matches_reference(m, bits):
    """JAX's train_opq at opq_iters 0 and 1 from one key brackets exactly one
    alternation: the port's opq_round is stepped from the first state."""
    x = _data(n=3000)
    key, iters = jax.random.PRNGKey(3), 4
    rot0, _ = np.linalg.qr(np.random.default_rng(2).normal(size=(DIM, DIM)))
    rot0 = rot0.astype(np.float32)
    before = jopq.train_opq(key, x, m, bits, opq_iters=0, kmeans_iters=iters,
                            init_rotation=rot0)
    after = jopq.train_opq(key, x, m, bits, opq_iters=1, kmeans_iters=iters,
                           init_rotation=rot0)
    np.testing.assert_array_equal(np.asarray(before.rotation), rot0)
    rot, cent = opq.opq_round(torch.from_numpy(x), torch.from_numpy(rot0),
                              torch.from_numpy(np.asarray(before.centroids)), bits, iters)
    np.testing.assert_allclose(rot.numpy(), np.asarray(after.rotation), atol=1e-3)
    np.testing.assert_allclose((rot @ rot.T).numpy(), np.eye(DIM), atol=1e-4)
    np.testing.assert_allclose(cent.numpy(), np.asarray(after.centroids), rtol=1e-2, atol=1e-2)


@pytest.mark.parametrize("m,bits", [(8, 4), (4, 8)])
def test_training_error_close_to_reference(m, bits):
    x = _data(seed=4, n=3000)
    xt = torch.from_numpy(x)
    errs = {}
    for name, jq, tq in (
        ("pq", jpq.train_pq(jax.random.PRNGKey(0), x, m, bits, iters=8),
         pq.train_pq(0, xt, m, bits, iters=8)),
        ("opq", jopq.train_opq(jax.random.PRNGKey(0), x, m, bits, opq_iters=4, kmeans_iters=4),
         opq.train_opq(0, xt, m, bits, opq_iters=4, kmeans_iters=4)),
    ):
        tq.validate()
        assert tq.centroids.shape == (m, 1 << bits, DIM // m) and tq.sq_bits == bits
        je = _quant_error(x, jq.rotate(x), jpq.decode(jq, jpq.encode(jq, x)))
        te = _quant_error(x, tq.rotate(xt), pq.decode(tq, pq.encode(tq, xt)))
        assert abs(te - je) <= 0.05 * je, (name, te, je)
        errs[name] = te
    assert errs["opq"] <= errs["pq"] * 1.001, errs
    rot = opq.train_opq(0, xt, m, bits, opq_iters=1, kmeans_iters=2).rotation
    np.testing.assert_allclose((rot @ rot.T).numpy(), np.eye(DIM), atol=1e-4)


def test_opq_error_matches_reference_at_sift_width(capsys):
    """8x8 OPQ at the bench's settings (opq_iters 6, kmeans_iters 12) on
    10,000 SIFT-like 128-d vectors: the two packages' quantization errors,
    on the learn set and on 10,000 held-out vectors, agree to 1% (run with
    -s to see them)."""
    from qadc_tpu_torch.eval.synth import sift_moment_like

    base, _ = sift_moment_like(np.random.default_rng(7), 20_000, nq=8)
    learn, held = base[:10_000], base[10_000:]
    jq = jopq.train_opq(jax.random.PRNGKey(0), learn, 8, 8, opq_iters=6, kmeans_iters=12)
    tq = opq.train_opq(0, torch.from_numpy(learn), 8, 8, opq_iters=6, kmeans_iters=12)
    for name, x in (("learn", learn), ("held-out", held)):
        xt = torch.from_numpy(x)
        je = _quant_error(x, jq.rotate(x), jpq.decode(jq, jpq.encode(jq, x)))
        te = _quant_error(x, tq.rotate(xt), pq.decode(tq, pq.encode(tq, xt)))
        with capsys.disabled():
            print(f"\n8x8 OPQ quantization error, {name}: reference {je:.1f}, port {te:.1f}")
        assert abs(te - je) <= 0.01 * je, (name, te, je)


def test_train_opq_takes_an_initial_rotation_and_a_generator():
    x = torch.from_numpy(_data(n=600))
    rot0, _ = np.linalg.qr(np.random.default_rng(5).normal(size=(DIM, DIM)))
    gen = torch.Generator().manual_seed(1)
    a = opq.train_opq(gen, x, 4, 4, opq_iters=0, kmeans_iters=2,
                      init_rotation=rot0.astype(np.float32))
    np.testing.assert_array_equal(a.rotation.numpy(), rot0.astype(np.float32))
    b = opq.train_opq(1, x, 4, 4, opq_iters=0, kmeans_iters=2,
                      init_rotation=torch.from_numpy(rot0.astype(np.float32)))
    assert torch.equal(a.centroids, b.centroids)        # equal seeds, equal training


def test_bad_geometry_raises():
    x = torch.from_numpy(_data(n=100))
    with pytest.raises(ValueError, match="not divisible"):
        pq.train_pq(0, x, 5, 4)
    with pytest.raises(ValueError, match="not divisible"):
        opq.train_opq(0, x, 5, 4)
    with pytest.raises(ValueError, match="not divisible"):
        jpq.train_pq(jax.random.PRNGKey(0), x.numpy(), 5, 4)
    cent = torch.zeros((4, 16, 8))
    with pytest.raises(ValueError, match="sq_bits"):
        pq.ProductQuantizer(centroids=cent, sq_bits=5).validate()
    with pytest.raises(ValueError, match="centroid count"):
        pq.ProductQuantizer(centroids=cent, sq_bits=8).validate()
    with pytest.raises(ValueError, match="multiple of 8"):
        pq.ProductQuantizer(centroids=torch.zeros((3, 16, 8)), sq_bits=4).validate()
    with pytest.raises(ValueError, match="rotation shape"):
        opq.OPQQuantizer(centroids=cent, sq_bits=4, rotation=torch.eye(8)).validate()


def test_training_defaults_to_the_card():
    """numpy data goes to the card unless the caller names the CPU."""
    x = _data(n=200)
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            pq.train_pq(0, x, 4, 4, iters=1)
    assert pq.train_pq(0, x, 4, 4, iters=1, device="cpu").centroids.device.type == "cpu"
    assert opq.train_opq(0, x, 4, 4, opq_iters=1, kmeans_iters=1,
                         device="cpu").rotation.device.type == "cpu"
