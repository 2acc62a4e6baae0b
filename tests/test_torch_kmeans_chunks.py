"""The chunked assignment and Lloyd update of ops/kmeans.py and the chunked
16-bit encode, against the same code unchunked.

The chunks only bound what a step holds, so every result is held bit for
bit (torch.equal) to the unchunked run: one chunk of everything, under a
budget that fits. Budgets of a few score entries force many chunks of
vectors and of centroids. Ties are planted: duplicated centroids, one of
them in a later chunk, and points halfway between two centroids, whose
scores are equal in float32; the lower centroid must win.

A small 16-bit train_pq (K = 65,536 on the CPU) is held to the properties
tests/test_16bit.py holds the JAX package's 16-bit PQ to: vectors in the
codebook decode almost exactly (relative error < 1e-6), and flat (recall
> 0.9) and IVF (> 0.7) search_adc find near-duplicate queries.
"""

import importlib

import numpy as np
import pytest
import torch

from qadc_tpu_torch.eval.recall import recall_at_r
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.ops.knn import exact_knn
from qadc_tpu_torch.quantizers import pq
from torch_threads import pin_one_thread

# qadc_tpu_torch.ops exports the function `kmeans` under the module's name.
tkm = importlib.import_module("qadc_tpu_torch.ops.kmeans")

pin_one_thread()

BIG = 1 << 40  # a budget under which nothing is chunked


def _entries(b, per):
    """The budget that leaves `per` score entries a chunk of B sub-spaces."""
    return 8 * b * per


def _budget(monkeypatch, nbytes):
    """Every chunked step of k-means and the encode sees `nbytes` of scratch."""
    for mod in (tkm, pq):
        monkeypatch.setattr(mod, "scratch_budget", lambda device: nbytes)


def _tied(k, b=3, n=90, dim=4, seed=0):
    """(B, N, dim) data and (B, K, dim) centroids with planted ties: centroid
    k - 1 duplicates centroid 1, and every fifth point sits halfway between
    centroids 2 and 3, placed symmetrically about 0 (equal scores exactly)."""
    g = np.random.default_rng(seed)
    c = g.normal(size=(b, k, dim)).astype(np.float32)
    c[:, k - 1] = c[:, 1]
    c[:, 3] = -c[:, 2]
    x = g.normal(size=(b, n, dim)).astype(np.float32)
    x[:, ::5] = 0.0
    x[:, 1::7] = c[:, 1][:, None]           # on the duplicated centroid
    return torch.from_numpy(x), torch.from_numpy(c)


@pytest.mark.parametrize("k", [16, 300])
@pytest.mark.parametrize("per", [1, 5, 37, 16 * 11])
def test_assign_chunks_equal_unchunked(monkeypatch, k, per):
    x, c = _tied(k)
    _budget(monkeypatch, BIG)
    want = tkm._assign(x, c)
    _budget(monkeypatch, _entries(3, per))
    got = tkm._assign(x, c)
    assert torch.equal(got, want)
    # The planted ties: the lower of two equal centroids.
    assert bool((want[:, 1::7] == 1).all())
    tie = (x[:, ::5] == 0).all(-1)
    assert not bool((want[:, ::5][tie] == 3).any())


@pytest.mark.parametrize("k", [16, 300])
@pytest.mark.parametrize("per", [1, 5, 37, 16 * 11])
def test_lloyd_step_chunks_equal_unchunked(monkeypatch, k, per):
    x, c = _tied(k, seed=1)
    _budget(monkeypatch, BIG)
    want = tkm._lloyd_step(x, c)
    _budget(monkeypatch, _entries(3, per))
    assert torch.equal(tkm._lloyd_step(x, c), want)


@pytest.mark.parametrize("k", [16, 300])
def test_kmeans_chunks_equal_unchunked(monkeypatch, k):
    g = np.random.default_rng(2)
    x = torch.from_numpy(g.normal(size=(2, 700, 6)).astype(np.float32))
    _budget(monkeypatch, BIG)
    want = tkm.kmeans(5, x, k, iters=3)
    _budget(monkeypatch, _entries(2, 23))
    got = tkm.kmeans(5, x, k, iters=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_balance_chunks_equal_unchunked(monkeypatch):
    g = np.random.default_rng(3)
    x = torch.from_numpy(np.concatenate([g.normal(size=(900, 5)),
                                         g.normal(size=(100, 5)) + 6]).astype(np.float32))
    start = x[:8].clone()
    _budget(monkeypatch, BIG)
    want = tkm.balance_centroids(4, x, start, cap_ratio=2.0)
    _budget(monkeypatch, _entries(1, 7))
    got = tkm.balance_centroids(4, x, start, cap_ratio=2.0)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("b,n,k,per", [(1, 10, 16, 1000), (8, 262144, 65536, 10 ** 9),
                                       (3, 300, 300, 37), (2, 5, 7, 1)])
def test_chunk_shape_fits_the_budget(b, n, k, per):
    nc, kc = tkm._chunk_shape(b, n, k, _entries(b, per))
    assert 1 <= nc <= n and 1 <= kc <= k
    assert nc * kc <= max(per, 1)
    assert kc == k or nc == 1          # whole K first, then fewer vectors


def test_encode_16bit_row_chunks_equal_unchunked(monkeypatch):
    g = np.random.default_rng(4)
    cent = g.normal(size=(2, 1 << 16, 2)).astype(np.float32)
    cent[:, 50000] = cent[:, 7]                          # a tie across K chunks
    q = pq.ProductQuantizer(centroids=torch.from_numpy(cent), sq_bits=16).validate()
    x = torch.from_numpy(g.normal(size=(37, 4)).astype(np.float32))
    x[3] = torch.from_numpy(cent[:, 7].reshape(-1))
    _budget(monkeypatch, BIG)
    want = pq.encode_indices(q, x)
    _budget(monkeypatch, 8 * 2 * 4096 * 5)   # 5 vectors a chunk
    got = pq.encode_indices(q, x)
    assert torch.equal(got, want) and want[3].tolist() == [7, 7]


@pytest.fixture(scope="module")
def pq16():
    """A 16-bit PQ trained on 600 vectors (m = 2, dim 8; fewer vectors than
    centroids, so every vector becomes a centroid), in a budget that chunks."""
    g = np.random.default_rng(5)
    base = g.normal(size=(600, 8)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _budget(mp, 64 << 20)
        q = pq.train_pq(0, torch.from_numpy(base), 2, 16, iters=2)
    return q, base, g


def test_train_pq_16bit_roundtrip(pq16):
    q, base, _ = pq16
    assert q.centroids.shape == (2, 1 << 16, 4) and q.sq_centroid_count == 1 << 16
    codes = pq.encode(q, torch.from_numpy(base))
    assert codes.shape == (600, 4)
    recon = pq.decode(q, codes).numpy()
    assert np.mean((recon - base) ** 2) / np.mean(base ** 2) < 1e-6


def test_train_pq_16bit_flat_and_ivf_search(pq16):
    q, base, g = pq16
    queries = base[:10] + 0.001 * g.normal(size=(10, 8)).astype(np.float32)
    tb, tq = torch.from_numpy(base), torch.from_numpy(queries)
    _, gt = exact_knn(tq, tb, 1)
    index = flat.add(flat.FlatIndex.create(q), tb)
    _, labels = flat.search_adc(index, tq, r=10)
    assert recall_at_r(labels.numpy(), gt.numpy()) > 0.9
    coarse = ivf.train_coarse(0, tb[:400], 8, iters=5)
    index = ivf.add(ivf.IVFIndex.create(q, coarse), tb)
    _, labels = ivf.search_adc(index, tq, r=20, ma=4)
    assert recall_at_r(labels.numpy(), gt.numpy()) > 0.7
