"""k-means: k-means++ seeding and Lloyd iterations (counterpart of
qadc_tpu/ops/kmeans.py).

Assignment is a GEMM and an argmax, the update a segment sum. Empty clusters
keep their previous centroid. Every function also takes a leading batch of
independent problems ((B, N, dim) data, (B, K, dim) centroids): train_pq runs
its M sub-spaces as one batch, where the JAX package maps over them, so the
k - 1 dependent draws of k-means++ cost k - 1 rounds of a few launches, not
M times as many.

Randomness comes from an explicit torch.Generator on the data's device (or
an int that seeds one) where the JAX package takes a key. One seed gives
different streams on the CPU and on CUDA, and neither gives JAX's: results
are held to the JAX package by property (quantization error, balance), and
step by step from a given state.

Assignment walks the data in chunks of vectors, and of centroids where a
chunk's scores against all K would not fit (16-bit codebooks, K = 65,536),
sized by core/tensors.scratch_budget; the result is the unchunked one.

Segment sums: at K <= ONE_HOT_MAX_K the update is a one-hot GEMM in full
float32, whose result does not change from run to run; above it (16-bit
codebooks) it is index_add_, whose float sum order on CUDA does. Either way
the sums agree with the JAX package's scatter-add to float32 rounding of a
sum in another order (rtol 1e-5 in the tests).
"""

from __future__ import annotations

import torch

from qadc_tpu_torch.core.tensors import (DEFAULT_DEVICE, as_f32, as_generator,
                                         full_f32_matmul, scratch_budget, to_f32)
from qadc_tpu_torch.ops.knn import _neg_scores

DEFAULT_ITERS = 50  # reference kmeans_iter_max (databases.cpp:92): 2 cv + 48 Lloyd
# Largest K whose Lloyd update runs as a one-hot GEMM ((B, N, K) float32).
ONE_HOT_MAX_K = 256


def _chunk_shape(b: int, n: int, k: int, budget: int) -> tuple[int, int]:
    """(vectors, centroids) of one assignment chunk: its (B, n, k) float32
    scores and their one temporary take at most `budget` bytes where one
    vector against one centroid allows it. Whole K first, then fewer
    vectors, then fewer centroids."""
    per = max(1, budget // (8 * b))        # score entries a chunk
    kc = min(k, per)
    return max(1, min(n, per // kc)), kc


def _assign(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(B, N) int64 nearest centroid of (B, N, dim) data among (B, K, dim)
    centroids (or (N,) of (N, dim) among (K, dim)); ties to the lower index.

    The data is walked in chunks of vectors and, where one chunk's scores
    against all K would pass the budget (core/tensors.scratch_budget), of
    centroids. Each score is computed as the unchunked product computes it,
    and a later chunk of centroids replaces the running best only on a
    strictly larger score, so the result is the unchunked argmax's (first
    maximum) whatever the chunks.
    """
    if x.dim() == 2:
        return _assign(x[None], c[None])[0]
    b, n, _ = x.shape
    k = c.shape[1]
    nc, kc = _chunk_shape(b, n, k, scratch_budget(x.device))
    out = torch.empty((b, n), dtype=torch.int64, device=x.device)
    for s in range(0, n, nc):
        xs = x[:, s:s + nc]
        best = arg = None
        for o in range(0, k, kc):
            sc = _neg_scores(xs, c[:, o:o + kc])
            i = torch.argmax(sc, dim=-1)
            v = torch.gather(sc, 2, i[..., None])[..., 0]
            if best is None:
                best, arg = v, i
            else:
                upd = v > best
                best = torch.where(upd, v, best)
                arg = torch.where(upd, i + o, arg)
        out[:, s:s + nc] = arg
    return out


def _lloyd_step(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """One Lloyd update of (B, K, dim) centroids over (B, N, dim) data.

    At K <= ONE_HOT_MAX_K the sums are one one-hot GEMM over all N (a
    chunked sum would add in another order; the one-hot takes 1 KiB a
    vector and sub-space at most). Above it each chunk of vectors is
    assigned and index_add_-ed in turn: every cluster receives its vectors
    in the same order as unchunked, so the CPU's sequential sums are the
    same bit for bit (on CUDA index_add_'s order varies from run to run
    either way).
    """
    b, n, _ = x.shape
    k = c.shape[1]
    if k <= ONE_HOT_MAX_K:
        assign = _assign(x, c)
        onehot = torch.zeros((b, n, k), dtype=torch.float32, device=x.device)
        onehot.scatter_(2, assign[..., None], 1.0)
        counts = onehot.sum(dim=1)
        with full_f32_matmul():
            sums = torch.bmm(onehot.transpose(1, 2), x)
    else:
        nc = _chunk_shape(b, n, k, scratch_budget(x.device))[0]
        offset = torch.arange(b, device=x.device)[:, None] * k
        counts = torch.zeros(b * k, dtype=torch.float32, device=x.device)
        sums = torch.zeros((b * k, x.shape[2]), dtype=torch.float32, device=x.device)
        for s in range(0, n, nc):
            xs = x[:, s:s + nc]
            flat = (_assign(xs, c) + offset).reshape(-1)
            counts.index_add_(0, flat, torch.ones(flat.shape[0], dtype=torch.float32,
                                                  device=x.device))
            sums.index_add_(0, flat, xs.reshape(-1, x.shape[2]))
        counts, sums = counts.reshape(b, k), sums.reshape(b, k, -1)
    new = sums / torch.clamp(counts, min=1.0)[..., None]
    return torch.where(counts[..., None] > 0, new, c)


def _batched(x: torch.Tensor) -> tuple[torch.Tensor, bool]:
    """(B, N, dim) view of (N, dim) or (B, N, dim) data, and whether a batch
    axis was added."""
    if x.dim() == 2:
        return x[None], True
    if x.dim() != 3:
        raise ValueError(f"data must be (N, dim) or (B, N, dim), got {tuple(x.shape)}")
    return x, False


def kmeans_plusplus_init(generator, x, k: int, device=DEFAULT_DEVICE) -> torch.Tensor:
    """k-means++ seeding: the first centroid uniform, each next one drawn in
    proportion to the squared distance to the nearest chosen so far (uniform
    when every remaining distance is 0).

    Args:
      generator: torch.Generator on the data's device, or an int seed.
      x: (N, dim) data, or (B, N, dim) for B independent problems.
      k: number of centroids.
      device: where numpy data goes (a tensor stays on its own device).

    Returns:
      (k, dim) float32 rows of x, or (B, k, dim).
    """
    xb, squeeze = _batched(as_f32(x, device))
    gen = as_generator(generator, xb.device)
    b, n, _ = xb.shape
    rows = torch.arange(b, device=xb.device)
    x2 = torch.sum(xb * xb, dim=-1)

    def sqdist_to(c):  # (B, dim) -> (B, N)
        with full_f32_matmul():
            cross = torch.bmm(xb, c[:, :, None])[..., 0]
        return torch.clamp(x2 - 2.0 * cross + torch.sum(c * c, dim=-1)[:, None], min=0.0)

    first = xb[rows, torch.randint(0, n, (b,), generator=gen, device=xb.device)]
    out = [first]
    min_d2 = sqdist_to(first)
    for _ in range(k - 1):
        # torch.multinomial raises on an all-zero row: fall back to uniform.
        live = torch.sum(min_d2, dim=1, keepdim=True) > 0
        idx = torch.multinomial(torch.where(live, min_d2, 1.0), 1, generator=gen)[:, 0]
        c = xb[rows, idx]
        min_d2 = torch.minimum(min_d2, sqdist_to(c))
        out.append(c)
    cent = torch.stack(out, dim=1)
    return cent[0] if squeeze else cent


def lloyd_refine(x, centroids, iters: int = 2, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Lloyd iterations from given centroids (no seeding); empty clusters
    keep their previous centroid. (N, dim) and (K, dim), or batched."""
    xb, squeeze = _batched(as_f32(x, device))
    c = to_f32(centroids, xb.device)
    c = c[None] if squeeze else c
    for _ in range(iters):
        c = _lloyd_step(xb, c)
    return c[0] if squeeze else c


def kmeans(generator, x, k: int, iters: int = DEFAULT_ITERS, device=DEFAULT_DEVICE):
    """Full k-means: k-means++ seeding, then `iters` Lloyd iterations.

    Args as kmeans_plusplus_init.

    Returns:
      (centroids (k, dim) float32, assignments (N,) int32), or batched.
    """
    xb, squeeze = _batched(as_f32(x, device))
    c = lloyd_refine(xb, kmeans_plusplus_init(generator, xb, k), iters)
    assign = _assign(xb, c).to(torch.int32)
    return (c[0], assign[0]) if squeeze else (c, assign)


def median_split(generator, xs, device=DEFAULT_DEVICE) -> torch.Tensor:
    """Means of the two balanced halves of a median cut on the principal
    axis (8 power iterations from a random start): each side holds at most
    ceil(S / 2) points.

    The cut is at the average of the two middle projections when S is even,
    as jnp.median cuts (torch.median would return the lower one).

    Returns (2, dim) float32.
    """
    xs = as_f32(xs, device)
    gen = as_generator(generator, xs.device)
    xc = xs - xs.mean(dim=0)
    v = torch.randn(xs.shape[1], generator=gen, device=xs.device, dtype=torch.float32)
    with full_f32_matmul():
        for _ in range(8):
            w = xc.T @ (xc @ v)
            v = w / torch.clamp(torch.linalg.norm(w), min=1e-30)
        t = xc @ v
    s = torch.sort(t).values
    med = 0.5 * (s[(s.shape[0] - 1) // 2] + s[s.shape[0] // 2])
    left = t <= med
    nl = left.sum()
    c1 = torch.where(left[:, None], xs, 0.0).sum(dim=0) / torch.clamp(nl, min=1)
    c2 = torch.where(left[:, None], 0.0, xs).sum(dim=0) / torch.clamp(left.numel() - nl, min=1)
    return torch.stack([c1, c2])


def balance_centroids(generator, x, centroids, cap_ratio: float = 3.0, max_rounds: int = 64,
                      settle_iters: int = 0, split_sample: int = 8192,
                      device=DEFAULT_DEVICE):
    """Bound the largest cell at cap_ratio x the mean, keeping K fixed.

    Every IVF partition is padded to the largest, so one oversized cell
    inflates storage, the scans' output width and the screens for the whole
    index. Each round: assign x; if the largest cell is within the cap,
    done. Otherwise split it by median_split over at most split_sample of
    its members (drawn without replacement; a smaller cell is cycled to that
    count) into two centroids, one of which replaces the smallest cell's
    centroid. settle_iters Lloyd iterations after a split default to 0:
    Lloyd moves back towards the skewed optimum. The loop reads the cell
    counts back each round: a synchronisation a round, at build time only.

    Returns (centroids (K, dim) float32, assignments (N,) int32 of x).
    """
    x = as_f32(x, device)
    gen = as_generator(generator, x.device)
    cent = to_f32(centroids, x.device).clone()
    n, k = x.shape[0], cent.shape[0]
    cap = max(1, int(cap_ratio * n / k))
    assign = _assign(x, cent)
    for _ in range(max_rounds):
        counts = torch.bincount(assign, minlength=k)
        big, small = int(counts.argmax()), int(counts.argmin())
        if int(counts[big]) <= cap or small == big:
            break
        members = torch.nonzero(assign == big)[:, 0]
        if members.numel() > split_sample:
            pick = torch.randperm(members.numel(), generator=gen, device=x.device)
            members = members[pick[:split_sample]]
        else:  # cycle the members to the fixed sample size, as the reference does
            members = members[torch.arange(split_sample, device=x.device) % members.numel()]
        two = median_split(gen, x[members])
        cent[big], cent[small] = two[0], two[1]
        if settle_iters:
            cent = lloyd_refine(x, cent, iters=settle_iters)
        assign = _assign(x, cent)
    return cent, assign.to(torch.int32)
