"""Product quantizer: codebooks, training, encode and decode (counterpart of
qadc_tpu/quantizers/pq.py).

Codebooks are (sq_count, 2^sq_bits, dim / sq_count). Training is k-means per
sub-space, all sub-spaces as one batch (ops/kmeans.py); encoding assigns
each sub-vector to its nearest centroid, ties to the lowest index, and packs
the indices at 4, 8 or 16 bits (core/packing.py).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from qadc_tpu_torch.core.packing import SUPPORTED_BITS, code_bytes, pack_codes, unpack_codes
from qadc_tpu_torch.core.tensors import DEFAULT_DEVICE, as_f32, full_f32_matmul, scratch_budget
from qadc_tpu_torch.ops.kmeans import DEFAULT_ITERS, kmeans


@dataclasses.dataclass(frozen=True)
class ProductQuantizer:
    """PQ codebooks.

    Attributes:
      centroids: (M, K, dsq) float32, K = 2^sq_bits, dim = M * dsq.
      sq_bits: bits per sub-quantizer.
    """

    centroids: torch.Tensor
    sq_bits: int

    @property
    def sq_count(self) -> int:
        return self.centroids.shape[0]

    @property
    def sq_centroid_count(self) -> int:
        return self.centroids.shape[1]

    @property
    def sq_dim(self) -> int:
        return self.centroids.shape[2]

    @property
    def dim(self) -> int:
        return self.sq_count * self.sq_dim

    @property
    def code_size(self) -> int:
        return code_bytes(self.sq_count, self.sq_bits)

    def validate(self) -> "ProductQuantizer":
        """Raise ValueError unless sq_bits is supported, the codebooks hold
        2^sq_bits centroids and the code fills whole bytes."""
        if self.sq_bits not in SUPPORTED_BITS:
            raise ValueError(f"sq_bits must be in {SUPPORTED_BITS}")
        if self.centroids.shape[1] != (1 << self.sq_bits):
            raise ValueError(f"centroid count {self.centroids.shape[1]} != 2^{self.sq_bits}")
        code_bytes(self.sq_count, self.sq_bits)
        return self

    def rotate(self, vectors: torch.Tensor) -> torch.Tensor:
        """Identity for plain PQ (OPQ overrides)."""
        return vectors

    def unrotate(self, vectors: torch.Tensor) -> torch.Tensor:
        """Identity for plain PQ (OPQ overrides)."""
        return vectors


def train_pq(generator, x, sq_count: int, sq_bits: int, iters: int = DEFAULT_ITERS,
             device=DEFAULT_DEVICE) -> ProductQuantizer:
    """Train a PQ by k-means in each sub-space.

    Args:
      generator: torch.Generator on the data's device, or an int seed.
      x: (N, dim) float32 training vectors (residuals for an IVF index): a
        tensor stays on its device, numpy goes to `device`.
      sq_count, sq_bits: sub-quantizer count M and bits per sub-quantizer.
      iters: Lloyd iterations.

    Returns a ProductQuantizer on the data's device.
    """
    x = as_f32(x, device)
    n, dim = x.shape
    if dim % sq_count != 0:
        raise ValueError(f"dim {dim} not divisible by sq_count {sq_count}")
    subspaces = x.reshape(n, sq_count, dim // sq_count).transpose(0, 1).contiguous()
    centroids, _ = kmeans(generator, subspaces, 1 << sq_bits, iters)
    return ProductQuantizer(centroids=centroids, sq_bits=sq_bits).validate()


# Centroids scored at a time by a wide-codebook encode: at K <= ENCODE_K_CHUNK
# (4- and 8-bit codebooks) one (N, M, K) float32 distance tensor is built; a
# 16-bit codebook (K = 65536) runs as a loop over K chunks with a running
# (best distance, best index), over chunks of vectors whose two
# (n, M, ENCODE_K_CHUNK) float32 transients fit core/tensors.scratch_budget.
ENCODE_K_CHUNK = 4096


def encode_indices(pq: ProductQuantizer, vectors: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid index in each sub-space, (N, M) int32, after the
    quantizer's rotation.

    Ties go to the lowest centroid index: torch.argmin returns the first
    minimum, and the chunked path replaces its running best only on a
    strictly smaller distance, so an earlier chunk keeps a tie.
    """
    v = pq.rotate(vectors.to(torch.float32))
    sub = v.reshape(v.shape[0], pq.sq_count, pq.sq_dim)
    c = pq.centroids
    k = c.shape[1]

    def dists(xs, cc):  # (n, M, dsq), (M, kc, dsq) -> (n, M, kc): ||c||^2 - 2 x.c
        with full_f32_matmul():
            cross = torch.einsum("nmd,mkd->nmk", xs, cc)
        return torch.sum(cc * cc, dim=-1)[None] - 2.0 * cross

    if k <= ENCODE_K_CHUNK:
        return torch.argmin(dists(sub, c), dim=-1).to(torch.int32)
    kc = math.gcd(k, ENCODE_K_CHUNK)
    nc = max(1, scratch_budget(sub.device) // (8 * pq.sq_count * kc))
    return torch.cat([_encode_wide(dists, sub[s:s + nc], c, kc)
                      for s in range(0, sub.shape[0], nc)])


def _encode_wide(dists, sub: torch.Tensor, c: torch.Tensor, kc: int) -> torch.Tensor:
    """encode_indices of a wide codebook over chunks of kc centroids."""
    bd = torch.full(sub.shape[:2], torch.inf, dtype=torch.float32, device=sub.device)
    bi = torch.zeros(sub.shape[:2], dtype=torch.int32, device=sub.device)
    for off in range(0, c.shape[1], kc):
        d = dists(sub, c[:, off:off + kc])
        i = torch.argmin(d, dim=-1)
        dm = torch.gather(d, 2, i[..., None])[..., 0]
        upd = dm < bd
        bd = torch.where(upd, dm, bd)
        bi = torch.where(upd, (i + off).to(torch.int32), bi)
    return bi


def encode(pq: ProductQuantizer, vectors: torch.Tensor) -> torch.Tensor:
    """Encode vectors to packed codes (N, code_size) uint8."""
    return pack_codes(encode_indices(pq, vectors), pq.sq_bits)


def decode(pq: ProductQuantizer, codes: torch.Tensor) -> torch.Tensor:
    """Reconstruct (N, dim) float32 vectors from packed codes, in the
    rotated space (the rotation is not undone: tables are computed against
    rotated residuals)."""
    return decode_rows(pq, unpack_codes(codes, pq.sq_count, pq.sq_bits))


def decode_rows(pq: ProductQuantizer, idx: torch.Tensor) -> torch.Tensor:
    """PQ reconstruction of centroid indices (the JAX package's
    index/flat.py:decode_rows; the flat index re-exports it).

    Args:
      idx: (..., M) integer centroid indices.

    Returns:
      (..., dim) float32: the M sub-quantizers' centroids, concatenated.
    """
    m, _, dsq = pq.centroids.shape
    sq = torch.arange(m, device=idx.device)
    return pq.centroids[sq, idx.long()].reshape(*idx.shape[:-1], m * dsq)
