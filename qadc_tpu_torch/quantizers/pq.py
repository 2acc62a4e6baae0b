"""Product quantizer state (counterpart of qadc_tpu/quantizers/pq.py).

Search only: codebooks, geometry and reconstruction; no training or encoding.
"""

from __future__ import annotations

import dataclasses

import torch


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
    def code_size(self) -> int:
        if (self.sq_count * self.sq_bits) % 8 != 0:
            raise ValueError(
                f"sq_count*sq_bits must be a multiple of 8 "
                f"({self.sq_count}x{self.sq_bits})"
            )
        return self.sq_count * self.sq_bits // 8

    def rotate(self, vectors: torch.Tensor) -> torch.Tensor:
        """Identity for plain PQ (OPQ overrides)."""
        return vectors


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
