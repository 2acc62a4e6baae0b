"""Product quantizer state (counterpart of qadc_tpu/quantizers/pq.py).

Search only: codebooks and geometry, no training or encoding.
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
