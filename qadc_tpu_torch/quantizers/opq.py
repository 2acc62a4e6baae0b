"""OPQ state (counterpart of qadc_tpu/quantizers/opq.py): PQ + rotation."""

from __future__ import annotations

import dataclasses

import torch

from qadc_tpu_torch.quantizers.pq import ProductQuantizer


@dataclasses.dataclass(frozen=True)
class OPQQuantizer(ProductQuantizer):
    """PQ with a (dim, dim) rotation R; rotate(x) = x @ R^T."""

    rotation: torch.Tensor | None = None

    def rotate(self, vectors: torch.Tensor) -> torch.Tensor:
        return torch.matmul(vectors.to(torch.float32), self.rotation.T)
