"""Optimized product quantizer: PQ plus a learned orthonormal rotation
(counterpart of qadc_tpu/quantizers/opq.py).

The rotation is applied to vectors before encoding and to residuals before
table computation, as one matmul: rotated = X @ R^T. Training is OPQ-NP
alternating minimisation (Ge et al., CVPR'13): fix R, refresh the PQ on the
rotated data; fix the PQ, update R by orthogonal Procrustes (SVD of
X^T @ decode(codes)). Every product runs in full float32 (no TF32).
"""

from __future__ import annotations

import dataclasses

import torch

from qadc_tpu_torch.core.tensors import (DEFAULT_DEVICE, as_f32, as_generator,
                                         full_f32_matmul, to_f32)
from qadc_tpu_torch.eval.trace import span
from qadc_tpu_torch.ops.kmeans import lloyd_refine
from qadc_tpu_torch.quantizers.pq import (ProductQuantizer, decode_rows, encode_indices,
                                          train_pq)


@dataclasses.dataclass(frozen=True)
class OPQQuantizer(ProductQuantizer):
    """PQ with a (dim, dim) rotation R; rotate(x) = x @ R^T."""

    rotation: torch.Tensor | None = None

    def validate(self) -> "OPQQuantizer":
        super().validate()
        d = self.dim
        if self.rotation is None or tuple(self.rotation.shape) != (d, d):
            shape = None if self.rotation is None else tuple(self.rotation.shape)
            raise ValueError(f"rotation shape {shape} != ({d}, {d})")
        return self

    def rotate(self, vectors: torch.Tensor) -> torch.Tensor:
        with full_f32_matmul():
            return torch.matmul(vectors.to(torch.float32), self.rotation.T)

    def unrotate(self, vectors: torch.Tensor) -> torch.Tensor:
        with full_f32_matmul():
            return torch.matmul(vectors.to(torch.float32), self.rotation)


def opq_round(x: torch.Tensor, rotation: torch.Tensor, centroids: torch.Tensor,
              sq_bits: int, kmeans_iters: int):
    """One alternation from a given state: encode under R, Procrustes update
    of R, warm-started Lloyd refresh of every sub-space codebook under the
    new R.

    Args:
      x: (N, dim) float32 training vectors.
      rotation: (dim, dim) current R.
      centroids: (M, K, dsq) current codebooks.

    Returns (new rotation (dim, dim), new centroids (M, K, dsq)).
    """
    n, dim = x.shape
    m, _, dsq = centroids.shape
    base = ProductQuantizer(centroids=centroids, sq_bits=sq_bits)
    with full_f32_matmul():
        y = decode_rows(base, encode_indices(base, x @ rotation.T))      # (N, dim)
        # Procrustes: min_R ||X R^T - Y||_F  =>  R^T = U V^T, X^T Y = U S V^T.
        u, _, vh = torch.linalg.svd(x.T @ y, full_matrices=False)
        new_rotation = (u @ vh).T
        xr = (x @ new_rotation.T).reshape(n, m, dsq).transpose(0, 1).contiguous()
    return new_rotation, lloyd_refine(xr, centroids, iters=kmeans_iters)


def train_opq(generator, x, sq_count: int, sq_bits: int, opq_iters: int = 20,
              kmeans_iters: int = 25, init_rotation=None,
              device=DEFAULT_DEVICE) -> OPQQuantizer:
    """Train an OPQ by alternating minimisation.

    Args:
      generator: torch.Generator on the data's device, or an int seed.
      x: (N, dim) float32 training vectors: a tensor stays on its device,
        numpy goes to `device`.
      sq_count, sq_bits: PQ geometry.
      opq_iters: outer alternations (opq_round).
      kmeans_iters: Lloyd iterations of the first PQ and of each refresh.
      init_rotation: optional (dim, dim) initial rotation (default identity).

    Returns an OPQQuantizer on the data's device.
    """
    with span("build.train_opq"):
        x = as_f32(x, device)
        gen = as_generator(generator, x.device)
        dim = x.shape[1]
        if init_rotation is None:
            rotation = torch.eye(dim, dtype=torch.float32, device=x.device)
        else:
            rotation = to_f32(init_rotation, x.device)
        with full_f32_matmul():
            xr = x @ rotation.T
        centroids = train_pq(gen, xr, sq_count, sq_bits, iters=kmeans_iters).centroids
        for _ in range(opq_iters):
            rotation, centroids = opq_round(x, rotation, centroids, sq_bits, kmeans_iters)
        return OPQQuantizer(centroids=centroids, sq_bits=sq_bits, rotation=rotation).validate()
