"""Set-up of one configuration: data drawn on the device from the seed, the
index trained and built by the port, the exact ground truth by the plain
reference.

Everything here counts as set-up (`setup_s`): users pay it when they build
an index. The stages and their seconds go to standard error.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib
import sys
import time

import numpy as np
import torch

from portbench.reference import search as reference

CHECK_VECTORS = 16_384  # base vectors whose stored codes the reference re-derives


def subseed(seed: int, what: str) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    digest = hashlib.sha256(f"{int(seed)}:{what}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


@dataclasses.dataclass
class Deployment:
    """One built configuration.

    cfg: the configuration file's contents.
    index: the port's IVFIndex or FlatIndex.
    pool: (Q, dim) float32 queries on the device; pool_np the same on the host.
    truth: (Q,) int64 index of each query's exact nearest base vector.
    check_ids / check_vectors: base vectors kept for the build check.
    learn: the learn set the program trained on, kept for the reference's
      own training (check.train_excess).
    stages: seconds of each set-up stage.
    seed: the run's seed.
    """

    cfg: dict
    index: object
    pool: torch.Tensor
    pool_np: np.ndarray
    truth: torch.Tensor
    check_ids: torch.Tensor
    check_vectors: torch.Tensor
    learn: torch.Tensor
    stages: dict
    seed: int

    @property
    def is_ivf(self) -> bool:
        return self.cfg["index"] == "ivf"

    def state(self) -> reference.State:
        """What the reference follows from, read from the port's index."""
        ix = self.index
        pq = ix.pq
        cb = pq.code_size
        if self.is_ivf:
            codes = ix.codes.reshape(ix.codes.shape[0], -1, cb)
            labels = ix.labels.to(torch.int64)
            sizes = ix.part_sizes.to(torch.int64)
            coarse = ix.coarse_centroids
        else:
            codes = ix.codes.reshape(1, -1, cb)
            labels = torch.arange(codes.shape[1], device=codes.device)[None]
            sizes = torch.tensor([ix.n], device=codes.device)
            coarse = None
        rotation = getattr(pq, "rotation", None)
        if rotation is None:
            rotation = torch.eye(pq.dim, device=codes.device)
        return reference.State(coarse=coarse, rotation=rotation, codebooks=pq.centroids,
                               codes=codes, labels=labels, sizes=sizes)


def log(msg: str) -> None:
    print(f"[setup] {msg}", file=sys.stderr, flush=True)


def build(cfg: dict, seed: int, device) -> Deployment:
    from qadc_tpu_torch.index import flat, ivf
    from qadc_tpu_torch.ops.knn import assign_nearest
    from qadc_tpu_torch.quantizers.opq import train_opq

    device = torch.device(device)
    stages = {}

    def stage(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        stages[name] = time.perf_counter() - t0
        log(f"{name}: {stages[name]:.3f} s")
        return out

    data = cfg["data"]
    draw = importlib.import_module(f"portbench.data.{data['generator']}").draw
    gen = torch.Generator(device=device).manual_seed(subseed(seed, "data"))
    base, learn, pool = stage("draw", lambda: draw(
        gen, [cfg["n_base"], cfg["n_learn"], cfg["n_queries"]], dim=cfg["dim"],
        **data.get("params", {})))
    with reference.precision():
        truth = stage("ground_truth", lambda: reference.exact_nn(pool, base))
    pick = torch.Generator().manual_seed(subseed(seed, "check"))
    check_ids = torch.randperm(cfg["n_base"], generator=pick)[:CHECK_VECTORS].to(device)
    check_vectors = base[check_ids].clone()

    tgen = torch.Generator(device=device).manual_seed(subseed(seed, "train"))
    opq = dict(opq_iters=cfg["opq_iters"], kmeans_iters=cfg["kmeans_iters"])
    if cfg["index"] == "ivf":
        coarse = stage("train_coarse", lambda: ivf.train_coarse(
            tgen, learn, cfg["part_count"], iters=cfg["coarse_iters"],
            balance_cap=cfg["balance_cap"]))
        residuals = learn - coarse[assign_nearest(learn, coarse).long()]
        quantizer = stage("train_opq", lambda: train_opq(
            tgen, residuals, cfg["sq_count"], cfg["sq_bits"], **opq))
        index = stage("add", lambda: ivf.add(ivf.IVFIndex.create(quantizer, coarse), base))
        log(f"IVF-{index.part_count}: largest partition {index.max_part_size}, "
            f"part_pad {index.part_pad}, codes {index.codes.numel() / 1e6:.1f} MB")
    else:
        quantizer = stage("train_opq", lambda: train_opq(
            tgen, learn, cfg["sq_count"], cfg["sq_bits"], **opq))
        index = stage("add", lambda: flat.add(flat.FlatIndex.create(quantizer), base))
        log(f"flat: {index.n} codes, n_pad {index.n_pad}, "
            f"codes {index.codes.numel() / 1e6:.1f} MB")
    del base
    return Deployment(cfg=cfg, index=index, pool=pool, pool_np=pool.cpu().numpy(),
                      truth=truth, check_ids=check_ids, check_vectors=check_vectors,
                      learn=learn, stages=stages, seed=seed)
