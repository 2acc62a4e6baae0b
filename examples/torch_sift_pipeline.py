"""End-to-end example through the PyTorch port: the reference's SIFT1M
workflow, the twin of examples/sift_pipeline.py.

With the real SIFT1M files (sift_learn.fvecs, sift_base.fvecs,
sift_query.fvecs, sift_groundtruth.ivecs from the TexMex corpus) in
--data-dir it runs on them; without them it draws the JAX example's
synthetic stand-in, draw for draw (numpy seed 0), so the two examples can be
compared. It downloads nothing.

  PYTHONPATH=. python examples/torch_sift_pipeline.py [--data-dir sift/]   # the card
  PYTHONPATH=. python examples/torch_sift_pipeline.py --device cpu --learn 20000 --base 40000

Reference workflow (README.md:220-330):
  indexdb_create1 -> external OPQ training -> indexdb_create2 -> db_add
  -> db_query_4 -r 100 -m 24 -k 0.213 -b 32
Here: train the coarse quantizer, OPQ 16x4 on residuals, add, search.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from qadc_tpu_torch.eval.recall import recall_at_r
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.io.vecs import load_vectors
from qadc_tpu_torch.ops.knn import assign_nearest, exact_knn
from qadc_tpu_torch.quantizers.opq import train_opq

# The stand-in's sizes: the JAX example's.
LEARN, BASE, QUERIES = 100_000, 200_000, 256
R, MA, INIT = 100, 24, 200
PARTS = 256


def synthesize(learn: int = LEARN, base: int = BASE, queries: int = QUERIES):
    """The JAX example's stand-in (examples/sift_pipeline.py), draw for draw:
    128-d vectors on a random 64-d subspace plus noise, numpy seed 0.
    Returns (learn, base, queries) float32 arrays."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 128)).astype(np.float32)

    def mk(n):
        return (rng.normal(size=(n, 64)).astype(np.float32) @ a
                + 0.4 * rng.normal(size=(n, 128)).astype(np.float32))

    return mk(learn), mk(base), mk(queries)


def load_or_synthesize(data_dir, device, learn: int = LEARN, base: int = BASE,
                       queries: int = QUERIES):
    """(learn, base, query, ground truth, name): SIFT1M from data_dir where
    all four files are there, else the stand-in with its exact top-10 as
    ground truth. Vectors are float32 tensors on `device`, the ground truth
    a numpy array."""
    names = {"learn": "sift_learn.fvecs", "base": "sift_base.fvecs",
             "query": "sift_query.fvecs", "gt": "sift_groundtruth.ivecs"}
    paths = {k: os.path.join(data_dir or "", v) for k, v in names.items()}
    if data_dir and all(os.path.exists(p) for p in paths.values()):
        vecs = [torch.from_numpy(load_vectors(paths[k])).to(device)
                for k in ("learn", "base", "query")]
        return (*vecs, load_vectors(paths["gt"], to_float=False), "SIFT1M")
    print("SIFT1M not found: using the synthetic stand-in", flush=True)
    vecs = [torch.from_numpy(v).to(device) for v in synthesize(learn, base, queries)]
    _, gt = exact_knn(vecs[2], vecs[1], 10)
    return (*vecs, gt.cpu().numpy(), "synthetic")


def _stage(label: str, fn, seconds: dict, device: torch.device):
    """Run fn, wait for the device, and record its wall seconds."""
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds[label] = time.perf_counter() - t0
    print(f"{label}: {seconds[label]:.2f} s", flush=True)
    return out


def build(learn, base):
    """The first three calls: coarse k-means (seed 0), OPQ 16x4 on the
    residuals (seed 1), add. Returns (IVFIndex, {stage: seconds})."""
    seconds, dev = {}, learn.device
    # 1. Coarse quantizer (replaces indexdb_create1).
    coarse = _stage("coarse k-means", lambda: ivf.train_coarse(0, learn, part_count=PARTS),
                    seconds, dev)

    # 2. OPQ on residuals (replaces the external Quantizations project,
    #    convert-quantizer.py and indexdb_create2).
    def opq():
        residuals = learn - coarse[assign_nearest(learn, coarse).long()]
        return train_opq(1, residuals, sq_count=16, sq_bits=4)

    quantizer = _stage("OPQ 16x4 training", opq, seconds, dev)
    # 3. Build and add (replaces db_add).
    index = _stage("encode+add", lambda: ivf.add(ivf.IVFIndex.create(quantizer, coarse), base),
                   seconds, dev)
    return index, seconds


def search(index, query):
    """The fourth call (replaces db_query_4 -r 100 -m 24 -k 0.213): every
    query in one batch. Returns (dists, labels) tensors."""
    keep = ivf.keep_for_init(INIT, index.part_count, MA, index.n)
    return ivf.search_qadc(index, query, r=R, ma=MA, keep=keep)


def main(argv=None) -> dict:
    """Run the example; returns {"name", "recall", "seconds": {stage: s}}."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data-dir", default=None, help="directory of the SIFT1M files")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--learn", type=int, default=LEARN, help="stand-in learn vectors")
    ap.add_argument("--base", type=int, default=BASE, help="stand-in base vectors")
    ap.add_argument("--queries", type=int, default=QUERIES, help="stand-in queries")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    learn, base, query, gt, name = load_or_synthesize(args.data_dir, device, args.learn,
                                                      args.base, args.queries)
    index, seconds = build(learn, base)
    print(f"index: {index.n} vectors, {index.part_count} partitions, part_pad "
          f"{index.part_pad}", flush=True)
    _, labels = _stage("search", lambda: search(index, query), seconds, device)
    rec = recall_at_r(labels.cpu().numpy(), gt)
    print(f"{name}: recall@{R} = {rec:.4f} (reference SIFT1M publishes 0.9426; the JAX "
          f"example's synthetic stand-in reads 0.7930 on the CPU)", flush=True)
    return {"name": name, "recall": rec, "seconds": seconds}


if __name__ == "__main__":
    main()
