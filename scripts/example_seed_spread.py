#!/usr/bin/env python3
"""Recall of the SIFT example's pipeline over training seeds, on the CPU, in
either package: how far one training draw moves recall@100 on the JAX
example's synthetic stand-in (examples/sift_pipeline.py and its twin
examples/torch_sift_pipeline.py draw the same vectors).

    python scripts/example_seed_spread.py --package torch [--seeds 0 1 2]
    python scripts/example_seed_spread.py --package jax   [--seeds 0 1 2]

Seed s trains the coarse quantizer from seed 2s and OPQ 16x4 from 2s + 1
(s = 0: the examples' own seeds 0 and 1). Each line gives the coarse
k-means objective (mean squared residual of the learn set), the share of
queries whose true neighbour lies in one of their 24 probed cells (the
coarse quantizer's ceiling on recall), the OPQ quantization error of the
residuals, and recall@100 of the example's search (r=100, ma=24, init 200),
and for the port also of the exact direct path. About a minute a seed in
the port, 45 s in JAX, on 8 CPU cores.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]


def cell_hit(cell_of_base, probes, gt) -> float:
    """Share of queries whose true nearest neighbour's cell is probed."""
    return float((probes == cell_of_base[np.asarray(gt)[:, 0]][:, None]).any(1).mean())


def torch_spread(seeds):
    import torch

    sys.path.insert(0, str(REPO / "examples"))
    import torch_sift_pipeline as ex
    from qadc_tpu_torch.eval.recall import recall_at_r
    from qadc_tpu_torch.index import ivf
    from qadc_tpu_torch.ops.knn import assign_nearest
    from qadc_tpu_torch.quantizers.opq import train_opq
    from qadc_tpu_torch.quantizers.pq import decode, encode

    learn, base, query, gt, _ = ex.load_or_synthesize(None, torch.device("cpu"))
    for s in seeds:
        coarse = ivf.train_coarse(2 * s, learn, part_count=ex.PARTS)
        res = learn - coarse[assign_nearest(learn, coarse).long()]
        q = train_opq(2 * s + 1, res, 16, 4)
        err = float(((decode(q, encode(q, res)) - q.rotate(res)) ** 2).sum(1).mean())
        index = ivf.add(ivf.IVFIndex.create(q, coarse), base)
        hit = cell_hit(np.asarray(assign_nearest(base, coarse)),
                       np.asarray(ivf.assign_queries(index, query, ex.MA)[0]), gt)
        keep = ivf.keep_for_init(ex.INIT, index.part_count, ex.MA, index.n)
        rec = {}
        for path, kw in (("grouped", {}), ("direct", {"direct": True})):
            _, lab = ivf.search_qadc(index, query, r=ex.R, ma=ex.MA, keep=keep, **kw)
            rec[path] = recall_at_r(lab.numpy(), gt)
        print(f"torch seed {s}: coarse objective {float((res ** 2).sum(1).mean()):.4f} "
              f"cell hit {hit:.4f} OPQ error {err:.4f} recall@100 {rec['grouped']} (direct "
              f"path {rec['direct']})", flush=True)


def jax_spread(seeds):
    import importlib.util

    import jax

    spec = importlib.util.spec_from_file_location("sift_pipeline",
                                                  REPO / "examples" / "sift_pipeline.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    from qadc_tpu.eval.recall import recall_at_r
    from qadc_tpu.index import ivf
    from qadc_tpu.ops.knn import assign_nearest
    from qadc_tpu.quantizers.opq import train_opq
    from qadc_tpu.quantizers.pq import decode, encode

    learn, base, query, gt, _ = ex.load_or_synthesize(None)
    for s in seeds:
        coarse = ivf.train_coarse(jax.random.PRNGKey(2 * s), learn, part_count=256)
        res = learn - np.asarray(coarse)[np.asarray(assign_nearest(learn, coarse))]
        q = train_opq(jax.random.PRNGKey(2 * s + 1), res, sq_count=16, sq_bits=4)
        err = float(((np.asarray(decode(q, encode(q, res))) - np.asarray(q.rotate(res))) ** 2)
                    .sum(1).mean())
        index = ivf.add(ivf.IVFIndex.create(q, coarse), base)
        hit = cell_hit(np.asarray(assign_nearest(base, coarse)),
                       np.asarray(ivf.assign_queries(index, query, 24)[0]), gt)
        keep = ivf.keep_for_init(200, index.part_count, 24, index.n)
        _, lab = ivf.search_qadc(index, query, r=100, ma=24, keep=keep)
        print(f"jax seed {s}: coarse objective {float((res ** 2).sum(1).mean()):.4f} "
              f"cell hit {hit:.4f} OPQ error {err:.4f} recall@100 "
              f"{recall_at_r(np.asarray(lab), gt)}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2])
    args = ap.parse_args(argv)
    sys.path.insert(0, str(REPO))
    (torch_spread if args.package == "torch" else jax_spread)(args.seeds)


if __name__ == "__main__":
    main()
