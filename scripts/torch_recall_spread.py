#!/usr/bin/env python3
"""How far the port's trained-index recall moves with the training seeds.

    python3 scripts/torch_recall_spread.py      # one CUDA card, about 40 s

For the 1M SIFT-like build of chip_smoke.py's trained phase (numpy data
seeds 7 and 1), it trains the coarse quantizer from two seeds, with and
without the balance cap, and prints the largest and smallest partition and
the probe hit rate (the share of the 128 queries whose true neighbour's
partition is among the ma=24 probed). On the balanced seed-2 quantizer it
trains the 8x8 residual OPQ from two seeds and prints recall@100 of
ivf.search_adc through the grouped kernel path, through the exact per-probe
path, and with every partition probed: what the search loses, what the
probes lose and what the quantizer's ranking loses, separately.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qadc_tpu_torch.eval.recall import recall_at_r  # noqa: E402
from qadc_tpu_torch.eval.synth import sift_moment_like  # noqa: E402
from qadc_tpu_torch.index import ivf  # noqa: E402
from qadc_tpu_torch.ops.knn import assign_nearest, exact_knn  # noqa: E402
from qadc_tpu_torch.quantizers.opq import train_opq  # noqa: E402

N, LEARN, NQ, MA, R, BATCH = 1_000_000, 100_000, 128, 24, 100, 32


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)

    def recall(index, gt, **kw):
        labels = torch.cat([ivf.search_adc(index, q[s:s + BATCH], r=R, **kw)[1]
                            for s in range(0, NQ, BATCH)])
        return recall_at_r(labels.cpu().numpy(), gt.cpu().numpy())

    for data_seed in (7, 1):
        base, q = (torch.from_numpy(a).to(dev) for a in
                   sift_moment_like(np.random.default_rng(data_seed), N, nq=NQ))
        learn = base[:LEARN]
        gt = assign_nearest(q, base)
        for coarse_seed in (2, 12):
            for cap in (3.0, None):
                coarse = ivf.train_coarse(coarse_seed, learn, 256, iters=25, balance_cap=cap)
                cells = torch.cat([assign_nearest(base[s:s + 250_000], coarse)
                                   for s in range(0, N, 250_000)])
                sizes = torch.bincount(cells.long(), minlength=256)
                _, probes = exact_knn(q, coarse, MA)
                hit = (probes == cells[gt.long()][:, None]).any(dim=1).float().mean().item()
                print(f"data seed {data_seed}, coarse seed {coarse_seed}, cap {cap}: largest "
                      f"partition {int(sizes.max())}, smallest {int(sizes.min())}, probe hit "
                      f"rate at ma={MA} {hit:.4f}", flush=True)
                if (coarse_seed, cap) != (2, 3.0):
                    continue
                residuals = learn - coarse[assign_nearest(learn, coarse).long()]
                for pq_seed in (3, 13):
                    pq = train_opq(pq_seed, residuals, 8, 8, opq_iters=6, kmeans_iters=12)
                    index = ivf.add(ivf.IVFIndex.create(pq, coarse), base)
                    print(f"  8x8 OPQ seed {pq_seed}: recall@{R} grouped "
                          f"{recall(index, gt, ma=MA)}, per-probe exact "
                          f"{recall(index, gt, ma=MA, grouped=False)}, all 256 partitions "
                          f"{recall(index, gt, ma=256, grouped=False)}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
