"""Faults planted in the program's training, for the readings that set the
limit of `train_excess` (control.py) and for the harness's own tests:

  rotation_identity   the OPQ's rotation left at its start, the identity
                      (no alternation: a plain PQ);
  codebooks_at_seeds  every Lloyd refresh of the sub-space codebooks
                      skipped: they stay at their k-means++ seeds;
  coarse_collapsed    every second coarse centroid collapsed onto its
                      neighbour, so half of the partitions are empty.

Each patches the port's trainer where set-up (deploy.build) looks it up,
and restores it on exit.
"""

from __future__ import annotations

import contextlib

NAMES = ("rotation_identity", "codebooks_at_seeds", "coarse_collapsed")


@contextlib.contextmanager
def planted(name: str):
    from qadc_tpu_torch.index import ivf
    from qadc_tpu_torch.quantizers import opq

    real_opq, real_coarse = opq.train_opq, ivf.train_coarse

    def opq_with(**over):
        return lambda *args, **kw: real_opq(*args, **{**kw, **over})

    def collapsed(*args, **kw):
        c = real_coarse(*args, **kw).clone()
        c[1::2] = c[0::2][:c[1::2].shape[0]]
        return c

    if name == "rotation_identity":
        opq.train_opq = opq_with(opq_iters=0)
    elif name == "codebooks_at_seeds":
        opq.train_opq = opq_with(kmeans_iters=0)
    elif name == "coarse_collapsed":
        ivf.train_coarse = collapsed
    else:
        raise KeyError(name)
    try:
        yield
    finally:
        opq.train_opq, ivf.train_coarse = real_opq, real_coarse
