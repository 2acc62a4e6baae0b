"""Worker of the port's multi-process tests (tests/test_torch_multiprocess.py).

    python torch_multiproc_worker.py CKPT_DIR QUERIES_NPZ OUT_NPZ [PROGRESS_DIR]

with the repository on PYTHONPATH and QADC_COORDINATOR / QADC_NUM_PROCESSES
/ QADC_PROCESS_ID set: the environment path of
dist.mesh.maybe_init_distributed, as a multi-host launcher would use it. The
process joins a gloo group on the CPU, loads only the partition rows its
shards own (dist.sharded_ivf.load_sharded_index, resharding when the
checkpoint was written for another count) and runs the sharded search over a
mesh of QUERIES_NPZ's `shards`, batch after batch.

QUERIES_NPZ holds `queries` ((Q, dim), or (batches, Q, dim)), `r`, `ma`,
`keep`, `shards` and `overlap` (overlap_chunks). With PROGRESS_DIR the
worker writes `p{rank}_b{i}.done` after batch i, so that a test can kill a
worker at a known point. Imports no JAX.
"""

import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from qadc_tpu_torch.dist.mesh import make_mesh, maybe_init_distributed
from qadc_tpu_torch.dist.sharded_ivf import load_sharded_index, search_qadc_ivf_sharded


def main() -> None:
    ckpt, qfile, out = sys.argv[1:4]
    progress_dir = sys.argv[4] if len(sys.argv) > 4 else None
    torch.set_num_threads(1)
    if not maybe_init_distributed(device="cpu"):
        raise SystemExit("expected a process group from the QADC_* variables")
    try:
        q = np.load(qfile)
        mesh = make_mesh(int(q["shards"]), device="cpu")
        index = load_sharded_index(ckpt, mesh)
        queries = q["queries"]
        batches = queries[None] if queries.ndim == 2 else queries
        ds, ls = [], []
        for i, batch in enumerate(batches):
            d, lab = search_qadc_ivf_sharded(
                index, batch, r=int(q["r"]), ma=int(q["ma"]), keep=float(q["keep"]),
                mesh=mesh, overlap_chunks=int(q["overlap"]))
            ds.append(d.numpy())
            ls.append(lab.numpy())
            if progress_dir:
                with open(os.path.join(progress_dir, f"p{mesh.rank}_b{i}.done"), "w") as f:
                    f.write("done")
        np.savez(out, d=np.concatenate(ds), l=np.concatenate(ls))
        print(f"process {mesh.rank} done", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
