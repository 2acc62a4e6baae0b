"""The work of the IVF grouped 4-bit scan for one batch of queries, from the
inputs' shapes and sizes, not from any kernel: each query's ma probes by
the benchmark's own coarse assignment (reference/search.nearest); bytes
are the real codes of the distinct partitions probed, read once (padding
excluded), the int8 tables once (pair x sub-quantizer x 16) and one int32
minimum a window of real codes (a storage row: 128 / code bytes codes)
written once; operations are one int8 lookup-addition a (pair, real code,
sub-quantizer)."""

import torch

from portbench.reference.search import nearest


def count(dep, qids) -> tuple[int, int]:
    state = dep.state()
    cfg = dep.cfg
    x = dep.pool[torch.as_tensor(qids, device=dep.pool.device)]
    with torch.no_grad():
        probes = nearest(x, state.coarse, cfg["ma"])
    sizes = state.sizes[probes]                                  # (Q, ma)
    code_bytes = state.codes.shape[-1]
    m = 2 * code_bytes
    cpr = 128 // code_bytes
    codes = int(state.sizes[torch.unique(probes)].sum()) * code_bytes
    tables = probes.numel() * m * 16
    minima = int(((sizes + cpr - 1) // cpr).sum()) * 4
    ops = int(sizes.sum()) * m
    return codes + tables + minima, ops
