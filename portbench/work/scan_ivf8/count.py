"""The work of the IVF grouped 8-bit conventional-ADC scan (kernel 5) for
one batch of queries, from the inputs' shapes and sizes, not from any
kernel: each query's ma probes by the benchmark's own coarse assignment
(reference/search.nearest); bytes are the real codes of the distinct
partitions probed, read once (padding excluded), the bfloat16 tables once
(pair x sub-quantizer x 256 x 2 bytes) and one float32 minimum a window
holding a real code, written once (a window: min(cpr, ADC8_WINDOW) codes
of a storage row, cpr // window windows a row, the reference's search_adc8
windows); operations are one float addition a (pair, real code,
sub-quantizer). The argmin that the kernel also writes is no part of the
least work: the search does not read it."""

import torch

from portbench.reference.search import ADC8_WINDOW, nearest


def count(dep, qids) -> tuple[int, int]:
    state = dep.state()
    cfg = dep.cfg
    x = dep.pool[torch.as_tensor(qids, device=dep.pool.device)]
    with torch.no_grad():
        probes = nearest(x, state.coarse, cfg["ma"])
    sizes = state.sizes[probes]                                  # (Q, ma)
    m = state.codes.shape[-1]
    cpr = 128 // m
    cs = cpr // min(cpr, ADC8_WINDOW)                            # windows a row
    codes = int(state.sizes[torch.unique(probes)].sum()) * m
    tables = probes.numel() * m * 256 * 2
    windows = sizes // cpr * cs + torch.clamp(sizes % cpr, max=cs)
    minima = int(windows.sum()) * 4
    ops = int(sizes.sum()) * m
    return codes + tables + minima, ops
