"""Closed loop, one client: batches of `batch` queries, cycling through the
configuration's query pool in an order drawn from the seed, each sent
through `QueryEngine.run` (the copy in, the search, the results copied to
the host) only after the previous batch's results are on the host.

Traffic keys: "batch" (queries a batch), "warm_batches" (searches of the
first batch before the window).

The engine runs the search the configuration names: `adc_type` "qadc"
(Quick ADC, the default when the key is absent), with its `keep` and
`rerank`, or "adc" (conventional ADC, e.g. of 8-bit codes), which reads
neither; check.py judges the answers by the reference of the same search.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.deploy import subseed
from portbench.harness import Window


def _order(ctx) -> np.ndarray:
    rng = np.random.default_rng(subseed(ctx.seed, "order"))
    return rng.permutation(ctx.dep.pool_np.shape[0])


def prepare(ctx) -> None:
    from qadc_tpu_torch.engine import QueryEngine

    cfg, batch = ctx.cfg, ctx.traffic["batch"]
    adc_type = cfg.get("adc_type", "qadc")
    quick = dict(keep=cfg["keep"], rerank=cfg["rerank"]) if adc_type == "qadc" else {}
    ctx.state["engine"] = QueryEngine(
        ctx.dep.index, r=cfg["r"], ma=cfg.get("ma", 1), adc_type=adc_type, batch_size=batch,
        **quick)
    ctx.state["order"] = _order(ctx)
    ctx.state["next"] = 0
    first = ctx.dep.pool_np[ctx.state["order"][:batch]]
    for _ in range(ctx.traffic["warm_batches"]):
        ctx.state["engine"].run(first)


def run(ctx, seconds: float) -> Window:
    engine, order = ctx.state["engine"], ctx.state["order"]
    pool, batch, n = ctx.dep.pool_np, ctx.traffic["batch"], len(order)
    qids, labels, dists, batches, ends = [], [], [], [], []
    start = ctx.state["next"]
    t0 = time.perf_counter()
    while True:
        ids = order[np.arange(start, start + batch) % n]
        start += batch
        d, lab, _ = engine.run(pool[ids])
        qids.append(ids)
        labels.append(lab)
        dists.append(d)
        batches.append(ids)
        elapsed = time.perf_counter() - t0
        ends.append(elapsed)
        if elapsed >= seconds:
            break
    ctx.state["next"] = start
    done = len(batches) * batch
    return Window(qids=np.concatenate(qids), labels=labels, dists=dists, attempted=done,
                  failed=0, elapsed_s=elapsed, batches=batches,
                  info={"batches": len(batches), "queries_per_s": done / elapsed,
                        "queries_per_s_by_second": _by_second(ends, batch)})


def _by_second(ends, batch: int) -> list[float]:
    """Queries answered in each whole second of the window."""
    counts = np.bincount(np.floor(np.asarray(ends)).astype(int))
    return [float(c * batch) for c in counts[:int(ends[-1])]]


def close(ctx) -> None:
    ctx.state.pop("engine", None)
