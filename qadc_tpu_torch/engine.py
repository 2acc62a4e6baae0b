"""Query engine: fixed-size batches with per-phase metrics (counterpart of
qadc_tpu/engine.py).

Reference: nns_engine_batch (query_common.hpp:149-309), which amortises
assignment, rotation and tables over a batch. This engine serves the CLI's
CSV contract (the reference's index / rotate / table / scan columns,
db_query_4.cpp:387-390) and cuts a query stream into batches of one shape,
the tail padded with zero queries.

Phases are attributed as in the JAX engine, by timing cumulative prefixes of
the search (front; front + tables; the full search) and differencing, so
index + rotate + table + scan is the full search's time by construction.
Each prefix is timed with CUDA events (eval/trace.timed: the median of
`iters` calls after a warm-up) inside an `annotate` span that a profiler
trace names.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from qadc_tpu_torch.eval.metrics import QueryMetrics
from qadc_tpu_torch.eval.trace import annotate, timed
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.index.flat import FlatIndex
from qadc_tpu_torch.index.ivf import IVFIndex
from qadc_tpu_torch.ops.tables import adc_tables


def split_phases(t_front: float, t_tables: float, t_full: float) -> tuple[float, float, float]:
    """(front, tables, scan) from the times of the three cumulative prefixes:
    each prefix is clipped into [the shorter prefix, the full search], so the
    phases are non-negative and sum to t_full."""
    front = min(max(t_front, 0.0), t_full)
    tables = min(max(t_tables, front), t_full)
    return front, tables - front, t_full - tables


class QueryEngine:
    """Runs fixed-size query batches against a flat or IVF index."""

    def __init__(self, index, r: int = 100, ma: int = 1, keep: float = 0.01,
                 adc_type: str = "qadc", batch_size: int = 32, rerank: bool = True):
        if adc_type not in ("adc", "qadc"):
            raise ValueError(f"adc_type must be adc|qadc, got {adc_type}")
        if adc_type == "qadc" and index.pq.sq_bits != 4:
            # Reference: db_query_4 exits unless sq_bits==4 (db_query_4.cpp:393-402).
            raise ValueError("Quick ADC requires sq_bits == 4")
        self.is_ivf = isinstance(index, IVFIndex)
        if not self.is_ivf and not isinstance(index, FlatIndex):
            raise TypeError(f"unsupported index type {type(index)}")
        self.index = index
        self.r = r
        self.ma = ma
        self.keep = keep
        self.adc_type = adc_type
        self.batch_size = batch_size
        self.rerank = rerank

    def search(self, queries: torch.Tensor):
        """One batch on the index's device: (dists (Q, r), labels (Q, r))."""
        if self.is_ivf:
            if self.adc_type == "qadc":
                return ivf.search_qadc(self.index, queries, r=self.r, ma=self.ma,
                                       keep=self.keep, rerank=self.rerank)
            return ivf.search_adc(self.index, queries, r=self.r, ma=self.ma)
        if self.adc_type == "qadc":
            return flat.search_qadc(self.index, queries, r=self.r, keep=self.keep,
                                    rerank=self.rerank)
        return flat.search_adc(self.index, queries, r=self.r)

    def _front(self, queries: torch.Tensor):
        """Coarse assignment with the residuals' rotation (IVF), or the
        queries' rotation (flat): the rotated vectors the tables take."""
        if self.is_ivf:
            return ivf.assign_queries(self.index, queries, self.ma)[1]
        return self.index.pq.rotate(queries)

    def measure_phases(self, queries, iters: int = 20, warmup: int = 3) -> QueryMetrics:
        """Per-query phase microseconds of one (batch_size, dim) batch.

        Times the prefixes front, front + tables and the full search (the
        median of `iters` calls each) and differences them (split_phases).
        For an IVF index the front is the assignment with the residuals'
        rotation (index_us, rotate_us 0, as in the JAX engine); for a flat
        index it is the rotation (rotate_us, index_us 0).

        Returns per-query-averaged QueryMetrics (count=1).
        """
        dev = self.index.device
        qs = torch.as_tensor(np.asarray(queries, np.float32)[: self.batch_size], device=dev)
        centroids = self.index.pq.centroids

        def front():
            with annotate("qadc.phase.front"):
                return self._front(qs)

        def front_tables():
            with annotate("qadc.phase.front_tables"):
                return adc_tables(self._front(qs), centroids)

        def full():
            with annotate("qadc.phase.search"):
                return self.search(qs)

        t = [timed(fn, iters=iters, warmup=warmup, device=dev) * 1e6
             for fn in (front, front_tables, full)]
        front_us, table_us, scan_us = split_phases(*t)
        q = qs.shape[0]
        metrics = QueryMetrics()
        if self.is_ivf:
            metrics.add(front_us / q, 0.0, table_us / q, scan_us / q)
        else:
            metrics.add(0.0, front_us / q, table_us / q, scan_us / q)
        return metrics

    def run(self, queries, with_metrics: bool = False):
        """Search all queries in batches of batch_size (the tail padded with
        zero queries, its padding dropped from the result).

        with_metrics=True measures the phases once, on the first batch
        (padded to batch_size), as the reference's CSV averages over queries.

        Returns (dists (Q, r), labels (Q, r), QueryMetrics), numpy.
        """
        queries = np.asarray(queries, np.float32)
        q, dim = queries.shape
        b = self.batch_size
        metrics = QueryMetrics()
        if with_metrics:
            first = np.zeros((b, dim), np.float32)
            first[: min(b, q)] = queries[:b]
            metrics = self.measure_phases(first)
        dev = self.index.device
        all_d, all_l = [], []
        for s in range(0, q, b):
            batch = queries[s:s + b]
            n = batch.shape[0]
            if n < b:
                batch = np.concatenate([batch, np.zeros((b - n, dim), np.float32)])
            d, lab = self.search(torch.from_numpy(batch).to(dev))
            all_d.append(d[:n].cpu().numpy())
            all_l.append(lab[:n].cpu().numpy())
        out_d, out_l = np.concatenate(all_d), np.concatenate(all_l)
        short = int(np.any(~np.isfinite(out_d), axis=1).sum())
        if short:
            # Reference: heap-not-full warning (query_common.hpp:356-358).
            print(f"warning: fewer than r={self.r} results for {short}/{q} "
                  "queries (index smaller than r, or probed partitions too "
                  "small — +inf sentinels returned)", file=sys.stderr)
        return out_d, out_l, metrics
