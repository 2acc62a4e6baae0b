"""Query engine: fixed-size batches with per-phase metrics (counterpart of
qadc_tpu/engine.py).

Reference: nns_engine_batch (query_common.hpp:149-309), which amortises
assignment, rotation and tables over a batch. This engine serves the CLI's
CSV contract (the reference's index / rotate / table / scan columns,
db_query_4.cpp:387-390) and cuts a query stream into batches of one shape,
the tail padded with zero queries.

Phases are read from the spans of whole searches (eval/trace): each search
runs under a recording that places a CUDA event at the boundaries of the
`search` span and of the phase spans, and a phase is the device time
between the events of its spans (on the CPU, the host clock's). The front spans are the index and rotate phases, the table
spans the table phase, and the rest of the search span the scan phase, so
index + rotate + table + scan is the search's own time by construction.

`run` replays each batch's search as one CUDA graph on a CUDA index. The
first batch becomes the graph's static (batch_size, dim) input, is searched
once eagerly on a side stream (autotune, the scan budget and the kernel
library settle there, on real queries) and the search is captured; every
batch then copies into the input and replays. The graph is kept for the
engine's index and `graph_key()`, the search's arguments, and captured anew
when either changes. Searches stay eager in `search` (the server's), in
`measure_phases`, on a CPU index, and for a first batch that arrives while
a recording is open. A replay runs the search's kernels without Python:
`lut_scan.launches` does not count them, and no span is recorded inside its
`search` span (attr `path="graph"`).

Spans of `run`: `engine.batch` (self time: the numpy work of a batch; attr
`graph`: "replay", "capture" or "eager") holds `engine.copy_in`, the
search's `search` span and `engine.copy_out` (the results to the host,
where the host waits for the device).
"""

from __future__ import annotations

import sys
from typing import NamedTuple

import numpy as np
import torch

from qadc_tpu_torch.eval.metrics import QueryMetrics
from qadc_tpu_torch.eval.trace import recording, recording_open, span
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.index.flat import FlatIndex
from qadc_tpu_torch.index.ivf import IVFIndex

# The spans of each phase (index/ivf.py, index/flat.py); the scan phase is
# the rest of the `search` span.
INDEX_SPANS = ("front.assign",)
ROTATE_SPANS = ("front.rotate",)
TABLE_SPANS = ("front.tables", "front.keep_bound", "front.int8")
PHASE_SPANS = ("search", *INDEX_SPANS, *ROTATE_SPANS, *TABLE_SPANS)


def _span_ns(s) -> float:
    """A span's time on the device timeline where it has one, else the host's."""
    if s.device_start_ns is not None:
        return s.device_end_ns - s.device_start_ns
    return float(s.end_ns - s.start_ns)


def phase_split(spans) -> list[tuple[float, float, float, float]]:
    """(index, rotate, table, scan) nanoseconds of each outermost `search`
    span of a recording, in the order the searches ran: the sums of the
    phase spans it holds (found through their parents, so spans open
    around the searches do not matter), and the search's time less them."""
    by_id = {s.id: s for s in spans}

    def search_of(s):
        """The outermost `search` span that holds s, s itself included."""
        top = None
        while s is not None:
            if s.name == "search":
                top = s
            s = by_id.get(s.parent)
        return top

    by_search: dict[int, dict[str, float]] = {}
    searches = []
    for s in spans:
        top = search_of(s)
        if top is s:
            searches.append(s)
        elif top is not None:
            acc = by_search.setdefault(top.id, {})
            acc[s.name] = acc.get(s.name, 0.0) + _span_ns(s)
    out = []
    for s in sorted(searches, key=lambda s: s.start_ns):
        acc = by_search.get(s.id, {})
        index, rotate, table = (sum(acc.get(n, 0.0) for n in names)
                                for names in (INDEX_SPANS, ROTATE_SPANS, TABLE_SPANS))
        out.append((index, rotate, table, _span_ns(s) - index - rotate - table))
    return out


class _Graph(NamedTuple):
    """A captured search: the index and `graph_key()` it was captured for,
    the graph, its static input and its outputs."""

    index: object
    key: tuple
    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    out: tuple


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
        self._graph: _Graph | None = None

    def graph_key(self) -> tuple:
        """The search's arguments: with the index, what a captured search
        depends on besides its input's values."""
        return (self.batch_size, self.r, self.ma, self.keep, self.adc_type, self.rerank)

    def _kept_graph(self) -> _Graph | None:
        """The engine's graph if it was captured for its index and key now."""
        g = self._graph
        if g is not None and g.index is self.index and g.key == self.graph_key():
            return g
        return None

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

    def measure_phases(self, queries, iters: int = 20, warmup: int = 3) -> QueryMetrics:
        """Per-query phase microseconds of one (batch_size, dim) batch.

        Runs `iters` searches (after `warmup`) under one recording with CUDA
        events at the boundaries of PHASE_SPANS and splits the median search (by its
        own time) into its phases (phase_split). For an IVF index the index
        phase is the assignment with the residuals' rotation (rotate_us 0,
        as in the JAX engine); for a flat index the rotate phase is the
        queries' rotation (index_us 0).

        Returns per-query-averaged QueryMetrics (count=1).
        """
        dev = self.index.device
        qs = torch.as_tensor(np.asarray(queries, np.float32)[: self.batch_size], device=dev)
        for _ in range(warmup):
            self.search(qs)
        with recording(device_events=PHASE_SPANS if dev.type == "cuda" else ()) as rec:
            for _ in range(iters):
                self.search(qs)
        splits = sorted(phase_split(rec.spans), key=sum)
        index, rotate, table, scan = (ns / 1e3 / qs.shape[0] for ns in splits[len(splits) // 2])
        metrics = QueryMetrics()
        if self.is_ivf:
            metrics.add(index + rotate, 0.0, table, scan)
        else:
            metrics.add(index, rotate, table, scan)
        return metrics

    def run(self, queries, with_metrics: bool = False):
        """Search all queries in batches of batch_size (the tail padded with
        zero queries, its padding dropped from the result).

        with_metrics=True measures the phases once, on the first batch
        (padded to batch_size), as the reference's CSV averages over queries.

        On a CUDA index each batch replays the engine's CUDA graph (module
        docstring), so one engine's `run` is not for two threads at once:
        their batches would share the graph's input and outputs.

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
        short = 0
        for s in range(0, q, b):
            with span("engine.batch") as sp:
                batch = queries[s:s + b]
                n = batch.shape[0]
                if n < b:
                    batch = np.concatenate([batch, np.zeros((b - n, dim), np.float32)])
                g = self._kept_graph()
                if g is None and dev.type == "cuda" and not recording_open():
                    g, mode = self._capture(batch), "capture"
                else:
                    mode = "eager" if g is None else "replay"
                sp.set(graph=mode)
                with span("engine.copy_in"):
                    if g is None:
                        x = torch.from_numpy(batch).to(dev)
                    else:
                        g.static_in.copy_(torch.from_numpy(batch))
                if g is None:
                    d, lab = self.search(x)
                else:
                    with span("search", path="graph"):
                        g.graph.replay()
                    d, lab = g.out
                with span("engine.copy_out"):
                    d, lab = d[:n].cpu().numpy(), lab[:n].cpu().numpy()
                short += int(np.any(~np.isfinite(d), axis=1).sum())
                all_d.append(d)
                all_l.append(lab)
        out_d, out_l = np.concatenate(all_d), np.concatenate(all_l)
        if short:
            # Reference: heap-not-full warning (query_common.hpp:356-358).
            print(f"warning: fewer than r={self.r} results for {short}/{q} "
                  "queries (index smaller than r, or probed partitions too "
                  "small — +inf sentinels returned)", file=sys.stderr)
        return out_d, out_l, metrics

    def _capture(self, batch: np.ndarray) -> _Graph:
        """Capture this engine's search of a (batch_size, dim) static input,
        which starts as `batch`, as a CUDA graph, after one eager search of
        it, both on a side stream; keep it as the engine's graph. A graph
        kept before is dropped first, so its memory pool is freed."""
        self._graph = None
        dev = self.index.device
        with torch.cuda.device(dev):
            static_in = torch.from_numpy(batch).to(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(side):
                self.search(static_in)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                out = self.search(static_in)
        self._graph = _Graph(self.index, self.graph_key(), graph, static_in, out)
        return self._graph
