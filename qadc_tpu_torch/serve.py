"""Continuous-batching search server (counterpart of qadc_tpu/serve.py).

Callers submit single queries from any thread and get a Future. A collector
thread drains the request queue into padded batches of a few fixed sizes
(1, min(8, batch_size), batch_size) within a collection window, and an
executor thread runs them. The pipeline is double-buffered: the collector
stages at most one batch while the executor runs the last one, so host-side
collection overlaps device work and the throughput is bounded by the larger
of the two, not their sum. A lone request takes the smallest bucket, so it
is served by the low-latency path (the IVF direct path at b=1) instead of
paying a full batch; the few sizes are the shapes a later CUDA-graph capture
would need.

On a CUDA index the executor runs the device work on a stream of its own,
created in the executor thread (the current stream is per thread); it waits
once on the stream current where the server was made, which is where the
index was built. Each batch is copied in from pinned memory and its results
are copied out before the futures resolve.

Spans (eval/trace, while a recording is open): each request's
`serve.queue_wait`, from its submit to the end of its batch's collection
(the waits of one batch share a batch id), and the counter `serve.fill`,
the requests of each batch; the executor's searches record their own
spans.

Usage:
    server = SearchServer(index, r=100, ma=24, keep=0.00852, batch_size=128)
    future = server.submit(query_vector)     # any thread
    dists, labels = future.result()
    server.close()
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np
import torch

from qadc_tpu_torch.core.tensors import DEFAULT_DEVICE
from qadc_tpu_torch.engine import QueryEngine
from qadc_tpu_torch.eval.trace import add_span, count, stamp


class Request(Future):
    """The Future of one query: resolves to (dists (r,), labels (r,)), numpy.
    `bucket` is the batch size that served it, set before it resolves;
    `submitted_ns` its submit time while a recording is open."""

    bucket: int | None = None
    submitted_ns: int | None = None


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class SearchServer:
    """Batched asynchronous search over one index."""

    def __init__(self, index, r: int = 100, ma: int = 1, keep: float = 0.01,
                 adc_type: str = "qadc", batch_size: int = 128, max_wait_ms: float = 2.0,
                 search_fn=None, max_consecutive_failures: int = 3):
        """search_fn: optional (index, batch) -> (dists, labels) override, the
        batch a (bucket, dim) float32 tensor on the index's device (for an
        index with no `device`, the card); by default the flat or IVF search
        of adc_type.

        A failed batch fails only its own callers' futures, and the server
        goes on. max_consecutive_failures failures in a row (poisoned state,
        not a transient) close the server and fail what is queued."""
        self.index = index
        self.batch_size = batch_size
        self._search_fn = search_fn
        self.batch_buckets = sorted({1, min(8, batch_size), batch_size})
        self.max_wait_s = max_wait_ms / 1e3
        # The engine checks the index and adc_type and runs the search.
        self._engine = None if search_fn is not None else QueryEngine(
            index, r=r, ma=ma, keep=keep, adc_type=adc_type, batch_size=batch_size)
        self.device = torch.device(getattr(index, "device", DEFAULT_DEVICE))
        self.dim = index.pq.dim
        # The stream the index was made on: the executor waits on it once.
        self._origin = (torch.cuda.current_stream(self.device)
                        if self.device.type == "cuda" else None)
        self.max_consecutive_failures = max_consecutive_failures
        self._fail_streak = 0
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # Guards submit()'s closed-check and enqueue against the executor's
        # fail-shutdown (set _closed, drain the queue): without it a submit
        # that passed the check could enqueue after the drain and never
        # resolve.
        self._lock = threading.Lock()
        self._batches = 0  # served batch count
        # Double buffer: the collector stages at most one batch while the
        # executor runs the previous one; a deeper queue adds latency only.
        self._exec_q: queue.Queue = queue.Queue(maxsize=1)
        self._collector = threading.Thread(target=self._collect_loop, daemon=True)
        self._executor = threading.Thread(target=self._execute_loop, daemon=True)
        self._collector.start()
        self._executor.start()

    def _search(self, batch: torch.Tensor):
        if self._search_fn is not None:
            return self._search_fn(self.index, batch)
        return self._engine.search(batch)

    def _collect_loop(self):
        """Drain the request queue into padded batches and stage them for the
        executor. Always ends by forwarding the None sentinel to the
        executor, whose shutdown paths rely on it."""
        while True:
            item = self._q.get()
            if item is None:
                self._exec_q.put(None)
                return
            pending = [item]
            # Collect up to batch_size requests before an absolute deadline
            # (a per-get timeout would let a slow trickle stretch the window
            # to batch_size * max_wait).
            deadline = time.monotonic() + self.max_wait_s
            while len(pending) < self.batch_size:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=remaining)
                except queue.Empty:
                    break
                if nxt is None:
                    self._q.put(None)  # signal shutdown again after this batch
                    break
                pending.append(nxt)
            bsz = next(b for b in self.batch_buckets if b >= len(pending))
            batch = np.zeros((bsz, self.dim), np.float32)
            for i, (vec, _) in enumerate(pending):
                batch[i] = vec
            count("serve.fill", len(pending))
            batch_id = None
            for _, fut in pending:
                batch_id = add_span("serve.queue_wait", fut.submitted_ns, batch_id)
            self._exec_q.put((pending, batch))

    def _execute_loop(self):
        stream, pinned = None, {}
        if self.device.type == "cuda":
            stream = torch.cuda.Stream(self.device)
            stream.wait_stream(self._origin)
        while True:
            item = self._exec_q.get()
            if item is None:
                return
            pending, batch = item
            try:
                with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
                    if stream is not None:
                        if batch.shape[0] not in pinned:
                            pinned[batch.shape[0]] = torch.empty(batch.shape, pin_memory=True)
                        host = pinned[batch.shape[0]]
                        host.numpy()[:] = batch
                        x = host.to(self.device, non_blocking=True)
                    else:
                        x = torch.from_numpy(batch).to(self.device)
                    dists, labels = self._search(x)
                    # The copies out wait for the stream, so the pinned batch
                    # is free again when they return.
                    dists, labels = _host(dists), _host(labels)
            except Exception as e:  # noqa: BLE001 - fails this batch's callers
                if stream is not None:
                    with contextlib.suppress(RuntimeError):
                        stream.synchronize()  # the pinned batch may still be read
                for _, fut in pending:
                    fut.set_exception(e)
                self._fail_streak += 1
                if self._fail_streak < self.max_consecutive_failures:
                    continue  # a transient failure: keep serving
                self._shut_down_after(e)
                return
            self._fail_streak = 0
            self._batches += 1
            for i, (_, fut) in enumerate(pending):
                fut.bucket = batch.shape[0]
                fut.set_result((dists[i], labels[i]))

    def _shut_down_after(self, e: BaseException) -> None:
        """Close after a streak of failures and fail every request in flight."""
        # _closed flips under the lock, so a submit that raced past its check
        # has already enqueued and is drained below; later ones fail fast.
        with self._lock:
            self._closed = True
        # The collector may hold a collected batch and may be blocked on
        # _q.get(). Wake it: it stages its batch, sees the sentinel and
        # forwards it, so draining _exec_q up to the sentinel fails every
        # staged future.
        self._q.put(None)
        while (staged := self._exec_q.get()) is not None:
            for _, fut in staged[0]:
                fut.set_exception(e)
        # The collector has exited; fail what was queued before _closed flipped.
        while True:
            try:
                nxt = self._q.get_nowait()
            except queue.Empty:
                return
            if nxt is not None:
                nxt[1].set_exception(e)

    def submit(self, query) -> Request:
        """Queue one query vector; resolves to (dists (r,), labels (r,))."""
        query = np.asarray(query, np.float32).reshape(-1)
        if query.shape[0] != self.dim:
            raise ValueError(f"query dim {query.shape[0]} != index dim {self.dim}")
        fut = Request()
        fut.submitted_ns = stamp()
        with self._lock:
            if self._closed:
                raise RuntimeError("server closed")
            self._q.put((query, fut))
        return fut

    def close(self):
        with self._lock:
            self._closed = True
        self._q.put(None)
        self._collector.join(timeout=30)
        self._executor.join(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
