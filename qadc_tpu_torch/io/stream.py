"""Chunked vecs reader on a producer thread (counterpart of
qadc_tpu/io/stream.py).

The reference's vectors_reader (vector_io.hpp:186-290): a producer thread
reads chunks into a bounded queue of depth 2, so disk reads overlap the
consumer's encoding on the device (db_add.cpp:59-82).
"""

from __future__ import annotations

import queue
import threading

from qadc_tpu_torch.io.vecs import load_vectors, vecs_info

DEFAULT_CHUNK = 1_000_000  # reference: vector_io.hpp:243
QUEUE_DEPTH = 2            # reference: vector_io.hpp:231


class VectorStream:
    """Iterate (offset, chunk) over a vecs file, chunks (numpy) read ahead
    by a background thread."""

    def __init__(self, path: str, chunk_size: int = DEFAULT_CHUNK, to_float: bool = True):
        self.path = path
        self.chunk_size = chunk_size
        self.to_float = to_float
        self.dim, self.count = vecs_info(path)

    def _produce(self, q: queue.Queue, stop: threading.Event, error: list) -> None:
        try:
            for off in range(0, self.count, self.chunk_size):
                if stop.is_set():
                    return
                n = min(self.chunk_size, self.count - off)
                q.put((off, load_vectors(self.path, off, n, self.to_float)))
        except Exception as e:  # noqa: BLE001 - raised again on the consumer's side
            error.append(e)
        finally:
            q.put(None)

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        stop = threading.Event()
        error: list = []
        thread = threading.Thread(target=self._produce, args=(q, stop, error), daemon=True)
        thread.start()
        try:
            while (item := q.get()) is not None:
                yield item
            if error:
                raise error[0]
        finally:
            # A consumer that stops early: stop the producer and drain the
            # queue until it has exited, so no put() stays blocked.
            stop.set()
            while thread.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            thread.join()
