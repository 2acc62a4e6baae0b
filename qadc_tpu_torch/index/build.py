"""Streaming index builders (counterpart of qadc_tpu/index/build.py).

  - The quantizer's device does the heavy math per chunk (assign ->
    residual -> encode), `encode_batch` vectors at a time.
  - Host (numpy) buffers grow geometrically (2x) when a partition overflows,
    so the total copy work is O(final size).
  - Tail padding (repeat the last code, clamp the label) and the row128
    layout happen once, at finalize(), which puts the index on the
    quantizer's device.

Usage:
    b = IVFBuilder.from_index(index)
    for chunk in chunks:
        b.add(chunk)
    index = b.finalize()
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from qadc_tpu_torch.core.layout import codes_per_row, pad_codes_to_block, to_row128
from qadc_tpu_torch.core.tensors import to_f32
from qadc_tpu_torch.eval.trace import span
from qadc_tpu_torch.index.flat import FlatIndex
from qadc_tpu_torch.index.ivf import PART_ALIGN, IVFIndex
from qadc_tpu_torch.ops.knn import assign_nearest
from qadc_tpu_torch.quantizers.pq import encode


def _batches(vectors, encode_batch: int, device):
    """float32 chunks of at most encode_batch vectors, on `device`."""
    for s in range(0, len(vectors), encode_batch):
        yield to_f32(vectors[s:s + encode_batch], device)


def _tail_padded(codes: np.ndarray, labels: np.ndarray, sizes: np.ndarray, part_pad: int):
    """(P, part_pad, cb) codes and (P, part_pad) labels whose rows at or past
    each partition's size repeat its last code and label."""
    rows = np.arange(part_pad, dtype=np.int64)[None, :]
    last = np.maximum(sizes, 1)[:, None] - 1
    src = np.minimum(rows, np.minimum(last, codes.shape[1] - 1))
    return (np.take_along_axis(codes, src[:, :, None], axis=1),
            np.take_along_axis(labels, src, axis=1))


def repad_partitions(index: IVFIndex, part_pad: int) -> IVFIndex:
    """Re-pad an IVF index's partitions to a target part_pad, keeping the
    tail repeat (last code, clamped label). part_pad must be a multiple of
    PART_ALIGN and at least max_part_size."""
    if part_pad % PART_ALIGN != 0:
        raise ValueError(f"part_pad={part_pad} must be a multiple of {PART_ALIGN}")
    if part_pad < index.max_part_size:
        raise ValueError(f"part_pad={part_pad} < max_part_size={index.max_part_size}: "
                         "re-padding would silently drop real codes")
    p, cb = index.part_count, index.pq.code_size
    codes, labels = _tail_padded(
        index.codes.cpu().numpy().reshape(p, -1, cb), index.labels.cpu().numpy(),
        index.part_sizes.cpu().numpy().astype(np.int64), part_pad)
    dev = index.device
    return IVFIndex(
        pq=index.pq, coarse_centroids=index.coarse_centroids,
        codes=torch.from_numpy(codes.reshape(p, part_pad // codes_per_row(cb), 128)).to(dev),
        labels=torch.from_numpy(labels).to(dev), part_sizes=index.part_sizes,
        n=index.n, max_part_size=index.max_part_size)


class FlatBuilder:
    """Accumulate encoded chunks; one concatenation and re-layout at finalize."""

    def __init__(self, pq, chunks=None, n: int = 0):
        self.pq = pq
        self._chunks: list[np.ndarray] = list(chunks or [])
        self.n = n

    @classmethod
    def from_index(cls, index: FlatIndex) -> "FlatBuilder":
        old = index.codes.cpu().numpy().reshape(-1, index.pq.code_size)[:index.n]
        return cls(index.pq, [old] if index.n else [], index.n)

    def add(self, vectors, encode_batch: int = 262144) -> None:
        for chunk in _batches(vectors, encode_batch, self.pq.centroids.device):
            self._chunks.append(encode(self.pq, chunk).cpu().numpy())
        self.n += len(vectors)

    def finalize(self) -> FlatIndex:
        cb = self.pq.code_size
        codes = np.concatenate(self._chunks) if self._chunks else np.zeros((0, cb), np.uint8)
        rows = to_row128(pad_codes_to_block(codes))
        return FlatIndex(pq=self.pq, n=self.n,
                         codes=torch.from_numpy(rows).to(self.pq.centroids.device))


class IVFBuilder:
    """Per-partition append buffers with geometric growth.

    Buffers hold raw rows only (no tail padding); rows past sizes[p] are
    garbage until finalize().
    """

    def __init__(self, pq, coarse_centroids, cap: int = PART_ALIGN):
        self.pq = pq
        self.coarse = to_f32(coarse_centroids, pq.centroids.device)
        p = self.coarse.shape[0]
        self.cap = cap
        self.codes = np.zeros((p, cap, pq.code_size), np.uint8)
        self.labels = np.zeros((p, cap), np.int32)
        self.sizes = np.zeros((p,), np.int64)
        self.n = 0

    @classmethod
    def from_index(cls, index: IVFIndex) -> "IVFBuilder":
        sizes = index.part_sizes.cpu().numpy().astype(np.int64)
        cap = max(PART_ALIGN, 1 << int(np.ceil(np.log2(max(1, sizes.max(initial=0))))))
        b = cls(index.pq, index.coarse_centroids, cap)
        old_codes = index.codes.cpu().numpy().reshape(index.part_count, -1, index.pq.code_size)
        w = min(old_codes.shape[1], cap)
        b.codes[:, :w] = old_codes[:, :w]
        b.labels[:, :w] = index.labels.cpu().numpy()[:, :w]
        b.sizes = sizes
        b.n = index.n
        return b

    def _grow(self, need: int) -> None:
        cap = self.cap
        while cap < need:
            cap *= 2
        if cap == self.cap:
            return
        p, _, cb = self.codes.shape
        codes = np.zeros((p, cap, cb), np.uint8)
        labels = np.zeros((p, cap), np.int32)
        codes[:, :self.cap] = self.codes
        labels[:, :self.cap] = self.labels
        self.codes, self.labels, self.cap = codes, labels, cap

    def add(self, vectors, encode_batch: int = 262144) -> None:
        """Assign -> residual -> encode on the device; scatter-append on the
        host. Only the new rows are written (one vectorized scatter a call)."""
        count = len(vectors)
        if count == 0:
            return
        codes_parts, assign_parts = [], []
        for chunk in _batches(vectors, encode_batch, self.coarse.device):
            with span("build.encode"):
                a = assign_nearest(chunk, self.coarse)
                codes_parts.append(encode(self.pq, chunk - self.coarse[a.long()]).cpu().numpy())
                assign_parts.append(a.cpu().numpy())
        codes_np = np.concatenate(codes_parts)
        assign_np = np.concatenate(assign_parts)
        new_labels = np.arange(self.n, self.n + count, dtype=np.int32)

        counts = np.bincount(assign_np, minlength=self.codes.shape[0]).astype(np.int64)
        self._grow(int((self.sizes + counts).max()))
        # Flat destinations: sort by partition, place each run after the
        # partition's existing rows.
        order = np.argsort(assign_np, kind="stable")
        part = assign_np[order].astype(np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        rank = np.arange(count, dtype=np.int64) - starts[part]
        dest = part * self.cap + self.sizes[part] + rank
        self.codes.reshape(-1, self.pq.code_size)[dest] = codes_np[order]
        self.labels.reshape(-1)[dest] = new_labels[order]
        self.sizes += counts
        self.n += count

    def finalize(self) -> IVFIndex:
        """Tail-pad (repeat the last code, clamp the label) and lay out as
        row128, once; the index goes to the quantizer's device."""
        p, _, cb = self.codes.shape
        max_size = int(self.sizes.max()) if p else 0
        empty = int((self.sizes == 0).sum()) if p else 0
        if self.n and empty:
            # Empty partitions are tolerated (fully masked) but waste probes.
            print(f"warning: {empty}/{p} partitions are empty", file=sys.stderr)
        part_pad = max(PART_ALIGN, -(-max(max_size, 1) // PART_ALIGN) * PART_ALIGN)
        codes, labels = _tail_padded(self.codes, self.labels, self.sizes, part_pad)
        dev = self.coarse.device
        return IVFIndex(
            pq=self.pq, coarse_centroids=self.coarse,
            codes=torch.from_numpy(codes.reshape(p, part_pad // codes_per_row(cb), 128)).to(dev),
            labels=torch.from_numpy(labels).to(dev),
            part_sizes=torch.from_numpy(self.sizes.astype(np.int32)).to(dev),
            n=self.n, max_part_size=max_size)
