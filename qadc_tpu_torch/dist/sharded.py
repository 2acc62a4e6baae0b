"""Code-sharded flat search and query-parallel search over a shard mesh
(counterpart of qadc_tpu/dist/sharded.py).

Two modes:

1. CODE SHARDING (flat): the codes split into equal contiguous ranges, one a
   shard; queries and tables are replicated. Each shard screens its own
   range (and float-reranks its own candidates: codes never leave their
   shard), then the shards' (dist, label) lists merge by one gather and a
   top-r.
2. QUERY PARALLEL: the index is replicated and the query batch splits over
   the shards, each running the single-card search on its slice.
"""

from __future__ import annotations

import dataclasses

import torch

from qadc_tpu_torch.core.layout import DEFAULT_BLOCK
from qadc_tpu_torch.dist.mesh import Mesh, make_mesh
from qadc_tpu_torch.eval.trace import span
from qadc_tpu_torch.index import flat, ivf
from qadc_tpu_torch.kernels.lut_scan import DISPATCH, Kernels
from qadc_tpu_torch.kernels.scan_ref import scan_topk_f32
from qadc_tpu_torch.ops.quantization import int8_tables, keep_prefix_bound
from qadc_tpu_torch.ops.tables import adc_tables
from qadc_tpu_torch.ops.topk import topk_smallest


def shard_flat_codes(index: flat.FlatIndex, mesh: Mesh) -> flat.FlatIndex:
    """This process's shards of a FlatIndex: the codes re-padded (repeating
    the last storage row) to a multiple of shards * DEFAULT_BLOCK codes, so
    every shard gets equal rows, and this process's contiguous rows. n stays
    the whole index's. With one process that is the whole re-padded index.
    The index must live on the mesh's device."""
    if index.device != mesh.device:
        raise ValueError(f"index on {index.device}, mesh on {mesh.device}")
    rows, cpr = index.codes, index.cpr
    unit = mesh.shards * DEFAULT_BLOCK
    target = -(-index.n_pad // unit) * unit // cpr
    if target != rows.shape[0]:
        rows = torch.cat([rows, rows[-1:].expand(target - rows.shape[0], 128)])
    held = target // mesh.world
    return dataclasses.replace(index, codes=rows[mesh.rank * held:(mesh.rank + 1) * held])


def _shard_layout(index: flat.FlatIndex, mesh: Mesh):
    """(storage rows a shard, codes a shard) of a code-sharded index."""
    held = index.codes.shape[0]
    if index.device != mesh.device or held % mesh.local_shards:
        raise ValueError(f"the index holds {held} rows on {index.device}, not equal rows for "
                         f"{mesh.local_shards} shards on {mesh.device} (use shard_flat_codes)")
    rows = held // mesh.local_shards
    return rows, rows * index.cpr


def _shards(index: flat.FlatIndex, mesh: Mesh, rows: int, codes: int):
    """(local shard's storage rows, its first global code, its real size)."""
    for s in range(mesh.local_shards):
        offset = (mesh.first_shard + s) * codes
        yield (index.codes[s * rows:(s + 1) * rows], offset,
               min(max(index.n - offset, 0), codes))


def _merge(mesh: Mesh, vals: list, labels: list, r: int):
    """Every shard's (Q, rr) lists gathered along the candidates and cut
    to the top r."""
    return topk_smallest(mesh.gather(vals, dim=1), mesh.gather(labels, dim=1), r)


def search_qadc_flat_sharded(index: flat.FlatIndex, queries, r: int = 100, keep: float = 0.01,
                             rerank: bool = True, mesh: Mesh | None = None,
                             kernels: Kernels = DISPATCH):
    """Quick-ADC search over a code-sharded FlatIndex (from shard_flat_codes).

    The semantics of flat.search_qadc, by the JAX package's kernel path
    (its use_kernel=True): the keep-prefix bound from the global prefix
    (scored by the processes that hold it and summed over the mesh), int8
    tables, and on each shard flat_scan to row minima, an exact screen of
    wq = min(rr, rows) windows and the rerank of their codes to a local top
    rr = min(2r with rerank else r, codes a shard); then one gather and a
    top-r merge. Labels are global code ids. Takes 16 or 32 sub-quantizers
    (the scan kernels' geometry).

    Returns (dists (Q, r) float32, labels (Q, r) int32), the same on every
    process.
    """
    with span("search", path="sharded.flat"):
        if index.pq.sq_bits != 4:
            raise ValueError("Quick ADC requires sq_bits == 4")
        if index.pq.sq_count not in (16, 32):
            raise ValueError(f"the sharded Quick-ADC scan takes 16 or 32 sub-quantizers, "
                             f"got {index.pq.sq_count}")
        if mesh is None:
            mesh = make_mesh()
        rows, codes = _shard_layout(index, mesh)
        cpr = index.cpr
        queries = torch.as_tensor(queries, dtype=torch.float32, device=mesh.device)
        tables = adc_tables(index.pq.rotate(queries), index.pq.centroids)   # (Q, M, 16)
        tiles = ivf.tile_tables_rows(tables)

        # The global prefix: each process scores the prefix rows it holds.
        ps = flat._prefix_size(index.n or codes * mesh.shards, keep)
        prefix_rows = -(-ps // cpr)
        first = mesh.first_shard * rows
        lo, hi = min(first, prefix_rows), min(first + index.codes.shape[0], prefix_rows)
        pd = torch.zeros((tables.shape[0], prefix_rows * cpr), device=mesh.device)
        if lo < hi:
            pd[:, lo * cpr:hi * cpr] = flat.prefix_distances(index.codes, lo - first, hi - lo,
                                                              tables, tiles, kernels)
        valid = torch.arange(prefix_rows * cpr, device=mesh.device) < ps
        qtables = int8_tables(tables, keep_prefix_bound(mesh.sum([pd]), r, valid[None, :]))

        rr = min(2 * r if rerank else r, codes)
        rank_tables = tables if rerank else qtables.to(torch.float32)
        vals, labels = [], []
        for codes_s, offset, size in _shards(index, mesh, rows, codes):
            mins, _ = kernels.flat_scan(codes_s, qtables, size)
            glabels = torch.clamp(
                offset + torch.arange(codes, dtype=torch.int32, device=mesh.device),
                max=max(index.n - 1, 0))
            v, lab = flat.window_search_rows(codes_s, glabels, size, mins, rank_tables, rr,
                                             min(rr, rows), kernels,
                                             tiles=tiles if rerank else None)
            vals.append(v)
            labels.append(lab)
        return _merge(mesh, vals, labels, r)


def search_adc_flat_sharded(index: flat.FlatIndex, queries, r: int = 100,
                            mesh: Mesh | None = None, kernels: Kernels = DISPATCH):
    """Float ADC search over a code-sharded FlatIndex at any sq_bits: each
    shard's exact top-min(r, codes a shard), then one gather and a top-r
    merge.

    A shard's top list is exact: at 4 bits (16 or 32 sub-quantizers) by the
    window path (float flat_scan, a screen of r windows and the M2 rerank,
    equal to the exact scan), at 8 bits by the exact per-code scan, at 16
    bits by the reconstruction GEMM, as the JAX package computes them
    outside any Pallas kernel.
    """
    with span("search", path="sharded.flat.adc"):
        if mesh is None:
            mesh = make_mesh()
        rows, codes = _shard_layout(index, mesh)
        queries = torch.as_tensor(queries, dtype=torch.float32, device=mesh.device)
        bits = index.pq.sq_bits
        tables = None if bits == 16 else adc_tables(index.pq.rotate(queries), index.pq.centroids)
        tiles = (ivf.tile_tables_rows(tables) if bits == 4 and index.pq.sq_count in (16, 32)
                 else None)
        rr = min(r, codes)
        budget = flat._scan_budget(index, None)
        vals, labels = [], []
        for codes_s, offset, size in _shards(index, mesh, rows, codes):
            shard = dataclasses.replace(index, codes=codes_s, n=size)
            if bits == 16:
                v, lab = flat._search_adc_recon(shard, queries, rr)
            elif tiles is not None:
                v, lab = flat._search4_windowed(shard, tables, tables, rr, rr, budget, kernels,
                                                tiles=tiles)
            else:
                v, lab = scan_topk_f32(codes_s.reshape(-1, index.pq.code_size), shard.labels,
                                       tables, bits, rr, num_valid=size)
            vals.append(v)
            labels.append(lab + offset)               # the shard's code ids are local
        return _merge(mesh, vals, labels, r)


def search_query_parallel(search_fn, index, queries, mesh: Mesh | None = None, **kwargs):
    """Run a single-card search query-parallel over the mesh.

    search_fn: e.g. flat.search_qadc or ivf.search_qadc, called as
      search_fn(index, shard_queries, **kwargs) once a shard.
    index: the whole index, on every process (replicated).
    queries: (Q, dim); Q is padded with zero queries to a shard multiple,
      and each shard takes its contiguous slice.

    Returns (dists (Q, r), labels (Q, r)) in query order, the same on every
    process.
    """
    if mesh is None:
        mesh = make_mesh()
    queries = torch.as_tensor(queries, dtype=torch.float32, device=mesh.device)
    q = queries.shape[0]
    per = -(-q // mesh.shards)
    if per * mesh.shards != q:
        queries = torch.cat([queries, queries.new_zeros((per * mesh.shards - q, queries.shape[1]))])
    outs = [search_fn(index, queries[s * per:(s + 1) * per], **kwargs)
            for s in range(mesh.first_shard, mesh.first_shard + mesh.local_shards)]
    dists = mesh.gather([o[0] for o in outs], dim=0)
    labels = mesh.gather([o[1] for o in outs], dim=0)
    return dists[:q], labels[:q]
