"""Partition-sharded IVF search over a shard mesh (counterpart of
qadc_tpu/dist/sharded_ivf.py).

The Deep100M-class configuration: partitions are sharded over the mesh
(shard s owns partitions [s * P/D, (s + 1) * P/D) with their codes and
labels), the coarse quantizer and the PQ are replicated, and so are the
queries. A process holds its local shards' partitions contiguously. Per
query batch:

  1. assignment and float tables run replicated;
  2. keep-prefix distances are scored (M2) for the (query, probe) pairs
     whose partition this process owns, zero elsewhere; a sum over the mesh
     assembles the global per-query bound, bit for bit the single-card one
     (the pairs partition disjointly);
  3. int8 tables follow, replicated; the process routes its owned pairs
     and scans them in one grouped launch (M1) over its partitions;
  4. each SHARD screens its own windows exactly (wq = min(r, ma * C)) and
     reranks them (M2) to a local top-r; one gather and a top-r merge.

Each shard screens r windows of its own, so the candidates are a superset
of the single-card screen's: results may differ from ivf.search_qadc by
design, and equal the JAX package's sharded search at the same shard count.
"""

from __future__ import annotations

import dataclasses

import torch

from qadc_tpu_torch.dist.mesh import Mesh, make_mesh
from qadc_tpu_torch.eval.trace import span
from qadc_tpu_torch.index import ivf
from qadc_tpu_torch.index.routing import route_queries
from qadc_tpu_torch.io.checkpoint import FAR_CENTROID, load_index_rows, sharded_manifest
from qadc_tpu_torch.kernels.lut_scan import DISPATCH, Kernels
from qadc_tpu_torch.ops.quantization import int8_tables, keep_prefix_bound
from qadc_tpu_torch.ops.tables import adc_tables
from qadc_tpu_torch.ops.topk import topk_smallest


def _pad_rows(t: torch.Tensor, rows: int, fill) -> torch.Tensor:
    extra = rows - t.shape[0]
    if extra <= 0:
        return t
    return torch.cat([t, t.new_full((extra, *t.shape[1:]), fill)])


def shard_ivf_partitions(index: ivf.IVFIndex, mesh: Mesh) -> ivf.IVFIndex:
    """This process's shards of an IVFIndex: the partition count padded to a
    shard multiple with empty partitions (far coarse centroids), and the
    codes, labels and sizes of this process's partitions; the coarse
    centroids and the PQ stay whole (replicated). With one process that is
    the whole padded index. The index must live on the mesh's device."""
    if index.device != mesh.device:
        raise ValueError(f"index on {index.device}, mesh on {mesh.device}")
    p_pad = -(-index.part_count // mesh.shards) * mesh.shards
    held = p_pad // mesh.world
    rows = slice(mesh.rank * held, (mesh.rank + 1) * held)
    return dataclasses.replace(
        index,
        coarse_centroids=_pad_rows(index.coarse_centroids, p_pad, FAR_CENTROID),
        codes=_pad_rows(index.codes, p_pad, 0)[rows],
        labels=_pad_rows(index.labels, p_pad, 0)[rows],
        part_sizes=_pad_rows(index.part_sizes, p_pad, 0)[rows],
    )


def load_sharded_index(path: str, mesh: Mesh) -> ivf.IVFIndex:
    """Load a sharded checkpoint into the mesh: each process reads only the
    partition rows its shards own, onto the mesh's device.

    The checkpoint's k shard files make a contiguous global partition axis
    of k * parts_per_shard rows; it is padded to a shard multiple with empty
    partitions and sliced contiguously over the processes, so a checkpoint
    written for k processes loads into any number that divides the mesh
    (reshard on load). The coarse centroids are padded alike.
    """
    manifest = sharded_manifest(path)
    stored = int(manifest["parts_per_shard"]) * int(manifest["num_shards"])
    p_pad = -(-stored // mesh.shards) * mesh.shards
    held = p_pad // mesh.world
    local, _ = load_index_rows(path, mesh.rank * held, (mesh.rank + 1) * held,
                               device=mesh.device)
    return dataclasses.replace(
        local, coarse_centroids=_pad_rows(local.coarse_centroids, p_pad, FAR_CENTROID))


def _scan_shards(index, shards: int, parts_l, sizes_l, qtables, tables, tiles, r: int,
                 group_size: int, kernels: Kernels):
    """Steps 3-4 for one query chunk on this process's shards.

    parts_l / sizes_l: (Qc, ma) pairs' partitions among the process's and
    their sizes (0 for a pair another process owns). Returns (dists, labels)
    (Qc, shards * r): each local shard's top-r, shard after shard.
    """
    qc, ma = parts_l.shape
    qac = qc * ma
    m = qtables.shape[2]
    c = index.codes.shape[1]                      # windows per partition = rows
    held = index.codes.shape[0]
    sz = sizes_l.reshape(qac)
    routed = route_queries(parts_l, held, group_size)
    slots = routed.slot_pairs()
    # A pair of another process (or of an empty partition) takes no slot.
    slots = torch.where((slots >= 0) & (sz[slots.clamp(min=0).long()] > 0), slots, -1)
    vals = kernels.grouped_scan(index.codes, qtables.reshape(qac, m, 16), routed.group_part,
                                slots, ivf._group_sizes(index, routed))
    cv = torch.where(ivf._window_valid_mask(sz, c, index.cpr), vals.to(torch.float32), torch.inf)
    # Shard s screens only its own pairs' windows: (shards * Qc * ma, C).
    owner = (parts_l // (held // shards)).reshape(1, qac, 1)
    mine = owner == torch.arange(shards, device=cv.device).reshape(shards, 1, 1)
    cv_s = torch.where(mine, cv.reshape(1, qac, c), torch.inf).reshape(shards * qac, c)
    screen_v, sel_pair, sel_part, sel_wi, sel_sz = ivf._screen(
        cv_s, parts_l.repeat(shards, 1), sz.repeat(shards), min(r, ma * c))
    d, lab = ivf.window_rerank(index.codes, index.labels, tables, screen_v, sel_part,
                               sel_pair % qac, sel_wi, sel_sz, r, kernels, tiles=tiles)
    return (d.reshape(shards, qc, r).transpose(0, 1).reshape(qc, shards * r),
            lab.reshape(shards, qc, r).transpose(0, 1).reshape(qc, shards * r))


def search_qadc_ivf_sharded(
    index: ivf.IVFIndex, queries, r: int = 100, ma: int = 1, keep: float = 0.01,
    mesh: Mesh | None = None, group_size: int = 128, overlap_chunks: int = 1,
    scan_budget_bytes: int | None = None, kernels: Kernels = DISPATCH,
):
    """Quick-ADC search over a partition-sharded IVFIndex (from
    shard_ivf_partitions or load_sharded_index).

    The JAX package's arguments less its TPU knobs (planes, window,
    interpret): the grouped path with rerank on, work and memory divided by
    the shard count.

    overlap_chunks > 1 splits the batch into that many chunks and issues
    each chunk's cross-process gather asynchronously, waiting for all at the
    end, so a gather rides under the next chunk's scan. Results are
    identical for any value; a count that does not divide the batch falls
    back to 1.
    scan_budget_bytes: memory governor of a chunk's local scan (default:
      ivf's); larger chunks scan in parts, each process alike, with no
      collective inside.
    kernels: the kernel set (lut_scan.DISPATCH, or lut_scan.PLAIN).

    Returns (dists (Q, r) float32, labels (Q, r) int32), the same on every
    process.
    """
    with span("search", path="sharded.ivf"):
        if index.pq.sq_bits != 4:
            raise ValueError("Quick ADC requires sq_bits == 4")
        if mesh is None:
            mesh = make_mesh()
        ma = min(ma, index.part_count)  # probing more partitions than exist == all
        if index.part_count % mesh.shards:
            raise ValueError("partition count must be a shard multiple (use shard_ivf_partitions)")
        p_loc = index.part_count // mesh.shards
        held = p_loc * mesh.local_shards
        if index.codes.shape[0] != held or index.device != mesh.device:
            raise ValueError(f"the index holds {index.codes.shape[0]} partitions on "
                             f"{index.device}; this process's shards own {held} on {mesh.device}")
        queries = torch.as_tensor(queries, dtype=torch.float32, device=mesh.device)
        q = queries.shape[0]
        m = index.pq.sq_count
        prefix_pad = max(1, int(index.max_part_size * keep)) if index.max_part_size else 1
        prefix_pad = min(prefix_pad, index.part_pad)

        # 1. replicated front.
        parts, rot = ivf.assign_queries(index, queries, ma)      # (Q, ma) global ids
        tables = adc_tables(rot, index.pq.centroids)              # (Q, ma, M, 16)
        tlo, thi = ivf.tile_tables_rows(tables.reshape(q * ma, m, 16))
        local = parts - mesh.first_shard * p_loc
        owned = (local >= 0) & (local < held)
        local = torch.where(owned, local, 0)
        sizes = torch.where(owned, index.part_sizes[local.long()], 0)

        # 2. keep-prefix distances of owned pairs, summed over the mesh.
        pd, valid = ivf.prefix_distances(index.codes, local, sizes, keep, prefix_pad, (tlo, thi),
                                         kernels)
        cols = pd.shape[-1]
        summed = mesh.sum([torch.cat([torch.where(valid, pd, 0.0), valid.to(torch.float32)], -1)])
        bound = keep_prefix_bound(summed[..., :cols].reshape(q, -1), r,
                                  (summed[..., cols:] > 0).reshape(q, -1))
        qtables = int8_tables(tables, bound)

        # 3-4. per chunk: the local scans, then the chunk's gather (started now,
        # waited for after the remaining chunks' scans).
        nchunks = overlap_chunks if overlap_chunks >= 1 and q % overlap_chunks == 0 else 1
        qc = q // nchunks
        budget = (ivf._default_scan_budget(mesh.device) if scan_budget_bytes is None
                  else scan_budget_bytes)
        c = index.codes.shape[1]
        step = ivf._governed_query_chunk(
            lambda n: ivf._grouped_scan_bytes(
                n, ma, held, index.part_pad, index.cpr, group_size, lanes=16 * index.pq.code_size,
                val_bytes=4, slab_bytes=1, n_streams=1, r=r * mesh.local_shards,
                cb=index.pq.code_size) + n * ma * c * 4 * mesh.local_shards,
            qc, budget)
        pending = []
        for s in range(0, q, qc):
            outs = []
            for a in range(s, s + qc, step):
                b = min(a + step, s + qc)
                outs.append(_scan_shards(
                    index, mesh.local_shards, local[a:b], sizes[a:b], qtables[a:b], tables[a:b],
                    (tlo[a * ma:b * ma], thi[a * ma:b * ma]), r, group_size, kernels))
            lv = torch.cat([o[0] for o in outs])
            ll = torch.cat([o[1] for o in outs])
            pending.append((mesh.gather([lv], dim=1, async_op=True),
                            mesh.gather([ll], dim=1, async_op=True)))
        all_v = torch.cat([wv() for wv, _ in pending])
        all_l = torch.cat([wl() for _, wl in pending])
        return topk_smallest(all_v, all_l, r)
