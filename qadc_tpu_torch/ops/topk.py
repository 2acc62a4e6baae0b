"""Exact top-k building blocks (counterpart of qadc_tpu/ops/topk.py).

Every selection is a stable sort, so ties go to the lower index, as the
reference's stable sorts and lax.top_k do; torch.topk promises no order
among ties.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from qadc_tpu_torch.eval.trace import count

# Width of the chunks the sort cascade of exact_screen_smallest sorts whole
# (the reference's SORT_TOPK_MAX_C; it also bounds the cascade's recursion).
SORT_TOPK_MAX_C = 1024


def window_min_reduce(dists: torch.Tensor, window: int, base_index: int = 0):
    """Minimum and argmin of each window of `window` consecutive codes.

    Args:
      dists: (N, Q) distances, codes along the leading axis.
      window: W, must divide N.
      base_index: global id of code 0 (added to the returned ids).

    Returns:
      (vals (N // W, Q), ids (N // W, Q) int32): each window's smallest
      distance and the global id of its first code at that distance.
    """
    n, q = dists.shape
    if n % window != 0:
        raise ValueError(f"window {window} must divide N={n}")
    g = n // window
    vals, arg = torch.min(dists.reshape(g, window, q), dim=1)
    first = torch.arange(g, dtype=torch.int32, device=dists.device)[:, None] * window
    return vals, arg.to(torch.int32) + first + base_index


def _sort_with(v: torch.Tensor, payload: torch.Tensor):
    """Stable ascending sort of v along the last axis, carrying payload."""
    sv, order = torch.sort(v, dim=-1, stable=True)
    return sv, torch.gather(payload, -1, order)


def topk_smallest(dists: torch.Tensor, labels: torch.Tensor, k: int):
    """Exact top-k smallest along the last axis, carrying labels.

    Returns (vals (..., k) ascending float32, labels (..., k)).
    """
    sv, sl = _sort_with(dists.to(torch.float32), labels)
    return sv[..., :k], sl[..., :k]


def exact_screen_smallest(vals: torch.Tensor, k: int, idx=None):
    """Exact k-smallest + indices along the last axis, by a sort cascade.

    Each chunk of SORT_TOPK_MAX_C keeps its own top-k (a global top-k member
    is a top-k member of its chunk) and the survivors recurse. idx: optional
    (..., C) int32 payload returned in place of the positions.

    Returns (vals (..., k) ascending, idx (..., k) int32).
    """
    lead = vals.shape[:-1]
    w = vals.shape[-1]
    v = vals.to(torch.float32).reshape(-1, w)
    q = v.shape[0]
    if idx is None:
        idx = torch.arange(w, dtype=torch.int32, device=v.device).expand(q, w)
    else:
        idx = idx.to(torch.int32).reshape(-1, w).expand(q, w)
    c = max(SORT_TOPK_MAX_C, k)
    while v.shape[1] > c:
        w = v.shape[1]
        s = -(-w // c)
        kk = min(k, c)
        if s * kk >= w:  # chunking would not shrink: the final sort handles it
            break
        if s * c != w:
            v = F.pad(v, (0, s * c - w), value=torch.inf)
            idx = F.pad(idx, (0, s * c - w))
        v, idx = _sort_with(v.reshape(q * s, c), idx.reshape(q * s, c))
        v = v[:, :kk].reshape(q, s * kk)
        idx = idx[:, :kk].reshape(q, s * kk)
    v, idx = _sort_with(v, idx)
    return v[:, :k].reshape(*lead, k), idx[:, :k].reshape(*lead, k)


def tiles_shrink(w: int, k: int, tile: int = 32) -> bool:
    """Whether exact_tile_screen tiles a row of w at k when it reduces the
    tile minima itself (below, it sorts the row whole)."""
    return w > max(4 * tile, k * 2 * tile, SORT_TOPK_MAX_C)


def exact_tile_screen(vals: torch.Tensor, k: int, tile: int = 32, mins=None, cast=None):
    """Exact k-smallest + indices along the last axis, via tile minima.

    Screen the row's tile minima exactly, then screen the members of the
    k winning tiles. Containment: a true top-k element's tile minimum is at
    most its value, so its tile is among the k smallest minima. Ties at the
    tile cut resolve by (tile, position) order.

    mins: optional (..., w // tile) precomputed tile minima (the direct
    scan kernel and M1 emit them); must equal the min over each contiguous
    tile of the values as screened. In a recording their count is counted
    as `screen.scan_tiles`.
    cast: with mins, the map from vals' entries to the float32 values
    screened (default: a cast); vals is then read at the k winning tiles
    only, in its own dtype.

    Returns (vals (..., k) ascending, idx (..., k) int32).
    """
    w = vals.shape[-1]
    if mins is None and not tiles_shrink(w, k, tile):
        return exact_screen_smallest(vals, k)
    lead = vals.shape[:-1]
    v = vals.reshape(-1, w)
    pad = (-w) % tile
    if mins is None:
        v = v.to(torch.float32)
        if pad:
            v = F.pad(v, (0, pad), value=torch.inf)
    elif pad:
        raise ValueError(f"precomputed mins require tile | width, got width={w} tile={tile}")
    q, wp = v.shape
    ntiles = wp // tile
    dm = v.reshape(q, ntiles, tile)
    if mins is not None:
        if mins.shape[-1] != ntiles:
            raise ValueError(f"mins minor dim {mins.shape[-1]} != width//tile {ntiles}")
        mins = mins.to(torch.float32).reshape(q, ntiles)
        count("screen.scan_tiles", q * ntiles)
    else:
        mins = torch.amin(dm, dim=-1)
    kt = min(k, ntiles)
    inner = exact_tile_screen if ntiles > 16384 else exact_screen_smallest
    _, ti = inner(mins, kt)                                     # exact tile cut
    ti = ti.to(torch.int64)
    cand = torch.gather(dm, 1, ti[..., None].expand(q, kt, tile))  # (Q, kt, tile)
    cand = cast(cand) if cast is not None else cand.to(torch.float32)
    cidx = ti[..., None] * tile + torch.arange(tile, device=v.device)
    sv, idx = exact_screen_smallest(
        cand.reshape(q, kt * tile), min(k, kt * tile),
        idx=cidx.reshape(q, kt * tile),
    )
    kk = sv.shape[-1]
    if kk < k:  # row narrower than k after the tile cut: pad the contract
        sv = F.pad(sv, (0, k - kk), value=torch.inf)
        idx = F.pad(idx, (0, k - kk))
    return sv.reshape(*lead, k), idx.reshape(*lead, k)


def merge_topk(vals_a, labels_a, vals_b, labels_b, k: int):
    """Merge two per-query candidate sets into the k smallest."""
    return topk_smallest(
        torch.cat([vals_a, vals_b], dim=-1), torch.cat([labels_a, labels_b], dim=-1), k
    )
