"""Measured per-geometry picks for the grouped IVF Quick-ADC search
(counterpart of qadc_tpu/autotune.py; opt-in, cached).

The JAX package tunes its TPU knobs (block_n, grouped_window), which the
port does not have: its windows are storage rows. What the port's grouped
path does have is the routing's group size (index/routing.py: pairs of one
partition that one grouped scan serves together; 128 unless tuned). This
module times the real search at the index's geometry with CUDA events
(eval/trace.timed) and keeps the winner, keyed by (device name, path,
geometry, batch bucket), in memory and in a JSON file.

Opt in two ways:
  - explicit: `tune_ivf_qadc(index, queries, r=, ma=, keep=)` records a
    pick; later `ivf.search_qadc` calls that pass no `group_size` use it;
  - `QADC_AUTOTUNE=1`: a search with no recorded pick tunes on its first
    call for its (geometry, batch bucket); a search captured into a CUDA
    graph does not tune, and takes the default.

The cache file is `QADC_AUTOTUNE_CACHE`, by default
~/.cache/qadc_tpu_torch/autotune.json. The JAX package's bundled
autotune_defaults.json holds TPU v5e picks of other knobs and is never read.
"""

from __future__ import annotations

import json
import os
import threading

import torch

from qadc_tpu_torch.eval.trace import timed

GROUP_CANDIDATES = (32, 64, 128, 256)
DEFAULT_GROUP_SIZE = 128
MIN_GAIN = 0.03   # a pick is recorded only if it beats the default by more

_mem: dict[str, dict] = {}
_disk_loaded = False
_lock = threading.Lock()


def _cache_path() -> str:
    return os.environ.get(
        "QADC_AUTOTUNE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "qadc_tpu_torch", "autotune.json"))


def _load_disk() -> None:
    global _disk_loaded
    if _disk_loaded:
        return
    _disk_loaded = True
    try:
        with open(_cache_path()) as f:
            on_disk = json.load(f)
    except (OSError, ValueError):
        return
    for k, v in on_disk.items():
        _mem.setdefault(k, v)


def _save_disk() -> None:
    path = _cache_path()
    try:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(_mem, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass  # the cache is an optimisation; never fail a search over it


def batch_bucket(q: int) -> int:
    """The batch size quantised to the serving buckets (1, 8, 32, 128, 512,
    2048), so one tuning run covers nearby batch sizes; the JAX package's
    buckets."""
    for b in (1, 8, 32, 128, 512):
        if q <= b:
            return b
    return 2048


def geometry_key(index, path: str, q: int) -> str:
    """The cache key: the card's name (torch.cuda.get_device_name; the
    device type off CUDA), path, code geometry and batch bucket."""
    pq = index.pq
    dev = torch.device(index.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type
    return (f"{name}|{path}|m{pq.sq_count}x{pq.sq_bits}"
            f"|d{pq.dim}|pp{getattr(index, 'part_pad', 0)}"
            f"|parts{getattr(index, 'part_count', 0)}|b{batch_bucket(q)}")


def lookup(key: str) -> dict:
    with _lock:
        _load_disk()
        return dict(_mem.get(key, {}))


def record(key: str, pick: dict) -> None:
    with _lock:
        _load_disk()
        _mem[key] = dict(pick)
        _save_disk()


def enabled(device) -> bool:
    """Whether a search on `device` with no recorded pick tunes first:
    QADC_AUTOTUNE is set, and no CUDA graph is being captured on the
    device's current stream (tuning times searches with events and
    synchronises, which a capture cannot hold)."""
    if os.environ.get("QADC_AUTOTUNE", "").strip() not in ("1", "true", "on"):
        return False
    return torch.device(device).type != "cuda" or not torch.cuda.is_current_stream_capturing()


def _time_group_size(index, queries, group_size: int, iters: int, **search_kw) -> float:
    """Seconds of one grouped search_qadc call at `group_size` (median of
    `iters` calls, CUDA events on a card)."""
    from qadc_tpu_torch.index import ivf

    return timed(lambda: ivf.search_qadc(index, queries, grouped=True, direct=False,
                                         group_size=group_size, **search_kw),
                 iters=iters, device=index.device)


def tune_ivf_qadc(index, queries, r: int = 100, ma: int = 24, keep: float = 0.00213,
                  group_candidates=GROUP_CANDIDATES, iters: int = 20,
                  verbose: bool = False) -> dict:
    """Time the grouped Quick-ADC search at each candidate group size on
    this index and batch, and record the winner under geometry_key.

    A candidate the search rejects loses. A winner other than
    DEFAULT_GROUP_SIZE is timed again beside the default at twice the
    iterations and recorded only if it is faster by more than MIN_GAIN (the
    JAX tuner's confirmation); otherwise nothing is recorded and {} is
    returned.

    Returns the pick, e.g. {"group_size": 64}, or {}.
    """
    queries = torch.as_tensor(queries, dtype=torch.float32, device=index.device)
    kw = {"r": r, "ma": ma, "keep": keep}
    times = {}
    for g in group_candidates:
        try:
            times[g] = _time_group_size(index, queries, g, iters, **kw)
        except (ValueError, RuntimeError) as e:  # an invalid candidate loses
            if verbose:
                print(f"autotune ivf_qadc group_size={g}: rejected ({e})")
            continue
        if verbose:
            print(f"autotune ivf_qadc group_size={g}: {times[g] * 1e6:.1f} us/call")
    if not times:
        return {}
    best = min(times, key=times.get)
    if best != DEFAULT_GROUP_SIZE:
        try:
            t_best = _time_group_size(index, queries, best, 2 * iters, **kw)
            t_default = _time_group_size(index, queries, DEFAULT_GROUP_SIZE, 2 * iters, **kw)
        except (ValueError, RuntimeError):  # no confirmation: keep the default
            return {}
        if verbose:
            print(f"autotune confirm: group_size={best} {t_best * 1e6:.1f} us/call against "
                  f"{DEFAULT_GROUP_SIZE}: {t_default * 1e6:.1f}")
        if t_best > t_default * (1 - MIN_GAIN):
            return {}
    pick = {"group_size": best}
    record(geometry_key(index, "ivf_qadc_grouped", queries.shape[0]), pick)
    return pick
