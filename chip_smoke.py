#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: its IVF and flat searches
over seeded random indexes, then train -> build -> save -> load -> search on
one million SIFT-like vectors, held to recall against true neighbours, and
the reference's create-index / add / query workflow on those vectors through
the port's files, CLI, query engine, server and autotune.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

It builds the hand-written CUDA kernels from qadc_tpu_torch/csrc/ with nvcc
(into build/kernels/, one compiler per source, in parallel), makes the
seeded indexes of qadc_tpu_torch/eval/synth.py on the card: the bench IVF
geometry (IVF-256, dim 128, 3906 codes per partition, about 1M codes: 16x4
PQ, 8x8 PQ and 8x16 PQ) and the reference's flat SIFT1M size (1M codes
padded to 1,000,448, dim 128: 16x4, 8x8 and 8x16 PQ), and then:

  1. kernel phases: each kernel against its plain PyTorch version on the
     card, at the shapes the search gives it (M1 at b=32's and b=128's
     routed groups and at Deep100M's, by the tensor-core kernel; M2 by its
     staged kernel, equal bit for bit to its staged walk, at the id lists
     that IVF qadc b=128 and b=32, flat qadc b=128 and adc4 b=32 hand it
     (each launch's keep-prefix and rerank lists, recorded through a Kernels
     whose rows_adc keeps its arguments) and at random rerank ids; M3 by its
     chunked kernel, equal bit for bit, at the pairs direct searches hand it
     (b=1, and b=32 and 128 forced direct; after phase 7 the same on the
     CLI's trained index, part_pad 12,288), and at fixed rounds a block 1 /
     2 / 4 in turns (the M3 rounds sweep); M1 with float tables and
     grouped_scan8 on the 16x4 and 8x8 indexes, by their slot-minor kernels,
     at search_adc's routed groups of 32 and 128 queries and at a hot
     partition (128 near-duplicate queries: whole groups of 128 live
     slots), held with torch.equal to their walk in PyTorch (the
     _slot_minor_plain versions); flat_scan with int8 tables, with and
     without argmin rows, by the warpgroup kernel at b=128 and the mma.sync
     kernel at b=32, and with float tables over the 1M flat 16x4 codes at
     b=128, and flat_scan8 over the flat 8x8 codes at b=32: both by their
     query-minor kernels, held with torch.equal to the lookup kernels forced
     at that batch (flat_scan_f32_lookup, flat_scan8_lookup, timed beside
     them) and to their own walk in PyTorch (the _query_minor_plain
     versions)). The tensor-core kernels are also held to scan_onehot_plain,
     their own arithmetic in PyTorch, exactly;
  2. search phases, each with the launch counts reset just before and read
     just after, and every kernel of its path required to have launched:
     ivf.search_qadc at b=1 (direct path), b=32 and b=128 (grouped path),
     r=100, ma=24, keep=0.005, and at b=32 and 128 forced direct; ivf.search_adc at b=32, r=100, ma=24 on the
     4-, 8- and 16-bit indexes; flat.search_qadc (keep=0.01) and
     flat.search_adc 4-bit at b=128, flat.search_adc 8- and 16-bit at b=32,
     r=100. Each result is held against the same search through the plain
     versions and against an exact float64 ADC oracle over the same codes
     (the probed partitions; every real flat code);
  3. timing with CUDA events (warm-up, then the median and p90 of 100 runs): us/query
     per batch (qadc also forced onto the direct path at b=32 and 128), and
     each kernel beside its plain version; torch.profiler's CUDA events give
     device time (each kernel alone; the device's busy and idle share of a
     search);
  4. the build path, in the shape of the JAX package's bench.py recall stage:
     1M vectors of eval/synth.sift_moment_like and 128 queries, the first
     100,000 the learn set, the exact nearest neighbour the ground truth;
     train_opq 8x8 and a flat index; train_coarse (256 cells, balance cap 3),
     train_opq 8x8 and 16x4 on the residuals and two IVF-256 indexes; train_pq
     16x4 and 32x4 flat indexes for the window scans. Every index is saved,
     loaded back onto the card, compared tensor for tensor, and the loaded
     copy searched in batches of 32: recall@100 of flat 8x8 search_adc, IVF
     8x8 search_adc ma=24, IVF 16x4 search_qadc ma=24 with and without
     rerank, each held to a floor (the JAX package's record less 0.035);
  5. the window scans over the trained flat 16x4 codes at b=128:
     flat_scan_window with int8 tables (the warpgroup kernel), held to the
     plain version and to its tile walk bit for bit, and to flat_scan at
     W = cpr, at (block 1024, W 16) min-only, transposed and with argmin ids
     (also at b=32: a partial group of queries), and at (block 512, W 8);
     with float tables the query-minor kernel and the lookup kernel forced
     at that batch (flat_scan_window_f32_lookup) in turns at (1024, 16),
     (512, 8) and 32x4 (1024, 16), b=128, and at b=16 (below
     lut_scan.WINDOW_QUERY_MINOR_MIN_QUERIES: the lookup kernel), held to
     each other, to the plain version and to the query-minor walk bit for
     bit (minima, transposed minima, ids) and to float flat_scan with rows
     at W = cpr, their device times side by side (the `window A/B` line);
     kernel 10, flat_scan_window_regs (four lookups a byte permute) at
     those shapes and at 32x4 (block 8, W 2: 4 windows a block), held to
     flat_scan_window bit for bit, with the instructions a lookup of each
     compiled loop (cuobjdump) and the ceilings, a model, that they set
     (the `window ceilings` line); lut_scan_topk_int8 r=100 against the
     exact scan and the screen of the plain version's windows; the same
     over a 32x4 index (W 16 != cpr 8);
  6. the scan lab (qadc_tpu_torch/kernels/scan_lab.py) over the same trained
     codes at b=128: the three engines of one scan equal bit for bit, every
     lab mode launched and timed, the exactness probe (0 mismatches
     required) and the float32 selector sum against float64 (1e-6); the
     query-minor scans at every chunk of queries and with parts removed, and
     an empty kernel (the device time of a launch); printed as one
     `scan_lab` line; the grouped scans' lab modes (scan_lab.GROUPED_LAB_MODES)
     at search_adc's b=32 groups;
  7. the workflow (workflow_phases), after the trained phase's recall checks,
     on its 1M vectors and 10,000 more queries of the same draw: files
     (base, learn, queries and the exact top-100 from ops/knn on the card
     written as .fvecs / .ivecs and read back by the native path, the numpy
     path and VectorStream, equal; MB/s), the CLI in process (create-index
     IVF-256 OPQ 16x4, add, info, also as a `python -m` subprocess; query
     r=100 ma=24 -k 0.852 b=32, then --adc-type adc; create-flat 16x4, add,
     query b=128 -k 1): each CSV recall equals recall_at_r of the API search
     of the saved index, IVF Quick ADC at or above 0.88, and torch.profiler
     sees M1, M2 and the flat scan launched; QueryEngine.run at b=32 equal to
     the API (phase CSV, idle share); SearchServer (batch 128, 2 ms) under
     2,000 requests from 8 threads, each answer equal to the search of its
     bucket's path, p50 / p99 and QPS, the search's own time inside the
     executor (a timed search_fn), M3 seen from the server's bucket 1;
     search_qadc forced direct and grouped at b = 1..32 (the crossover); and
     autotune.tune_ivf_qadc at b=32 into a cache in the run's temporary
     directory, a search without group_size consuming the pick. One
     `workflow` JSON line holds the numbers;
  8. the sharded searches (sharded_phases) under a process group of one
     rank over NCCL (maybe_init_distributed through the QADC_* variables),
     on a mesh of 4 shards on the card: at the bench geometry the
     partition-sharded IVF Quick ADC (b=32, 128), the code-sharded flat
     Quick ADC and float ADC (4-bit b=128, 8-bit b=32) and the
     query-parallel ivf.search_qadc (b=128), each held to its plain twin,
     the single-card search's top-1 and the float64 oracle; the IVF index
     saved as 4 shard files and loaded into 4 and 2 shards (the reshard);
     the Deep100M geometry (IVF-4096, dim 96, 16x4, 100M codes drawn on the
     card) at b=32 and 512 against the unsharded grouped search and the
     oracle. One `sharded` JSON line holds us/query, device-busy ms, idle
     share and launches of each search.
  9. the surface (surface_phases): (a) examples/torch_sift_pipeline.py at
     its default size (the JAX example's stand-in, draw for draw: 100,000
     learn, 200,000 base, 256 queries), its 256 queries in one search (M1
     int8 and M2), recall@100 at least EXAMPLE_FLOOR; (b) the GIST1M
     geometry (eval/synth.gist_moment_like, numpy seed 0: 1M x 960 and 1,000
     queries, learn the first 100,000): OPQ 16x8 and 32x4 flat indexes,
     IVF-256 (balance cap 3) with OPQ 16x8 and 32x4 on residuals, recall@100
     of each against the exact 1-NN in batches of 32 (IVF 32x4 Quick ADC
     with and without rerank, and one query at a time: M3), train and build
     seconds, us/query with device busy and idle share at b=32 and 128, and
     the kernels at these widths (flat_scan8 m=16, flat_scan int8 CB=16 by
     the warpgroup and mma.sync kernels, grouped_scan8 m=16, M1 CB=16, M2,
     M3) held to their plain versions into the `kernels` line; (c) train_pq
     8x16 on the first 262,144 of the build phase's vectors and on their
     IVF-256 residuals (k-means++ seeding timed apart, peak device memory),
     flat and IVF 8x16 indexes of the 1M vectors, each search_adc's
     recall@100 at least flat 8x8 OPQ ADC's on the same 128 queries. One
     `surface` JSON line holds the numbers.

Beside each kernel's time the `kernels` line gives its bound: the larger of
the bytes it must move (each input read once, each output written once) over
3.35 TB/s and its additions over the peak for their type (int8 tables: 1,979
TOP/s; float sums: 67 TFLOP/s), counted from this run's inputs.

Every kernel row carries the launches torch.profiler recorded for its mean
(`profiled_launches`); a row that recorded none fails the run.

Any failed check raises, so the script exits non-zero and prints no result.
The line before the last is the card's name and power limit as nvidia-smi
reports them, and the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from types import SimpleNamespace

from portbench.peaks import PEAK_BYTES, PEAK_INT8

R, MA, KEEP = 100, 24, 0.005
BATCHES = (1, 32, 128)
ADC_BATCH = 32           # search_adc's phases (bench.py's adc4_b32 / adc8_b32)
# Timed runs per measurement: 100 leave ten samples beyond the p90. A plain
# version (tens of ms at the flat shapes) is timed over PLAIN_REPS runs, a
# kernel that no search launches at that shape over LAB_REPS.
REPS, PLAIN_REPS, LAB_REPS, WARMUP = 100, 10, 30, 3
# Published float32 peak of one H100 SXM (HBM bytes/s and int8 operations/s:
# portbench/peaks.py).
PEAK_F32 = 67e12
# M2/M3 float sums: rtol 1e-6, atol 1e-5 * max|plain| (same sum order, but
# the compiler may round differently); M1 int32: exact.
RTOL, ATOL_REL = 1e-6, 1e-5
# What an SM does a clock, for the lookup kernels' ceilings: shared-memory
# bytes (a float lookup reads 4), integer-pipe lanes (the register engine).
SMEM_BYTES_PER_CLOCK, INT_LANES_PER_CLOCK = 128, 64
SEARCH_RTOL = 1e-5       # distances of a search vs its plain twin / the oracle
MIN_ORACLE_RECALL = 0.95  # grouped path: oracle top-1 found in the top-100
ADC16_RTOL = 1e-4        # 16-bit: float32 GEMM distances vs the float64 oracle
MIN_ADC8_OVERLAP = 95    # 8-bit: mean top-100 overlap with the oracle
FLAT_N, FLAT_KEEP = 1_000_000, 0.01
# Batch of each flat search path: 128 is the JAX bench's kernel stage
# (bench.py:_bench_kernel, 1M codes x 128 queries).
FLAT_BATCH = {"flat_qadc": 128, "flat_adc4": 128, "flat_adc8": 32, "flat_adc16": 32}
# The kernels each search path must launch (keys of lut_scan.launches).
PATH_KERNELS = {
    "qadc": ("grouped_scan", "rows_adc", "direct_scan"),
    "adc4": ("grouped_scan_f32", "rows_adc"),
    "adc8": ("grouped_scan8",),
    "adc16": (),             # decode and a float32 GEMM: no kernel of its own
    "flat_qadc": ("flat_scan", "rows_adc"),
    "flat_adc4": ("flat_scan_f32", "rows_adc"),
    "flat_adc8": ("flat_scan8",),
    "flat_adc16": (),
    "trained_flat_adc8": ("flat_scan8",),
    "trained_ivf_adc8": ("grouped_scan8",),
    "trained_ivf_qadc": ("grouped_scan", "rows_adc"),
    "trained_ivf_qadc_norerank": ("grouped_scan", "rows_adc"),
    "trained_flat_qadc": ("flat_scan", "rows_adc"),
    "window_scan": ("flat_scan_window", "flat_scan_window_regs"),
    "cli_ivf_qadc": ("grouped_scan", "rows_adc"),
    "cli_ivf_adc": ("grouped_scan_f32", "rows_adc"),
    "cli_flat_qadc": ("flat_scan", "rows_adc"),
    "engine": ("grouped_scan", "rows_adc"),
    "serve": ("grouped_scan", "rows_adc", "direct_scan"),
    "crossover": ("grouped_scan", "rows_adc", "direct_scan"),
    "qadc_direct": ("direct_scan",),
    "sharded_ivf": ("grouped_scan", "rows_adc"),
    "sharded_checkpoint": ("grouped_scan", "rows_adc"),
    "sharded_flat_qadc": ("flat_scan", "rows_adc"),
    "sharded_flat_adc4": ("flat_scan_f32", "rows_adc"),
    "sharded_flat_adc8": (),  # the exact per-code scan: no kernel of its own
    "sharded_query_parallel": ("grouped_scan", "rows_adc"),
    "sharded_deep100m": ("grouped_scan", "rows_adc"),
    "autotune": ("grouped_scan", "rows_adc"),
    "example": ("grouped_scan", "rows_adc"),
    "gist_flat_adc8": ("flat_scan8",),
    "gist_flat_qadc": ("flat_scan", "rows_adc"),
    "gist_ivf_adc8": ("grouped_scan8",),
    "gist_ivf_qadc": ("grouped_scan", "rows_adc"),
    "gist_ivf_qadc_norerank": ("grouped_scan", "rows_adc"),
    "gist_ivf_qadc_b1": ("direct_scan",),
    "sixteen_flat": (),      # 16-bit: decode and a float32 GEMM
    "sixteen_ivf": (),
    "scan_lab": ("scan_lab", "selector_sum", "flat_scan", "flat_scan_window",
                 "flat_scan_window_regs", "flat_scan_f32_lookup", "flat_scan8_lookup",
                 "empty_kernel"),
}
# The entries that force a lookup kernel past its query-count threshold
# measure that threshold: no search path may launch them.
LOOKUP_ONLY = ("flat_scan_f32_lookup", "flat_scan8_lookup", "flat_scan_window_f32_lookup")
# The path whose run gives a kernel phase its launch count (default: qadc).
PATH_OF = {"grouped_scan_f32": "adc4", "grouped_scan8": "adc8", "flat_scan": "flat_qadc",
           "flat_scan_f32": "flat_adc4", "flat_scan8": "flat_adc8",
           "flat_scan_window": "window_scan", "flat_scan_window_regs": "window_scan",
           "flat_scan_window_f32": "window_scan", "flat_scan_window_f32_lookup": "window_scan",
           "flat_scan_f32_lookup": "flat_adc4", "flat_scan8_lookup": "flat_adc8",
           "scan_lab": "scan_lab", "selector_sum": "scan_lab", "empty_kernel": "scan_lab"}
# The trained phase (bench.py:_bench_recall_parity): sizes, the keep of the
# reference's -k 0.213 (% of N; per partition here), and the recall floors:
# the JAX package's 1M record (0.9063 / 0.9844 / 0.9141) less 0.035 for 128
# queries and another PRNG.
TRAIN_N, TRAIN_LEARN, TRAIN_NQ, TRAIN_BATCH = 1_000_000, 100_000, 128, 32
TRAIN_KEEP = 0.00213 * 4
RECALL_FLOORS = {"flat_8x8_adc": 0.87, "ivf256_8x8_adc_ma24": 0.95,
                 "ivf256_16x4_qadc_ma24": 0.88}
WINDOW_N32 = 100_000     # codes of the 32x4 window-scan index
# The workflow phases (7): the reference's create-index / add / query on
# SIFT1M-sized files through the port's CLI, engine, server and autotune.
CLI_NQ, CLI_BATCH, FLAT_CLI_BATCH, GT_K, GT_CHUNK = 10_000, 32, 128, 100, 500
CLI_KEEP_PCT = TRAIN_KEEP * 100          # -k is in percent: 0.852
CLI_CHUNK = 262_144                      # add's --chunk-size
SERVE_REQUESTS, SERVE_THREADS, SERVE_BATCH, SERVE_WAIT_MS = 2000, 8, 128, 2.0
SERVE_RTOL = 1e-6
CROSSOVER_BATCHES, CROSSOVER_REPS = (1, 2, 4, 8, 16, 32, 64, 128), 30
M3_ROUNDS = (1, 2, 4)    # rounds a direct_scan block, fixed in turns at each M3 shape
# The sharded phase (8): a mesh of SHARDS shards on the one card (and of 2 for
# the reshard), timed over SHARDED_REPS runs; the Deep100M geometry of
# benchmarks/deep100m_v2.py:38-58 (IVF-4096, dim 96, 16x4 PQ, 100M codes).
SHARDS, SHARDED_REPS, SHARDED_RTOL = 4, 30, 1e-6
SHARDED_IVF_BATCHES = (32, 128)
DEEP_PARTS, DEEP_DIM, DEEP_M, DEEP_N = 4096, 96, 16, 100_000_000
DEEP_BATCHES, DEEP_ORACLE_NQ = (32, 512), 8
# The sharded phase's search paths (phase 8).
SHARDED_PATHS = tuple(p for p in PATH_KERNELS if p.startswith("sharded_"))
# Phase 9: the example's floor (the JAX example's recall on its stand-in on
# the CPU, 0.7930, less 0.035), the GIST1M geometry (TexMex: 1M base vectors
# of dim 960, 1,000 queries; the learn set the first 100,000, as
# benchmarks/recall_curves.py takes it; IVF keep 0.852%), and 16-bit
# training (8x16 PQ on 4 K = 262,144 vectors, the JAX default iterations).
EXAMPLE_FLOOR = 0.758
GIST_N, GIST_NQ, GIST_LEARN, GIST_IVF_KEEP = 1_000_000, 1_000, 100_000, 0.00852
SIXTEEN_LEARN, SIXTEEN_ITERS = 262_144, 50
# CUDA kernels torch.profiler must see launched by each workflow, sharded and
# phase 9 path (gist_*: at b=32; _b128 and _b1 at those batches).
PROFILED_KERNELS = {
    "cli_ivf_qadc": ("grouped_scan_mma_kernel", "rows_adc_kernel"),
    "cli_ivf_adc": ("grouped_scan_sm_kernel", "rows_adc_kernel"),
    "cli_flat_qadc": ("flat_scan_wgmma_kernel", "rows_adc_kernel"),
    "engine": ("grouped_scan_mma_kernel", "rows_adc_kernel"),
    "serve": ("grouped_scan_mma_kernel", "rows_adc_kernel", "direct_scan_kernel"),
    "sharded_ivf": ("grouped_scan_mma_kernel", "rows_adc_kernel"),
    "sharded_checkpoint": ("grouped_scan_mma_kernel", "rows_adc_kernel"),
    "sharded_flat_qadc": ("flat_scan_wgmma_kernel", "rows_adc_kernel"),
    "sharded_flat_adc4": ("flat_scan_qm_kernel", "rows_adc_kernel"),
    "sharded_flat_adc8": (),
    "sharded_query_parallel": ("grouped_scan_mma_kernel", "rows_adc_kernel"),
    "sharded_deep100m": ("grouped_scan_mma_kernel", "rows_adc_kernel"),
    "example": ("grouped_scan_mma_kernel", "rows_adc_kernel"),
    "gist_flat_adc8": ("flat_scan8_qm_kernel",),
    "gist_flat_qadc": ("flat_scan_mma_kernel", "rows_adc_kernel"),          # b=32
    "gist_flat_qadc_b128": ("flat_scan_wgmma_kernel", "rows_adc_kernel"),
    "gist_ivf_adc8": ("grouped_scan8_sm_kernel",),
    "gist_ivf_qadc": ("grouped_scan_mma_kernel", "rows_adc_kernel"),
    "gist_ivf_qadc_b1": ("direct_scan_kernel",),
}


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi clocks.max.sm), in Hz."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    return float(out) * 1e6


def time_ms(torch, fn, reps: int = REPS) -> tuple[float, float]:
    """(median, p90) milliseconds of one call over `reps` runs, by CUDA events
    around each call, after a warm-up."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), statistics.quantiles(times, n=10)[-1]


def device_ms(torch, fn, kernel: str | None = None, reps: int = REPS) -> float:
    """Device milliseconds of one call from torch.profiler's CUDA events:
    the named kernel's time, or all of the call's kernels and copies."""
    return profiled(torch, fn, kernel, reps)[0]


def profiled(torch, fn, kernel: str | None = None, reps: int = REPS) -> tuple[float, int]:
    """(device milliseconds of one call, kernel launches the profiler
    recorded in `reps` calls): device_ms and the count behind its mean."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    for _ in range(3):  # on a busy host a whole window can come back empty: take it again
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.key)]
        total = sum(e.self_device_time_total for e in events)
        if total > 0:
            break
    check(total > 0, f"profiler saw no device time in three windows ({kernel or 'all'})")
    count = sum(e.count for e in events)
    if kernel is None:
        return total / reps / 1e3, count
    # A named kernel: the mean over the launches the profiler recorded (on a
    # busy host it drops some), times the launches one call makes.
    return total / count * max(1, round(count / reps)) / 1e3, count


def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested tuples, None and flags allowed)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif t is not None and not isinstance(t, bool):
            total += t.numel() * t.element_size()
    return total


def bound_ms(moved: int, ops: int, peak_ops: float) -> tuple[float, str]:
    """The least milliseconds the card could take: bytes over its memory
    rate or operations over their peak rate, whichever is larger."""
    by_bytes, by_ops = moved / PEAK_BYTES, ops / peak_ops
    return max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def overlap(a, b) -> float:
    """Mean size of the intersection of the label rows of a and b."""
    return sum(len(set(x) & set(y)) for x, y in zip(a.tolist(), b.tolist())) / len(a)


def inf_float_err(torch, got, want, what: str) -> float:
    """float_err over the finite entries; +inf placement must be equal."""
    fin = torch.isfinite(want)
    check(torch.equal(torch.isfinite(got), fin), f"{what}: +inf placement")
    return float_err(torch, got[fin], want[fin], what)


def float_err(torch, got, want, what: str) -> float:
    """Max abs error of got vs want; raises outside RTOL / ATOL_REL."""
    atol = ATOL_REL * float(want.abs().max().clamp(min=1.0))
    torch.testing.assert_close(got, want, rtol=RTOL, atol=atol,
                               msg=lambda m: f"{what}: {m}")
    return float((got - want).abs().max())


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    repo = Path(__file__).resolve().parent
    if not (repo / "qadc_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(repo))

    import numpy as np

    from qadc_tpu_torch.convert import flat_index_from_arrays, ivf_index_from_arrays
    from qadc_tpu_torch.core.layout import code_view
    from qadc_tpu_torch.core.packing import unpack_codes
    from qadc_tpu_torch.eval.recall import recall_at_r
    from qadc_tpu_torch.eval.synth import (bench_flat_arrays, bench_ivf8_arrays,
                                           bench_ivf16_arrays, bench_ivf_arrays,
                                           sift_moment_sampler)
    from qadc_tpu_torch.index import flat, ivf
    from qadc_tpu_torch.index.routing import route_queries
    from qadc_tpu_torch.io.checkpoint import load_index, save_index
    from qadc_tpu_torch.kernels import build, lut_scan, scan_lab
    from qadc_tpu_torch.kernels.scan_ref import adc_scan_int8, scan_topk_int8
    from qadc_tpu_torch.ops.knn import assign_nearest
    from qadc_tpu_torch.ops.topk import exact_tile_screen
    from qadc_tpu_torch.quantizers.opq import train_opq
    from qadc_tpu_torch.quantizers.pq import train_pq

    t_start = time.perf_counter()
    # Files, indexes and the autotune cache of this run live here only.
    workdir = tempfile.TemporaryDirectory(prefix="qadc_smoke_")
    os.environ["QADC_AUTOTUNE_CACHE"] = os.path.join(workdir.name, "autotune.json")
    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(device)}", flush=True)

    t0 = time.perf_counter()
    lib_path, log = build.build()
    build.library()
    print(f"build: {time.perf_counter() - t0:.1f} s -> {lib_path.name}", flush=True)
    for name, args, spill, regs in re.findall(
            r"Compiling entry function '\w*?\d((?:[a-z]+8?_)+kernel)I(\w+?)EEv\w*' for.*?"
            r"(\d+ bytes spill stores, \d+ bytes spill loads).*?Used (\d+) registers",
            log, flags=re.S):
        print(f"  ptxas {name}<{args}>: {regs} registers, {spill}")

    rng = np.random.default_rng(0)
    arrays, manifest = bench_ivf_arrays(rng)
    index = ivf_index_from_arrays(arrays, manifest, device)
    queries = {b: torch.from_numpy(rng.normal(size=(b, 128)).astype(np.float32)).to(device)
               for b in BATCHES}
    print(f"index: P={index.part_count} part_pad={index.part_pad} n={index.n} "
          f"codes={index.codes.numel() / 1e6:.1f} MB", flush=True)
    prefix_pad = min(max(1, int(index.max_part_size * KEEP)), index.part_pad)

    # ---- 1. kernel phases at the search's shapes --------------------------
    kernels = {}

    def kernel_phase(name, cu_name, source, replaces, kernel_fn, plain_fn, compare,
                     in_bytes, ops, peak, library_fn=None, reps=REPS, path=None):
        """Hold a kernel to its plain version, time both, and bound it:
        in_bytes are the input bytes the function must read (the outputs'
        are added here), ops its additions, peak their peak rate. A lab mode
        whose output nothing defines has no plain_fn: its error and plain
        times are null. library_fn: the one PyTorch call that computes the
        same function, where there is one (no such call computes a LUT scan).
        path: the search path whose run gives the row its launch count
        (default: PATH_OF by the kernel's name)."""
        got = kernel_fn()
        torch.cuda.synchronize()
        err = plain_ms = plain_call_ms = None
        if plain_fn is not None:
            want = plain_fn()
            torch.cuda.synchronize()
            err = compare(got, want)
            del want
        # ms: device time (the kernel alone; all of the plain version's
        # kernels); call_ms: CUDA events around one call, host work included.
        ms, recorded = profiled(torch, kernel_fn, cu_name, reps)
        check(recorded > 0, f"kernel {name}: the profiler recorded no launch of {cu_name}")
        call_ms = time_ms(torch, kernel_fn, reps)[0]
        if plain_fn is not None:
            plain_ms = device_ms(torch, plain_fn, reps=PLAIN_REPS)
            plain_call_ms = time_ms(torch, plain_fn, PLAIN_REPS)[0]
        library_ms = None if library_fn is None else device_ms(torch, library_fn)
        least, by = bound_ms(in_bytes + nbytes(got), ops, peak)
        kernels[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": least, "bound_by": by,
                         "library_ms": library_ms, "profiled_launches": recorded,
                         "call_ms": call_ms, "plain_call_ms": plain_call_ms, "path": path}
        check(ms >= least, f"kernel {name}: {ms} ms is below its bound {least}")
        fmt = lambda x: "none" if x is None else f"{x:.4g}"  # noqa: E731
        print(f"kernel {name}: max_abs_err={fmt(err)} device ms={ms:.4f} over {recorded} recorded "
              f"launches (plain {fmt(plain_ms)}; "
              f"bound {least:.4f} by {by}; library {fmt(library_ms)}) call ms={call_ms:.4f} "
              f"(plain {fmt(plain_call_ms)}) [{card}]", flush=True)

    qb = queries[128]
    parts, tables, qtables, (tlo, thi) = ivf._quantized_tables(
        index, qb, R, MA, KEEP, prefix_pad, lut_scan.DISPATCH)
    qa = qb.shape[0] * MA
    routed = route_queries(parts, index.part_count, 128)
    m1_args = (index.codes, qtables.reshape(qa, 16, 16), routed.group_part,
               routed.slot_pairs(), ivf._group_sizes(index, routed))

    def grouped_work(ix, probes, tables_, groups):
        """(input bytes, additions) of a grouped scan: each probed partition
        once, the tables and the routing; a sum per pair and real code."""
        part_bytes = ix.codes.shape[1] * 128
        moved = torch.unique(probes).numel() * part_bytes + nbytes(tables_, *groups)
        adds = int(ix.part_sizes[probes.reshape(-1).long()].sum()) * ix.pq.sq_count
        return moved, adds

    def exact_int(got, want):
        pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
        check(all(torch.equal(a, b) for a, b in pairs), "grouped_scan differs from its plain version")
        return 0.0

    # M1 at the routed groups of b=128 (the name the main path counts) and
    # b=32.
    q32 = queries[32]
    parts32, _, qtables32, _ = ivf._quantized_tables(index, q32, R, MA, KEEP, prefix_pad,
                                                     lut_scan.DISPATCH)
    routed32 = route_queries(parts32, index.part_count, 128)
    m1_args32 = (index.codes, qtables32.reshape(q32.shape[0] * MA, 16, 16), routed32.group_part,
                 routed32.slot_pairs(), ivf._group_sizes(index, routed32))
    for tag, args, probes in (("", m1_args, parts), ("[b=32]", m1_args32, parts32)):
        check(torch.equal(lut_scan.grouped_scan(*args), lut_scan.grouped_scan_onehot_plain(*args)),
              f"grouped_scan{tag} differs from its one-hot plain version")
        kernel_phase("grouped_scan" + tag, "grouped_scan_mma_kernel",
                     "qadc_tpu_torch/csrc/scan_mma.cu", "qadc_tpu/kernels/lut_scan.py:857",
                     lambda args=args: lut_scan.grouped_scan(*args),
                     lambda args=args: lut_scan.grouped_scan_plain(*args), exact_int,
                     *grouped_work(index, probes, args[1], args[2:]), PEAK_INT8)

    # M1 at Deep100M's geometry (the benchmark's deep100m-ivf-b512 cell):
    # b=512 x ma=24 probes of 4096 lists, G=128, list sizes drawn (gamma,
    # shape 4) to a mean of DEEP_N / DEEP_PARTS = 24,414 codes, part_pad
    # the largest rounded up to ivf.PART_ALIGN (~70k, as the real build's:
    # the largest list ~3x the mean), random distinct probes and int8
    # tables; 2.3 GB of codes in HBM. With the tile minima, as the search
    # there asks (its screen tiles). The bound counts the real codes of
    # the probed lists once (M1 reads no padded code), the tables, the
    # routing and the (QA, rpp) output and its tile minima.
    gen = torch.Generator(device=device)
    gen.manual_seed(20)
    deep_sizes = torch.from_numpy(np.maximum(1, np.random.default_rng(20).gamma(
        4.0, DEEP_N / DEEP_PARTS / 4.0, DEEP_PARTS)).round().astype(np.int32)).to(device)
    deep_pad = -(-int(deep_sizes.max()) // ivf.PART_ALIGN) * ivf.PART_ALIGN
    deep_codes = torch.randint(0, 256, (DEEP_PARTS, deep_pad // 16, 128), dtype=torch.uint8,
                               device=device, generator=gen)
    deep_probes = torch.multinomial(torch.ones(DEEP_BATCHES[-1], DEEP_PARTS, device=device), MA,
                                    generator=gen).to(torch.int32)
    deep_routed = route_queries(deep_probes, DEEP_PARTS, 128)
    deep_qa = deep_probes.numel()
    deep_args = (deep_codes,
                 torch.randint(0, 128, (deep_qa, 16, 16), dtype=torch.int8, device=device,
                               generator=gen),
                 deep_routed.group_part, deep_routed.slot_pairs(),
                 torch.where(deep_routed.group_valid,
                             deep_sizes[deep_routed.group_part.long()], 0).to(torch.int32))
    probed = torch.unique(deep_probes.long())
    deep_real = int(((deep_sizes[probed].long() + 15) // 16).sum()) * 128
    print(f"M1 deep100m: b={DEEP_BATCHES[-1]} ma={MA} P={DEEP_PARTS} part_pad={deep_pad} "
          f"mean list {float(deep_sizes.float().mean()):.0f}, {probed.numel()} lists probed, "
          f"{deep_real / 1e9:.3f} GB of real codes, {deep_routed.gcap} groups "
          f"({int(deep_routed.n_groups)} live)", flush=True)
    kernel_phase("grouped_scan[deep b=512]", "grouped_scan_mma_kernel",
                 "qadc_tpu_torch/csrc/scan_mma.cu", "qadc_tpu/kernels/lut_scan.py:857",
                 lambda: lut_scan.grouped_scan(*deep_args, True),
                 lambda: lut_scan.grouped_scan_plain(*deep_args, True), exact_int,
                 deep_real + nbytes(*deep_args[1:]),
                 int(deep_sizes[deep_probes.long()].sum()) * 16, PEAK_INT8)
    del deep_codes, deep_args
    torch.cuda.empty_cache()

    # M3 at the pairs the direct path hands it (a Kernels whose direct_scan
    # keeps its arguments): b=1, and b=32 and 128 forced direct.
    def recorded_m3(ix, qs):
        calls = []

        def direct_scan(*args):
            calls.append(args)
            return lut_scan.direct_scan(*args)

        ivf.search_qadc(ix, qs, r=R, ma=MA, keep=KEEP, direct=True,
                        kernels=lut_scan.DISPATCH._replace(direct_scan=direct_scan))
        torch.cuda.synchronize()
        check(len(calls) == 1, f"{len(calls)} direct_scan launches in one direct search")
        return calls[0]

    def direct_exact(got, want):
        (gd, gm), (wd, wm) = got, want
        check(torch.equal(gd == lut_scan.MASK_BIG, wd == lut_scan.MASK_BIG),
              "direct_scan MASK_BIG placement")
        check(torch.equal(gd, wd) and torch.equal(gm, wm),
              "direct_scan distances or tile minima differ from the plain version")
        return 0.0

    m3_src = "qadc_tpu_torch/csrc/rows_adc.cu"

    def m3_phases(ix, tag, m3_args, path):
        """M3 at one shape: the kernel timed beside the plain version and the
        bound (each probed partition's codes read once, tables, ids and sizes;
        distances and minima written once), then at fixed rounds a block."""
        pp = m3_args[1]
        moved = torch.unique(pp).numel() * ix.codes.shape[1] * 128 + nbytes(*m3_args[1:])
        rounds = lut_scan.direct_scan_rounds(pp.shape[0], ix.part_pad,
                                             torch.cuda.get_device_properties(device)
                                             .multi_processor_count)
        print(f"direct_scan [{tag}]: {pp.shape[0]} pairs x part_pad {ix.part_pad}, "
              f"{torch.unique(pp).numel()} partitions, {rounds} rounds a block", flush=True)
        kernel_phase("direct_scan" if tag == "b=1" else f"direct_scan[{tag}]",
                     "direct_scan_kernel", m3_src, "qadc_tpu/kernels/lut_scan.py:1206",
                     lambda: lut_scan.direct_scan(*m3_args),
                     lambda: lut_scan.direct_scan_plain(*m3_args), direct_exact,
                     moved, int(m3_args[4].sum()) * ix.pq.sq_count, PEAK_F32, path=path)
        # The rounds a block fixed at each of M3_ROUNDS in turns, twice (the
        # readings behind lut_scan.direct_scan_rounds), each equal to the plain
        # version.
        want = lut_scan.direct_scan_plain(*m3_args)
        rule, sweep = lut_scan.direct_scan_rounds, {r: [] for r in M3_ROUNDS}
        try:
            for _ in range(2):
                for r in M3_ROUNDS:
                    lut_scan.direct_scan_rounds = lambda qa, part_pad, sms, r=r: r
                    got = lut_scan.direct_scan(*m3_args)
                    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                          f"direct_scan[{tag}] at {r} rounds differs from its plain version")
                    sweep[r].append(device_ms(torch, lambda: lut_scan.direct_scan(*m3_args),
                                              "direct_scan_kernel"))
        finally:
            lut_scan.direct_scan_rounds = rule
        del got, want
        m3_rounds[tag] = {"rule": rounds, **sweep}
        print(f"direct_scan [{tag}] device ms at fixed rounds, two turns: " + "; ".join(
            f"{r}: {v[0]:.5f} / {v[1]:.5f}" for r, v in sweep.items())
            + f" (the rule picks {rounds}) [{card}]", flush=True)

    m3_rounds = {}
    for b in BATCHES:
        m3_phases(index, f"b={b}", recorded_m3(index, queries[b]),
                  "qadc" if b == 1 else "qadc_direct")

    # search_adc's kernels at its b=32 groups: M1 with float tables on the
    # 16x4 index, grouped_scan8 with bf16 tables on the 8x8 index.
    adc_indexes = {bits: ivf_index_from_arrays(*make(rng), device) for bits, make in
                   ((8, bench_ivf8_arrays), (16, bench_ivf16_arrays))}
    adc_indexes[4] = index
    qadc = queries[ADC_BATCH]
    gen_hot = torch.Generator(device=device).manual_seed(3)

    def adc_group_args(ix, qs):
        p, rot = ivf.assign_queries(ix, qs, MA)
        t = ivf.adc_tables(rot, ix.pq.centroids).reshape(qs.shape[0] * MA, ix.pq.sq_count, -1)
        rt = route_queries(p, ix.part_count, 128)
        return p, t, (rt.group_part, rt.slot_pairs(), ivf._group_sizes(ix, rt))

    # The slot-minor kernels (grouped_scan_f32, grouped_scan8) at three
    # routings: search_adc's b=32 groups (~3 live slots), b=128's (~12), and
    # a hot partition: 128 near-duplicate queries, so each of their 24 probed
    # partitions fills a whole group of 128 live slots.
    hot = queries[1] + 1e-3 * torch.randn((128, 128), generator=gen_hot, device=device)
    grouped_shapes = {"b=32": qadc, "b=128": queries[128], "hot": hot}
    f32_src = "qadc_tpu_torch/csrc/grouped_scan_sm.cu"
    u8_src = "qadc_tpu_torch/csrc/grouped_scan8_sm.cu"

    def scan8_err(got, want):
        (gv, gi), (wv, wi) = got, want
        err = inf_float_err(torch, gv, wv, "grouped_scan8 minima")
        same = gv == wv  # where the minima agree bit for bit, so must the argmin
        check(torch.equal(gi[same], wi[same]), "grouped_scan8 argmin indices")
        return err

    grouped_args = {}
    for tag, qs in grouped_shapes.items():
        for bits, ix in ((4, index), (8, adc_indexes[8])):
            p, t, groups = adc_group_args(ix, qs)
            args = (ix.codes, t if bits == 4 else t.to(torch.bfloat16), *groups)
            grouped_args[bits, tag] = args, p
            live = (groups[1] >= 0).sum(1)
            mean = float(live[live > 0].float().mean())
            print(f"grouped {bits}-bit [{tag}]: {int((live > 0).sum())} live groups of "
                  f"{groups[1].shape[0]}, live slots mean {mean:.2f} max {int(live.max())}",
                  flush=True)
            # The kernel equals its own walk in PyTorch bit for bit, minima and
            # argmin ids (the plain versions: the kernel phases).
            if bits == 4:
                got = lut_scan.grouped_scan(*args)
                walk = lut_scan.grouped_scan_slot_minor_plain(*args)
                check(torch.equal(got, walk),
                      f"grouped_scan_f32[{tag}] differs from its slot-minor walk")
            else:
                got = lut_scan.grouped_scan8(*args)
                walk = lut_scan.grouped_scan8_slot_minor_plain(*args)
                check(all(torch.equal(a, b) for a, b in zip(got, walk)),
                      f"grouped_scan8[{tag}] differs from its slot-minor walk")
            del got, walk
            suffix = "" if tag == "b=32" else f"[{tag}]"
            if bits == 4:
                name, fn, cu_name, src = ("grouped_scan_f32", lut_scan.grouped_scan,
                                          "grouped_scan_sm_kernel", f32_src)
                plain = lut_scan.grouped_scan_plain
                compare = lambda got, want: inf_float_err(  # noqa: E731
                    torch, got, want, "grouped_scan_f32")
                replaces = "qadc_tpu/kernels/lut_scan.py:857"
            else:
                name, fn, cu_name, src = ("grouped_scan8", lut_scan.grouped_scan8,
                                          "grouped_scan8_sm_kernel", u8_src)
                plain, compare = lut_scan.grouped_scan8_plain, scan8_err
                replaces = "qadc_tpu/kernels/lut_scan.py:1872"
            kernel_phase(name + suffix, cu_name, src, replaces,
                         lambda fn=fn, args=args: fn(*args),
                         lambda plain=plain, args=args: plain(*args), compare,
                         *grouped_work(ix, p, args[1], groups), PEAK_F32)
    m1f_args, m8_args = grouped_args[4, "b=32"][0], grouped_args[8, "b=32"][0]

    # The flat scans over the 1M-code flat indexes, at their searches' shapes.
    flat_indexes = {bits: flat_index_from_arrays(*bench_flat_arrays(rng, m, bits, FLAT_N), device)
                    for m, bits in ((16, 4), (8, 8), (8, 16))}
    fq = {b: torch.from_numpy(rng.normal(size=(b, 128)).astype(np.float32)).to(device)
          for b in sorted(set(FLAT_BATCH.values()))}
    fi4, fi8 = flat_indexes[4], flat_indexes[8]
    print(f"flat indexes: n={fi4.n} n_pad={fi4.n_pad} codes={fi4.codes.numel() / 1e6:.1f} / "
          f"{fi8.codes.numel() / 1e6:.1f} / {flat_indexes[16].codes.numel() / 1e6:.1f} MB",
          flush=True)
    _, fqt, _ = flat._quantized_tables(fi4, fq[128], R, FLAT_KEEP, lut_scan.DISPATCH)
    ft4 = ivf.adc_tables(fq[128], fi4.pq.centroids)
    ft8 = ivf.adc_tables(fq[32], fi8.pq.centroids).to(torch.bfloat16)

    def flat_rows_exact(got, want):
        check(torch.equal(got[0], want[0]), "flat_scan minima differ from its plain version")
        check(got[1] is want[1] is None or torch.equal(got[1], want[1]),
              "flat_scan argmin rows differ")
        return 0.0

    def argmin_err(what):
        def err(got, want):
            (gv, gi), (wv, wi) = got, want
            e = inf_float_err(torch, gv, wv, f"{what} minima")
            same = gv == wv  # where the minima agree bit for bit, so must the argmin
            check(torch.equal(gi[same], wi[same]), f"{what} argmin indices")
            return e
        return err

    def flat_work(codes, tables_, n):
        """(input bytes, additions, peak) of a flat scan: the codes and the
        tables once; a sum per (query, real code) over every sub-quantizer."""
        peak = PEAK_INT8 if tables_.dtype == torch.int8 else PEAK_F32
        return nbytes(codes, tables_), tables_.shape[0] * n * tables_.shape[1], peak

    for got, want in zip(lut_scan.flat_scan(fi4.codes, fqt, fi4.n, True),
                         lut_scan.scan_onehot_plain(fi4.codes, fqt, fi4.n, True)):
        check(torch.equal(got, want), "flat_scan differs from its one-hot plain version")
    del got, want
    # At 128 queries flat_scan's int8 kernel is the warpgroup one, at 32 the
    # mma.sync one (lut_scan.WGMMA_MIN_QUERIES).
    fqt32 = fqt[:32].contiguous()
    check(fqt.shape[0] >= lut_scan.WGMMA_MIN_QUERIES > fqt32.shape[0], "flat_scan kernel choice")
    # With float tables at 128 queries and for flat_scan8 at 32 the kernels are
    # the query-minor ones; each equals the kernel it replaced and its own
    # walk in PyTorch bit for bit, minima and argmin ids.
    check(ft4.shape[0] >= lut_scan.QUERY_MINOR_MIN_QUERIES
          and ft8.shape[0] >= lut_scan.QUERY_MINOR_MIN_QUERIES8, "query-minor kernel choice")
    got4 = lut_scan.flat_scan(fi4.codes, ft4, fi4.n, True)
    got8 = lut_scan.flat_scan8(fi8.codes, ft8, fi8.n)
    for what, got, others in (
        ("flat_scan_f32", got4, (lut_scan.flat_scan_f32_lookup(fi4.codes, ft4, fi4.n, True),
                                 lut_scan.flat_scan_query_minor_plain(fi4.codes, ft4, fi4.n, True))),
        ("flat_scan8", got8, (lut_scan.flat_scan8_lookup(fi8.codes, ft8, fi8.n),
                              lut_scan.flat_scan8_query_minor_plain(fi8.codes, ft8, fi8.n))),
    ):
        for other, want in zip(("the kernel it replaced", "its query-minor plain version"), others):
            check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
                  f"{what} differs from {other}")
    check(torch.equal(lut_scan.flat_scan(fi4.codes, ft4, fi4.n)[0], got4[0]),
          "flat_scan_f32 minima differ with and without rows")
    del got4, got8, got, others, want
    wgmma = ("flat_scan_wgmma_kernel", "scan_wgmma.cu")
    mma, lookup = ("flat_scan_mma_kernel", "scan_mma.cu"), ("flat_scan_kernel", "flat_scan.cu")
    query_minor = ("flat_scan_qm_kernel", "flat_scan_qm.cuh")
    f32_err = lambda got, want: inf_float_err(torch, got[0], want[0], "flat_scan_f32")  # noqa: E731
    for name, fn, (cu_name, src), args, compare, replaces in (
        ("flat_scan", lut_scan.flat_scan, wgmma, (fi4.codes, fqt, fi4.n), flat_rows_exact, 522),
        ("flat_scan[with_rows]", lut_scan.flat_scan, wgmma, (fi4.codes, fqt, fi4.n, True),
         flat_rows_exact, 281),
        ("flat_scan[b=32]", lut_scan.flat_scan, mma, (fi4.codes, fqt32, fi4.n), flat_rows_exact,
         522),
        ("flat_scan_f32", lut_scan.flat_scan, query_minor, (fi4.codes, ft4, fi4.n), f32_err, 522),
        ("flat_scan_f32_lookup", lut_scan.flat_scan_f32_lookup, lookup, (fi4.codes, ft4, fi4.n),
         f32_err, 522),
    ):
        kernel_phase(name, cu_name, f"qadc_tpu_torch/csrc/{src}",
                     f"qadc_tpu/kernels/lut_scan.py:{replaces}",
                     lambda fn=fn, a=args: fn(*a),
                     lambda a=args: lut_scan.flat_scan_plain(*a), compare,
                     *flat_work(*args[:3]),
                     reps=LAB_REPS if name == "flat_scan_f32_lookup" else REPS)
    for name, fn, cu_name, src in (
        ("flat_scan8", lut_scan.flat_scan8, "flat_scan8_qm_kernel", "flat_scan8_qm.cuh"),
        ("flat_scan8_lookup", lut_scan.flat_scan8_lookup, "flat_scan8_kernel", "flat_scan8.cu"),
    ):
        kernel_phase(name, cu_name, f"qadc_tpu_torch/csrc/{src}",
                     "qadc_tpu/kernels/lut_scan.py:1601",
                     lambda fn=fn: fn(fi8.codes, ft8, fi8.n),
                     lambda: lut_scan.flat_scan8_plain(fi8.codes, ft8, fi8.n),
                     argmin_err(name), *flat_work(fi8.codes, ft8, fi8.n),
                     reps=LAB_REPS if name == "flat_scan8_lookup" else REPS)

    # M2 at the id lists the searches hand it: a Kernels whose rows_adc
    # records each launch's arguments, then calls the real one. The staged
    # kernel at each, and at random rerank ids (no runs: the worst case).
    def recorded_m2(run):
        calls = []

        def rows_adc(*args):
            calls.append(args)
            return lut_scan.rows_adc(*args)

        run(lut_scan.DISPATCH._replace(rows_adc=rows_adc))
        torch.cuda.synchronize()
        return calls

    m2_runs = {
        "ivf b=128": ("qadc", ("keep-prefix", "rerank"), lambda k: ivf.search_qadc(
            index, qb, r=R, ma=MA, keep=KEEP, kernels=k)),
        "ivf b=32": ("qadc", ("keep-prefix", "rerank"), lambda k: ivf.search_qadc(
            index, q32, r=R, ma=MA, keep=KEEP, kernels=k)),
        "flat b=128": ("flat_qadc", ("keep-prefix", "rerank"), lambda k: flat.search_qadc(
            fi4, fq[FLAT_BATCH["flat_qadc"]], r=R, keep=FLAT_KEEP, kernels=k)),
        "adc4 b=32": ("adc4", ("rerank",), lambda k: ivf.search_adc(
            index, queries[ADC_BATCH], r=R, ma=MA, kernels=k)),
    }
    m2_shapes = []
    for tag, (path, stages, run) in m2_runs.items():
        calls = recorded_m2(run)
        check(len(calls) == len(stages), f"{tag}: {len(calls)} rows_adc launches, not {len(stages)}")
        m2_shapes += [(f"{tag} {stage}", path, args) for stage, args in zip(stages, calls)]
    gen = torch.Generator(device=device).manual_seed(0)
    flat_rows = index.codes.reshape(-1, 128)
    a_rand = qb.shape[0] * R
    m2_shapes.append(("random", "qadc", (
        flat_rows,
        torch.randint(0, flat_rows.shape[0], (a_rand,), generator=gen, device=device,
                      dtype=torch.int32),
        torch.randint(0, qa, (a_rand,), generator=gen, device=device, dtype=torch.int32),
        tlo, thi)))

    def m2_exact(what):
        def compare(got, want):
            check(torch.equal(got, want), f"{what} differs from rows_adc_plain")
            return 0.0
        return compare

    m2_src = "qadc_tpu_torch/csrc/rows_adc.cu"
    for shape, path, m2_args in m2_shapes:
        row_ids, pair_ids = m2_args[1:3]
        cpr = 128 // (m2_args[3].shape[1] // 16)
        check(torch.equal(lut_scan.rows_adc(*m2_args), lut_scan.rows_adc_staged_plain(*m2_args)),
              f"rows_adc[{shape}] differs from its staged walk")
        runs = lut_scan.rows_adc_runs(pair_ids)[0].sum(1).float()
        a = row_ids.shape[0]
        print(f"rows_adc [{shape}]: A={a}, {torch.unique(row_ids).numel()} rows, "
              f"{torch.unique(pair_ids).numel()} pairs, runs a tile of "
              f"{lut_scan.ROWS_ADC_TILE}: mean {float(runs.mean()):.2f} max {int(runs.max())}",
              flush=True)
        # each scored row and referenced table once, the two id lists
        moved = (torch.unique(row_ids).numel() * 128 + nbytes(row_ids, pair_ids)
                 + torch.unique(pair_ids).numel() * 2 * m2_args[3].shape[1] * 4)
        name = ("keep-prefix" if shape == "ivf b=128 keep-prefix" else
                "rerank" if shape == "random" else shape)
        kernel_phase(f"rows_adc[{name} A={a}]", "rows_adc_kernel", m2_src,
                     "qadc_tpu/kernels/lut_scan.py:1148",
                     lambda m2_args=m2_args: lut_scan.rows_adc(*m2_args),
                     lambda m2_args=m2_args: lut_scan.rows_adc_plain(*m2_args),
                     m2_exact("rows_adc"), moved, a * cpr * index.pq.sq_count, PEAK_F32,
                     path=path)

    # ---- 2. the main path, through the kernels -----------------------------
    def search(b, kernels_=lut_scan.DISPATCH):
        return ivf.search_qadc(index, queries[b], r=R, ma=MA, keep=KEEP, kernels=kernels_)

    torch.cuda.synchronize()
    lut_scan.reset_launch_counts()
    results = {b: search(b) for b in BATCHES}
    torch.cuda.synchronize()
    launches = {"qadc": dict(lut_scan.launches)}
    print(f"main path launches: {launches['qadc']}", flush=True)
    for name in PATH_KERNELS["qadc"]:
        check(launches["qadc"][name] > 0, f"kernel {name} was not launched by the main path")
    for name in LOOKUP_ONLY:
        check(launches["qadc"][name] == 0, f"the main path launched {name}")

    for b in BATCHES:
        d, lab = results[b]
        check(d.shape == (b, R) and lab.shape == (b, R), f"b={b}: result shape")
        check(bool(torch.isfinite(d).all()), f"b={b}: non-finite distances")
        check(bool((d[:, 1:] >= d[:, :-1]).all()), f"b={b}: distances not ascending")
        pd, pl = search(b, lut_scan.PLAIN)
        torch.testing.assert_close(d, pd, rtol=SEARCH_RTOL, atol=0.0,
                                   msg=lambda m: f"b={b}: kernels vs plain: {m}")
        same_top1 = bool(torch.equal(lab[:, 0], pl[:, 0]))
        plain_overlap = overlap(lab, pl)
        check(same_top1 and plain_overlap >= 98,
              f"b={b}: labels vs plain (overlap {plain_overlap})")

        od, ol = oracle(torch, index, queries[b], code_view, unpack_codes, ivf)
        if b == 1:  # direct path: exact float ADC, so its top-r is the oracle's
            torch.testing.assert_close(d.double(), od, rtol=SEARCH_RTOL, atol=0.0,
                                       msg=lambda m: f"b=1: direct vs oracle: {m}")
            err = float((d.double() - od).abs().max())
            print(f"search b=1: vs plain overlap={plain_overlap} | vs oracle "
                  f"max_abs_err={err:.3g}", flush=True)
        else:
            rec = recall_at_r(lab.cpu().numpy(), ol[:, :1].cpu().numpy())
            print(f"search b={b}: vs plain overlap={plain_overlap} | oracle top-1 "
                  f"recall@{R}={rec}", flush=True)
            check(rec >= MIN_ORACLE_RECALL, f"b={b}: oracle recall {rec}")

    # ---- 2b. search_adc at 4, 8 and 16 bits, b=32 ---------------------------
    def drive(path, fn):
        """One run of a search path with the launch counts reset just before
        and read just after; every kernel of the path must have launched."""
        torch.cuda.synchronize()
        lut_scan.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches[path] = dict(lut_scan.launches)
        print(f"{path} launches: {launches[path]}", flush=True)
        for name in PATH_KERNELS[path]:
            check(launches[path][name] > 0, f"kernel {name} was not launched by {path}")
        for name in LOOKUP_ONLY:  # threshold instruments: only the lab may launch them
            check(path == "scan_lab" or launches[path][name] == 0, f"{path} launched {name}")
        return out

    # The direct path forced at b=32 and 128 on the bench index, M3's larger
    # shapes: exact float ADC, so each top-r is the oracle's.
    forced = drive("qadc_direct", lambda: {
        b: ivf.search_qadc(index, queries[b], r=R, ma=MA, keep=KEEP, direct=True)
        for b in BATCHES[1:]})
    check(launches["qadc_direct"]["direct_scan"] == len(forced)
          and launches["qadc_direct"]["grouped_scan"] == 0, "qadc_direct: M3 launches")
    for b, (d, _) in forced.items():
        od, _ = oracle(torch, index, queries[b], code_view, unpack_codes, ivf)
        check(d.shape == (b, R), f"qadc_direct b={b}: result shape")
        torch.testing.assert_close(d.double(), od, rtol=SEARCH_RTOL, atol=0.0,
                                   msg=lambda m: f"qadc_direct b={b}: direct vs oracle: {m}")
        print(f"search qadc_direct b={b}: vs oracle max_abs_err="
              f"{float((d.double() - od).abs().max()):.3g}", flush=True)
    del forced

    def check_vs_plain(path, b, got, plain):
        (d, lab), (pd, pl) = got, plain
        check(d.shape == (b, R) and lab.shape == (b, R), f"{path}: shape")
        check(bool(torch.isfinite(d).all()), f"{path}: non-finite distances")
        check(bool((d[:, 1:] >= d[:, :-1]).all()), f"{path}: distances not ascending")
        torch.testing.assert_close(d, pd, rtol=SEARCH_RTOL, atol=0.0,
                                   msg=lambda m: f"{path}: kernels vs plain: {m}")
        plain_overlap = overlap(lab, pl)
        check(bool(torch.equal(lab[:, 0], pl[:, 0])) and plain_overlap >= 98,
              f"{path}: labels vs plain (overlap {plain_overlap})")
        return plain_overlap

    def check_vs_oracle(path, bits, got, want):
        """The adc checks against the float64 oracle; returns (top-1 equal,
        overlap@R). 4-bit: exact; 8-bit: top-1 kept and mean overlap >=
        MIN_ADC8_OVERLAP; 16-bit: top-1 equal and shared labels' distances."""
        (d, lab), (od, ol) = got, want
        ov = overlap(lab, ol)
        top1 = bool(torch.equal(lab[:, 0].long(), ol[:, 0]))
        if bits == 4:  # float minima are the rerank's distances: exact top-r
            torch.testing.assert_close(d.double(), od, rtol=SEARCH_RTOL, atol=0.0,
                                       msg=lambda m: f"{path} vs oracle: {m}")
        elif bits == 8:
            found = [a in set(x) for a, x in zip(ol[:, 0].tolist(), lab.tolist())]
            check(all(found), f"{path}: oracle top-1 missing for {found.count(False)} queries")
            check(ov >= MIN_ADC8_OVERLAP, f"{path}: oracle overlap {ov}")
        else:
            check(top1, f"{path}: top-1 differs from the oracle")
            dn, ln, odn, oln = (t.cpu().numpy() for t in (d, lab, od, ol))
            for qi in range(d.shape[0]):  # distances of the labels both hold
                _, i, j = np.intersect1d(ln[qi], oln[qi], return_indices=True)
                np.testing.assert_allclose(dn[qi, i], odn[qi, j], rtol=ADC16_RTOL,
                                           err_msg=f"{path} vs oracle, query {qi}")
        return top1, ov

    def search_adc(bits, kernels_=lut_scan.DISPATCH):
        return ivf.search_adc(adc_indexes[bits], qadc, r=R, ma=MA, kernels=kernels_)

    for bits in (4, 8, 16):
        path = f"adc{bits}"
        d, lab = got = drive(path, lambda: search_adc(bits))
        # One grouped scan a search, by the slot-minor kernel.
        for scan in PATH_KERNELS[path]:
            check(scan == "rows_adc" or launches[path][scan] == 1, f"{path}: {scan} launches")
        plain_overlap = check_vs_plain(path, ADC_BATCH, got, search_adc(bits, lut_scan.PLAIN))
        od, ol = want = oracle(torch, adc_indexes[bits], qadc, code_view, unpack_codes, ivf)
        top1, ov = check_vs_oracle(path, bits, got, want)
        err = float((d.double() - od).abs().max())
        print(f"search {path} b={ADC_BATCH}: vs plain overlap={plain_overlap} | vs oracle "
              f"top-1 equal={top1} overlap@{R}={ov} max_abs_err={err:.3g}", flush=True)

    # ---- 2c. the flat index: search_qadc, search_adc at 4, 8 and 16 bits ----
    flat_runs = {
        "flat_qadc": lambda k=lut_scan.DISPATCH: flat.search_qadc(
            fi4, fq[FLAT_BATCH["flat_qadc"]], r=R, keep=FLAT_KEEP, kernels=k),
        **{f"flat_adc{bits}": lambda k=lut_scan.DISPATCH, bits=bits: flat.search_adc(
            flat_indexes[bits], fq[FLAT_BATCH[f"flat_adc{bits}"]], r=R, kernels=k)
           for bits in (4, 8, 16)},
    }
    for path, run in flat_runs.items():
        b = FLAT_BATCH[path]
        bits = 4 if path == "flat_qadc" else int(path[len("flat_adc"):])
        d, lab = got = drive(path, run)
        # One scan a search: by the tensor-core kernel (flat_qadc), by the
        # query-minor kernels (flat_adc4, flat_adc8: batches at or over their thresholds).
        for scan in PATH_KERNELS[path]:
            check(scan == "rows_adc" or launches[path][scan] == 1, f"{path}: {scan} launches")
        plain_overlap = check_vs_plain(path, b, got, run(lut_scan.PLAIN))
        od, ol = want = flat_oracle(torch, flat_indexes[bits], fq[b], unpack_codes)
        if path == "flat_qadc":  # int8 screen: the oracle's top-1 in the top-R
            top1 = bool(torch.equal(lab[:, 0].long(), ol[:, 0]))
            ov = overlap(lab, ol)
            rec = recall_at_r(lab.cpu().numpy(), ol[:, :1].cpu().numpy())
            check(rec >= MIN_ORACLE_RECALL, f"{path}: oracle recall {rec}")
            what = f"oracle top-1 recall@{R}={rec}"
        else:
            top1, ov = check_vs_oracle(path, bits, got, want)
            what = f"top-1 equal={top1}"
        err = float((d.double() - od).abs().max())
        print(f"search {path} b={b}: vs plain overlap={plain_overlap} | vs oracle {what} "
              f"overlap@{R}={ov} max_abs_err={err:.3g}", flush=True)

    # ---- 3. end-to-end timing ----------------------------------------------
    def e2e(label, b, fn):
        ms, p90 = time_ms(torch, fn)
        busy = device_ms(torch, fn)
        print(f"e2e {label} b={b}: {ms * 1e3 / b:.2f} us/query median, {p90 * 1e3 / b:.2f} p90 "
              f"(n={REPS}; {ms:.4f} ms/batch; device busy {busy:.4f} ms/batch, idle share "
              f"{1 - busy / ms:.3f}) [{card}]", flush=True)

    for b in BATCHES:
        e2e("qadc", b, lambda: search(b))
    for b in BATCHES[1:]:  # the direct path where DIRECT_MAX_* choose the grouped one
        e2e("qadc direct", b, lambda: ivf.search_qadc(index, queries[b], r=R, ma=MA, keep=KEEP,
                                                      direct=True))
    for bits in (4, 8):
        e2e(f"adc{bits}", ADC_BATCH, lambda: search_adc(bits))
    for path, run in flat_runs.items():
        e2e(path, FLAT_BATCH[path], run)

    # ---- 4. train -> build -> save -> load -> search, 1M SIFT-like vectors ----
    def timed(label, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        print(f"{label}: {time.perf_counter() - t0:.2f} s [{card}]", flush=True)
        return out

    # The JAX bench's recall stage draws sift_moment_like(rng(7), TRAIN_N,
    # nq=TRAIN_NQ); the workflow phases' 10,000 queries are the next draw.
    draw = sift_moment_sampler(np.random.default_rng(7))
    base_np, tq_np, cli_q_np = timed(
        f"data: sift_moment_like {TRAIN_N} x 128 + {TRAIN_NQ} + {CLI_NQ} queries (host)",
        lambda: (draw(TRAIN_N), draw(TRAIN_NQ), draw(CLI_NQ)))
    base = torch.from_numpy(base_np).to(device)
    tq = torch.from_numpy(tq_np).to(device)
    learn = base[:TRAIN_LEARN]
    gt = timed("ground truth: exact 1-NN of 128 queries",
               lambda: assign_nearest(tq, base)).cpu().numpy()

    opq88 = timed("train_opq 8x8 (opq_iters 6, kmeans_iters 12, 100k vectors)",
                  lambda: train_opq(0, learn, 8, 8, opq_iters=6, kmeans_iters=12))
    coarse = timed("train_coarse 256 (iters 25, balance_cap 3.0)",
                   lambda: ivf.train_coarse(2, learn, 256, iters=25, balance_cap=3.0))
    residuals = learn - coarse[assign_nearest(learn, coarse).long()]
    r88 = timed("train_opq 8x8 on residuals",
                lambda: train_opq(3, residuals, 8, 8, opq_iters=6, kmeans_iters=12))
    r164 = timed("train_opq 16x4 on residuals",
                 lambda: train_opq(4, residuals, 16, 4, opq_iters=6, kmeans_iters=12))
    pq164 = timed("train_pq 16x4 (iters 12)", lambda: train_pq(5, learn, 16, 4, iters=12))
    pq324 = timed("train_pq 32x4 (iters 12)", lambda: train_pq(6, learn, 32, 4, iters=12))
    built = {
        "flat_8x8": timed("build flat 8x8, 1M", lambda: flat.add(
            flat.FlatIndex.create(opq88), base)),
        "ivf_8x8": timed("build IVF-256 8x8, 1M", lambda: ivf.add(
            ivf.IVFIndex.create(r88, coarse), base)),
        "ivf_16x4": timed("build IVF-256 16x4, 1M", lambda: ivf.add(
            ivf.IVFIndex.create(r164, coarse), base)),
        "flat_16x4": timed("build flat 16x4 PQ, 1M", lambda: flat.add(
            flat.FlatIndex.create(pq164), base)),
        "flat_32x4": timed(f"build flat 32x4 PQ, {WINDOW_N32}", lambda: flat.add(
            flat.FlatIndex.create(pq324), base[:WINDOW_N32])),
    }
    for name in ("ivf_8x8", "ivf_16x4"):
        ix = built[name]
        check(ix.n == TRAIN_N and int(ix.part_sizes.sum()) == TRAIN_N, f"{name}: code count")
        print(f"{name}: largest partition {ix.max_part_size}, part_pad {ix.part_pad}, "
              f"smallest {int(ix.part_sizes.min())}, codes {ix.codes.numel() / 1e6:.1f} MB",
              flush=True)
    del base, learn, residuals

    # save -> load onto the card -> equal tensors; the loaded copies are searched.
    trained = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, ix in built.items():
            path = str(Path(tmp) / name)
            timed(f"save {name}", lambda: save_index(path, ix))
            back = timed(f"load {name}", lambda: load_index(path))
            check(back.device.type == "cuda" and back.n == ix.n, f"{name}: loaded n / device")
            ivf_fields = ("labels", "part_sizes", "coarse_centroids")
            for f in ("codes",) + (ivf_fields if name.startswith("ivf") else ()):
                check(torch.equal(getattr(back, f), getattr(ix, f)), f"{name}: loaded {f}")
            check(torch.equal(back.pq.centroids, ix.pq.centroids), f"{name}: loaded centroids")
            if getattr(ix.pq, "rotation", None) is not None:
                check(torch.equal(back.pq.rotation, ix.pq.rotation), f"{name}: loaded rotation")
            trained[name] = back
    del built

    def batched(search_fn):
        return torch.cat([search_fn(tq[s:s + TRAIN_BATCH])[1]
                          for s in range(0, TRAIN_NQ, TRAIN_BATCH)]).cpu().numpy()

    trained_runs = {
        "trained_flat_adc8": ("flat_8x8_adc", lambda q: flat.search_adc(
            trained["flat_8x8"], q, r=R)),
        "trained_ivf_adc8": ("ivf256_8x8_adc_ma24", lambda q: ivf.search_adc(
            trained["ivf_8x8"], q, r=R, ma=MA)),
        "trained_ivf_qadc": ("ivf256_16x4_qadc_ma24", lambda q: ivf.search_qadc(
            trained["ivf_16x4"], q, r=R, ma=MA, keep=TRAIN_KEEP)),
        "trained_ivf_qadc_norerank": ("ivf256_16x4_qadc_ma24_norerank", lambda q: ivf.search_qadc(
            trained["ivf_16x4"], q, r=R, ma=MA, keep=TRAIN_KEEP, rerank=False)),
        "trained_flat_qadc": ("flat_16x4_pq_qadc", lambda q: flat.search_qadc(
            trained["flat_16x4"], q, r=R, keep=FLAT_KEEP)),
    }
    recalls = {}
    for path, (name, fn) in trained_runs.items():
        labels = drive(path, lambda: batched(fn))
        check(labels.shape == (TRAIN_NQ, R) and labels.min() >= 0 and labels.max() < TRAIN_N,
              f"{path}: labels out of range")
        recalls[name] = recall_at_r(labels, gt)
        print(f"recall@{R} {name}: {recalls[name]} (true neighbours, {TRAIN_NQ} queries, "
              f"batches of {TRAIN_BATCH}) [{card}]", flush=True)
    delta = recalls["ivf256_8x8_adc_ma24"] - recalls["ivf256_16x4_qadc_ma24"]
    print(f"recall 4-bit delta (IVF 8x8 ADC - IVF 16x4 Quick ADC): {delta}", flush=True)
    for name, floor in RECALL_FLOORS.items():
        check(recalls[name] >= floor, f"recall {name} = {recalls[name]} below {floor}")

    # ---- 7. the workflow: files, CLI, engine, server, autotune ---------------
    cli_index = workflow_phases(torch, np, device, card, base_np, cli_q_np, drive,
                                Path(workdir.name) / "workflow")
    # M3 at the CLI's trained IVF-256 (part_pad 12,288), at the batches its
    # crossover phase sends down the direct path.
    for b in BATCHES:
        m3_phases(cli_index, f"cli b={b}",
                  recorded_m3(cli_index, torch.from_numpy(cli_q_np[:b]).to(device)), "crossover")
    print("M3 rounds sweep, device ms (two turns): " + json.dumps(m3_rounds) + f" [{card}]",
          flush=True)
    del cli_index

    # ---- 5. the window scans over the trained flat 16x4 and 32x4 codes -------
    fw, fw32 = trained["flat_16x4"], trained["flat_32x4"]
    tq128 = tq[:FLAT_BATCH["flat_qadc"]]
    _, wqt, _ = flat._quantized_tables(fw, tq128, R, FLAT_KEEP, lut_scan.DISPATCH)
    wft = ivf.adc_tables(tq128, fw.pq.centroids)
    _, wqt32, _ = flat._quantized_tables(fw32, tq128, R, FLAT_KEEP, lut_scan.DISPATCH)
    print(f"window scans: flat 16x4 n={fw.n} n_pad={fw.n_pad}; flat 32x4 n={fw32.n} "
          f"n_pad={fw32.n_pad}; b={tq128.shape[0]}", flush=True)

    def window_exact(got, want):
        check(torch.equal(got[0], want[0]), "flat_scan_window minima differ from the plain version")
        check(got[1] is want[1] is None or torch.equal(got[1], want[1]),
              "flat_scan_window argmin ids differ")
        return 0.0

    def regs_exact(got, want):
        check(torch.equal(got, want), "flat_scan_window_regs differs from its plain version")
        return 0.0

    # The int8 window scan on the tensor cores (the warpgroup kernel, at
    # b=128 and at b=32, where a group of 128 queries is partly masked), held
    # to the plain version and to the tile walk bit for bit; at W = cpr also
    # to flat_scan.
    for tag, ix, tab, bn, w, kw, replaces in (
        ("b1024 w16", fw, wqt, 1024, 16, {}, 281),
        ("b1024 w16 transposed", fw, wqt, 1024, 16, {"transpose_out": True}, 281),
        ("b1024 w16 with_rows", fw, wqt, 1024, 16, {"with_rows": True}, 281),
        ("b=32 b1024 w16 with_rows", fw, wqt[:32].contiguous(), 1024, 16, {"with_rows": True},
         281),
        ("b512 w8", fw, wqt, 512, 8, {}, 281),
        ("32x4 b1024 w16 with_rows", fw32, wqt32, 1024, 16, {"with_rows": True}, 1991),
    ):
        args = (ix.codes, tab, ix.n, bn, w)
        got = lut_scan.flat_scan_window(*args, **kw)
        other = lut_scan.flat_scan_window_tiles_plain(*args, **kw)
        check(all(a is b is None or torch.equal(a, b) for a, b in zip(got, other)),
              f"flat_scan_window[{tag}] differs from its tile walk")
        if w == 128 // (tab.shape[1] // 2):  # W = cpr: a window is a storage row
            rows = lut_scan.flat_scan(ix.codes, tab, ix.n, "with_rows" in kw)
            mins = got[0] if kw.get("transpose_out") else got[0].T
            check(torch.equal(mins, rows[0]) and (got[1] is None or torch.equal(got[1].T, rows[1])),
                  f"flat_scan_window[{tag}] differs from flat_scan at W = cpr")
        del got, other
        kernel_phase(f"flat_scan_window[{tag}]", "flat_scan_window_wgmma_kernel",
                     "qadc_tpu_torch/csrc/scan_wgmma.cu",
                     f"qadc_tpu/kernels/lut_scan.py:{replaces}",
                     lambda args=args, kw=kw: lut_scan.flat_scan_window(*args, **kw),
                     lambda args=args, kw=kw: lut_scan.flat_scan_window_plain(*args, **kw),
                     window_exact, *flat_work(ix.codes, tab, ix.n))
    # The float32 window scan: the query-minor kernel (from
    # WINDOW_QUERY_MINOR_MIN_QUERIES queries on; at b=16 the wrapper runs the
    # lookup kernel itself) and the lookup kernel forced at any batch
    # (flat_scan_window_f32_lookup), in turns, held to each other, to the
    # plain version and to the query-minor walk bit for bit (minima,
    # transposed minima, ids); at W = cpr also to float flat_scan with rows.
    # Ceiling: 2*CB float lookups a (query, real code), 4 bytes each,
    # against SMEM_BYTES_PER_CLOCK on every SM at the maximum clock.
    window_src = "qadc_tpu_torch/csrc/flat_scan_window.cu"
    qm_window_src = "qadc_tpu_torch/csrc/flat_scan_window_qm.cu"
    perm4_src = "qadc_tpu_torch/csrc/flat_scan_window_perm4.cu"
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_hz = max_sm_clock_hz()
    wft32 = ivf.adc_tables(tq128, fw32.pq.centroids)
    ceiling_ms, ceiling_loop = {}, {}
    for tag, ix, tab, bn, w in (("b1024 w16", fw, wft, 1024, 16), ("b512 w8", fw, wft, 512, 8),
                                ("32x4 b1024 w16", fw32, wft32, 1024, 16),
                                ("b=16 b1024 w16", fw, wft[:16].contiguous(), 1024, 16)):
        args = (ix.codes, tab, ix.n, bn, w)
        for kw in ({}, {"with_rows": True}, {"transpose_out": True}):
            got = lut_scan.flat_scan_window(*args, **kw)
            for what, other in (
                    ("the lookup kernel", lut_scan.flat_scan_window_f32_lookup(*args, **kw)),
                    ("its plain version", lut_scan.flat_scan_window_plain(*args, **kw)),
                    ("its walk", lut_scan.flat_scan_window_query_minor_plain(*args, **kw))):
                check(all(a is b is None or torch.equal(a, b) for a, b in zip(got, other)),
                      f"flat_scan_window_f32[{tag}] {kw} differs from {what}")
            if w == 128 // (tab.shape[1] // 2) and kw.get("with_rows"):
                rows = lut_scan.flat_scan(ix.codes, tab, ix.n, True)
                check(torch.equal(got[0].T, rows[0]) and torch.equal(got[1].T, rows[1]),
                      f"flat_scan_window_f32[{tag}] differs from flat_scan at W = cpr")
            del got, other
        qm = tab.shape[0] >= lut_scan.WINDOW_QUERY_MINOR_MIN_QUERIES
        lookups = tab.shape[0] * ix.n * tab.shape[1]
        for base, fn, cu_name, src in (
            ("flat_scan_window_f32", lut_scan.flat_scan_window,
             "flat_scan_window_qm_kernel" if qm else "flat_scan_window_kernel",
             qm_window_src if qm else window_src),
            ("flat_scan_window_f32_lookup", lut_scan.flat_scan_window_f32_lookup,
             "flat_scan_window_kernel", window_src),
        ):
            kernel_phase(f"{base}[{tag}]", cu_name, src, "qadc_tpu/kernels/lut_scan.py:281",
                         lambda fn=fn, args=args: fn(*args),
                         lambda args=args: lut_scan.flat_scan_window_plain(*args),
                         window_exact, *flat_work(ix.codes, tab, ix.n), reps=LAB_REPS)
        ceiling_ms[f"flat_scan_window_f32[{tag}]"] = (
            lookups * 4 / (SMEM_BYTES_PER_CLOCK * sms * clock_hz) * 1e3)

    # Kernel 10: the four-lookup register engine, held to flat_scan_window
    # bit for bit, at the window scans' shapes and at 32x4 (block 8, W 2): 4
    # windows a block.
    # Its ceiling, a model: the integer-pipe instructions a lookup of the
    # compiled loop that the shape's G runs (cuobjdump; the fold loop for G =
    # 1, 2, 4, the eight-windows loop, nested in the walk over window groups,
    # otherwise) times the lookups, against INT_LANES_PER_CLOCK on every SM.
    sass = scan_lab.sass_loop_ops(lib_path, "flat_scan_window_perm4_kernel", 16)
    check(set(sass) == {8, 16} and all(any(loop["nested"] == nested for loop in loops)
                                       for loops in sass.values() for nested in (False, True)),
          "sass of flat_scan_window_perm4_kernel: no fold loop or no eight-windows loop")

    def hot_loop(cb: int, groups: int) -> dict:
        nested = groups not in (1, 2, 4)
        return min((loop for loop in sass[cb] if loop["nested"] == nested),
                   key=lambda loop: loop["alu_per_lookup"])

    for cb, loops in sass.items():
        for c in loops:
            print(f"sass flat_scan_window_regs CB={cb} "
                  f"{'eight-windows' if c['nested'] else 'fold'} loop at {c['start']:#x}: "
                  f"{c['lookups']} lookups, {c['alu']} integer-pipe ({c['alu_per_lookup']:.3f} a "
                  f"lookup), {c['fma']} FMA-pipe ({c['fma_per_lookup']:.3f}), {c['other']} other; "
                  f"opcodes {c['ops']}", flush=True)
    for tag, ix, tab, bn, w in (("b1024 w16", fw, wqt, 1024, 16), ("b512 w8", fw, wqt, 512, 8),
                                ("32x4 b1024 w16", fw32, wqt32, 1024, 16),
                                ("32x4 b8 w2", fw32, wqt32, 8, 2)):
        args = (ix.codes, tab, ix.n, bn, w)
        check(torch.equal(lut_scan.flat_scan_window_regs(*args),
                          lut_scan.flat_scan_window(*args)[0]),
              f"flat_scan_window_regs[{tag}] differs from flat_scan_window")
        cb = tab.shape[1] // 2
        kernel_phase(f"flat_scan_window_regs[{tag}]", "flat_scan_window_perm4_kernel", perm4_src,
                     "qadc_tpu/kernels/lut_scan.py:631",
                     lambda args=args: lut_scan.flat_scan_window_regs(*args),
                     lambda args=args: lut_scan.flat_scan_window_plain(*args)[0],
                     regs_exact, *flat_work(ix.codes, tab, ix.n), reps=LAB_REPS)
        loop = hot_loop(cb, bn // w)
        ceiling_ms[f"flat_scan_window_regs[{tag}]"] = (
            tab.shape[0] * ix.n * tab.shape[1] * loop["alu_per_lookup"]
            / (INT_LANES_PER_CLOCK * sms * clock_hz) * 1e3)
        ceiling_loop[f"flat_scan_window_regs[{tag}]"] = (
            f", {'eight-windows' if loop['nested'] else 'fold'} loop at {loop['start']:#x}")
    for name, k in kernels.items():
        base, _, rest = name.partition("[")
        if base == "flat_scan_window_f32":
            k["lookup_ms"] = kernels[f"flat_scan_window_f32_lookup[{rest}"]["ms"]
    window_ab = {name: (k["ms"], k["lookup_ms"]) for name, k in kernels.items()
                 if "lookup_ms" in k}
    print("window A/B, device ms flat_scan_window_f32 / the lookup kernel forced: " + "; ".join(
        f"{k} {new:.5f} / {lookup:.5f}" for k, (new, lookup) in window_ab.items()) + f" [{card}]",
        flush=True)
    print("window ceilings, ms (a model, not measured: float lookups at "
          f"{SMEM_BYTES_PER_CLOCK} shared-memory bytes a clock, the register engine's "
          f"integer-pipe instructions at {INT_LANES_PER_CLOCK} lanes a clock; "
          f"{sms} SMs at {clock_hz / 1e6:.0f} MHz): " + "; ".join(
        f"{k} {v:.5f} (device {kernels[k]['ms']:.5f}, bound {kernels[k]['bound_ms']:.5f}"
        f"{ceiling_loop.get(k, '')})"
        for k, v in ceiling_ms.items()) + f" [{card}]", flush=True)

    # The window-scan path: 8w (kernel 8 with ids, any window, then the
    # screen) and kernel 10's counterpart, counts reset before and read after.
    def window_path():
        out = {}
        for tag, ix, tab in (("16x4", fw, wqt), ("32x4", fw32, wqt32)):
            out[tag] = (lut_scan.lut_scan_topk_int8(ix.codes, tab, R, ix.n, 1024, 16),
                        lut_scan.flat_scan_window_regs(ix.codes, tab, ix.n, 1024, 16))
        return out

    for tag, ((tv, ti), regs_v) in drive("window_scan", window_path).items():
        ix, tab = (fw, wqt) if tag == "16x4" else (fw32, wqt32)
        packed = ix.codes.reshape(-1, ix.pq.code_size)
        check(tv.shape == (tab.shape[0], R) and bool(torch.isfinite(tv).all()),
              f"topk {tag}: shape / finite")
        check(bool((ti >= 0).all()) and bool((ti < ix.n).all()), f"topk {tag}: ids out of range")
        check(bool((tv[:, 1:] >= tv[:, :-1]).all()), f"topk {tag}: values not ascending")
        exact = adc_scan_int8(packed, tab, saturate=False)               # (Q, N_pad) int32
        check(torch.equal(torch.gather(exact, 1, ti.long()).to(torch.float32), tv),
              f"topk {tag}: a value is not its code's quantized distance")
        best, _ = scan_topk_int8(packed, ix.labels, tab, 1, num_valid=ix.n)
        check(torch.equal(best[:, 0], tv[:, 0]), f"topk {tag}: top-1 differs from the exact scan")
        wmin = torch.where(regs_v >= lut_scan.TRIM_SENTINEL, torch.inf,
                           regs_v.to(torch.float32)).amin(dim=0)
        check(torch.equal(wmin, tv[:, 0]), f"regs {tag}: best window differs from the top-1")
        del exact
        # The same screen over the plain version's windows: lut_scan_topk_int8's results unchanged.
        av, ai = lut_scan.flat_scan_window_plain(ix.codes, tab, ix.n, 1024, 16, with_rows=True)
        av = torch.where(ai >= 0, av.to(torch.float32), torch.inf).T
        sv, sel = exact_tile_screen(av, min(R, av.shape[1]))
        check(torch.equal(sv, tv) and torch.equal(torch.gather(ai.T, 1, sel.long()), ti),
              f"topk {tag}: differs from the screen of the plain version's windows")
        topk_ms = device_ms(torch, lambda: lut_scan.lut_scan_topk_int8(ix.codes, tab, R, ix.n,
                                                                       1024, 16))
        print(f"window path {tag}: lut_scan_topk_int8 r={R} values exact, ids < n, top-1 equal "
              f"to the exact scan and to the plain screen; flat_scan_window_regs' best window "
              f"equal; device ms of the call {topk_ms:.4f} [{card}]", flush=True)

    # ---- 6. the scan lab over the trained flat 16x4 codes, b=128 ---------------
    # The query-minor scans' lab takes the same codes as 8x8 codes too (8 bytes a code).
    wt8 = ivf.adc_tables(tq[:32], trained["flat_8x8"].pq.centroids).to(torch.bfloat16)

    def lab_checks():
        scan_lab.check_query_minor(fw.codes, wft, wt8, fw.n)
        scan_lab.check_grouped(m1f_args, m8_args)
        return scan_lab.check(fw.codes, wqt, fw.n)

    lab_out = drive("scan_lab", lab_checks)
    mismatches = sum(sum(v.values()) for v in lab_out["exactness"].values())
    check(mismatches == 0, f"exactness probe: {lab_out['exactness']}")
    check(lab_out["selector_sum_max_rel_err"] < 1e-6,
          f"selector sum rel err {lab_out['selector_sum_max_rel_err']}")
    lab_src = "qadc_tpu_torch/csrc/scan_lab.cu"
    wg_src = "qadc_tpu_torch/csrc/scan_wgmma.cu"
    lab_replaces = {"ab_tq_ablate": "benchmarks/ab_tq_ablate.py:121",
                    "kernel_lab": "benchmarks/kernel_lab.py:70"}
    for mode, (bits, mt, asks) in scan_lab.LAB_MODES.items():
        # The scan's minima, or copy's sentinel: the other modes define nothing.
        defined = bits == 7 or (bits == 0 and mt > 0)
        moved = nbytes(wqt) + (nbytes(fw.codes) if bits & 1 or (bits == 0 and mt) else 0)
        kernel_phase(f"scan_lab[{mode}]", "mma_kernel", lab_src if mt else wg_src,
                     lab_replaces[asks.split(".")[0]],
                     lambda mode=mode: scan_lab.scan_lab(fw.codes, wqt, fw.n, mode),
                     (lambda mode=mode: scan_lab.scan_lab_plain(fw.codes, wqt, fw.n, mode))
                     if defined else None,
                     exact_int,
                     moved, wqt.shape[0] * fw.n * 16 if bits & 2 else 0, PEAK_INT8)
    qm_src = "qadc_tpu_torch/csrc/scan_lab_qm.cu"
    qm_kernels = {"f32": "flat_scan_qm_kernel", "u8": "flat_scan8_qm_kernel",
                  "u8_lookup": "flat_scan8_kernel"}
    for mode, (scan, number, _) in scan_lab.QM_LAB_MODES.items():
        tab = wft if scan == "f32" else wt8
        moved, adds, peak = flat_work(fw.codes, tab, fw.n)
        kernel_phase(f"scan_lab[{mode}]", qm_kernels[scan],
                     "qadc_tpu_torch/csrc/flat_scan8.cu" if scan == "u8_lookup" else qm_src,
                     f"qadc_tpu/kernels/lut_scan.py:{522 if scan == 'f32' else 1601}",
                     lambda mode=mode, tab=tab: scan_lab.query_minor_lab(fw.codes, tab, fw.n, mode),
                     None, None, moved, 0 if number == 1 else adds, peak)
    # The grouped scans' modes at search_adc's b=32 groups (adc4's, adc8's).
    # An empty mode writes nothing: its phase returns no output, and its bound
    # is the routing it reads.
    def grouped_lab_run(args, mode):
        out = scan_lab.grouped_lab(*args, mode)
        return None if scan_lab.GROUPED_LAB_MODES[mode][1] is None else out

    for mode, (scan, number, _) in scan_lab.GROUPED_LAB_MODES.items():
        bits = 4 if scan == "f32" else 8
        (args, probes), ix = grouped_args[bits, "b=32"], adc_indexes[bits]
        moved, adds = grouped_work(ix, probes, args[1], args[2:])
        if number is None:
            moved, adds = nbytes(*args[2:]), 0
        kernel_phase(f"scan_lab[grouped_{mode}]", scan_lab.GROUPED_LAB_KERNELS[scan],
                     f32_src if scan == "f32" else u8_src,
                     f"qadc_tpu/kernels/lut_scan.py:{947 if bits == 4 else 1970}",
                     lambda mode=mode, args=args: grouped_lab_run(args, mode),
                     # quad computes the scan itself: held to its plain version
                     ((lambda args=args: lut_scan.grouped_scan_plain(*args))
                      if number == 4 else None),
                     lambda got, want: inf_float_err(torch, got, want, f"grouped {mode}"),
                     moved, 0 if number == 1 else adds, PEAK_F32)
    kernel_phase("empty_kernel", "empty_kernel", qm_src, "benchmarks/kernel_lab.py:70",
                 lambda: scan_lab.empty_kernel(device), None, None, 0, 0, PEAK_F32)
    gen = torch.Generator(device=device).manual_seed(11)
    sel_x = torch.rand((512, 128), generator=gen, device=device) * 500
    sel = (torch.arange(128, device=device)[:, None] // 8
           == torch.arange(16, device=device)[None, :]).to(torch.float32)
    kernel_phase("selector_sum", "selector_sum_kernel", lab_src, "benchmarks/diag_direct.py:51",
                 lambda: scan_lab.selector_sum(sel_x, 8),
                 lambda: scan_lab.selector_sum_plain(sel_x, 8),
                 lambda got, want: float_err(torch, got, want, "selector_sum"),
                 nbytes(sel_x), 512 * 128, PEAK_F32, library_fn=lambda: torch.matmul(sel_x, sel))
    print(f"selector_sum (512, 128) cb 8: {kernels['selector_sum']['ms']:.5f} ms, torch.matmul "
          f"{kernels['selector_sum']['library_ms']:.5f} [{card}]", flush=True)
    ab_ms = {name: device_ms(torch, fn, scan_lab.AB_KERNELS[name])
             for name, fn in scan_lab.ab_scans(fw.codes, wqt, fw.n).items()}
    print(f"A/B b=128 x {fw.n_pad} trained 16x4 codes, device ms: flat_scan (int8 one-hot x "
          f"table wgmma) {ab_ms['flat_scan']:.4f}; by mma.sync "
          f"{kernels['scan_lab[full]']['ms']:.4f}; "
          f"flat_scan_window (block 1024, W 16, transposed; wgmma) {ab_ms['flat_scan_window']:.4f}; "
          f"flat_scan_window_regs (four lookups a permute) {ab_ms['flat_scan_window_regs']:.4f} "
          f"[{card}]", flush=True)
    print(json.dumps({"scan_lab": {
        "shape": f"b={wqt.shape[0]} x {fw.n_pad} trained 16x4 codes", "ab_ms": ab_ms,
        "mode_ms": {mode: kernels[f"scan_lab[{mode}]"]["ms"] for mode in scan_lab.LAB_MODES},
        "asks": {mode: v[2] for mode, v in scan_lab.LAB_MODES.items()},
        "query_minor_mode_ms": {mode: kernels[f"scan_lab[{mode}]"]["ms"]
                                for mode in scan_lab.QM_LAB_MODES},
        "query_minor_asks": {mode: v[2] for mode, v in scan_lab.QM_LAB_MODES.items()},
        "launch_floor_ms": kernels["empty_kernel"]["ms"],
        "selector_sum_ms": kernels["selector_sum"]["ms"], **lab_out}, "card": card}), flush=True)

    # ---- 8. the sharded searches on one card, a process group of one rank ----
    sharded_phases(torch, np, device, card, drive, launches, index, queries, flat_indexes, fq,
                   Path(workdir.name) / "sharded")

    # ---- 9. the example, the GIST1M geometry, 16-bit training ----------------
    surface_phases(torch, np, device, card,
                   SimpleNamespace(kernel_phase=kernel_phase, drive=drive, m3_phases=m3_phases,
                                   e2e=e2e, launches=launches),
                   {"base_np": base_np, "tq": tq, "gt": gt, "coarse": coarse,
                    "floor": recalls["flat_8x8_adc"]})
    del base_np

    # The launch count of each kernel phase comes from the path that runs it;
    # sharded_launches: the sharded paths' runs (phase 8) that launched it.
    line = {"kernels": []}
    for name, k in kernels.items():
        base = name.split("[")[0]
        path = k.pop("path") or PATH_OF.get(base, "qadc")
        line["kernels"].append({**k, "launches": launches[path][base], "sharded_launches": {
            p: launches[p][base] for p in SHARDED_PATHS if launches[p].get(base)}})
    workdir.cleanup()
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def kernels_seen(torch, fn):
    """({CUDA kernel or copy name: launches}, device-busy ms) as torch.profiler
    records them in one run of fn, whatever thread or stream launched them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return ({e.key: e.count for e in events},
            sum(e.self_device_time_total for e in events) / 1e3)


def device_ops(torch, fn, top: int = 4) -> tuple[int, dict]:
    """(device ops (kernels and copies) one run of fn launches as
    torch.profiler records them, the `top` largest by device us, names cut
    to 60 characters)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
                    key=lambda e: -e.self_device_time_total)
    return (sum(e.count for e in events),
            {e.key[:60]: round(e.self_device_time_total, 2) for e in events[:top]})


def require_kernels(phase: str, seen: dict) -> dict:
    """The launches of the phase's PROFILED_KERNELS in `seen`; each must be > 0."""
    counts = {k: sum(n for name, n in seen.items() if k in name) for k in PROFILED_KERNELS[phase]}
    for k, n in counts.items():
        check(n > 0, f"{phase}: the profiler saw no launch of {k}")
    print(f"{phase}: profiler kernel launches {counts}", flush=True)
    return counts


def workflow_phases(torch, np, device, card, base_np, queries_np, drive, work: Path):
    """Phase 7: the reference's workflow through the port's user-facing
    layers, on SIFT1M-sized files made from the trained phase's data.

    files: base (1M x 128), learn (its first 100,000), 10,000 queries and
      their exact top-100 (ops/knn on the card) written as .fvecs / .ivecs,
      read back by the native path, the numpy path and VectorStream;
    cli: create-index (IVF-256, OPQ 16x4, balance cap 3), add, info (also
      as a `python -m` subprocess), query (Quick ADC with rerank, r=100,
      ma=24, b=32; then --adc-type adc), create-flat 16x4 + add + query
      (b=128); every recall equals the API search of the saved index;
    engine: QueryEngine.run at b=32 on the CLI's index, equal to the API;
    serve: SearchServer (batch 128, 2 ms) under 2,000 requests from 8
      threads, every answer equal to its bucket's search;
    crossover: search_qadc forced direct / grouped at b = 1..32;
    autotune: tune_ivf_qadc at b=32, then a search that consumes the pick.
    Prints one `workflow` JSON line with every number; returns the CLI's IVF
    index, loaded onto the card."""
    from qadc_tpu_torch import autotune
    from qadc_tpu_torch.cli.main import main as cli
    from qadc_tpu_torch.core.tensors import full_f32_matmul
    from qadc_tpu_torch.engine import QueryEngine
    from qadc_tpu_torch.eval.recall import recall_at_r
    from qadc_tpu_torch.index import flat, ivf
    from qadc_tpu_torch.io import native, vecs
    from qadc_tpu_torch.io.checkpoint import load_index
    from qadc_tpu_torch.io.stream import VectorStream
    from qadc_tpu_torch.kernels import lut_scan
    from qadc_tpu_torch.ops.knn import exact_knn
    from qadc_tpu_torch.serve import SearchServer

    report = {"card": card}
    work.mkdir(parents=True)
    f = {name: str(work / name) for name in
         ("base.fvecs", "learn.fvecs", "queries.fvecs", "gt.ivecs", "ivf", "flat")}

    # ---- files ----------------------------------------------------------------
    t0 = time.perf_counter()
    base_dev = torch.from_numpy(base_np).to(device)
    q_dev = torch.from_numpy(queries_np).to(device)
    with full_f32_matmul():
        gt = torch.cat([exact_knn(q_dev[s:s + GT_CHUNK], base_dev, GT_K)[1]
                        for s in range(0, CLI_NQ, GT_CHUNK)]).cpu().numpy()
    torch.cuda.synchronize()
    report["gt_s"] = time.perf_counter() - t0
    del base_dev, q_dev
    arrays = {"base.fvecs": base_np, "learn.fvecs": base_np[:TRAIN_LEARN],
              "queries.fvecs": queries_np, "gt.ivecs": gt}
    lib = native.get_lib()
    read_path = "native" if lib is not None else "numpy"
    io_rates = {}
    for name, a in arrays.items():
        t0 = time.perf_counter()
        vecs.save_vectors(f[name], a)
        write_s = time.perf_counter() - t0
        mb = os.path.getsize(f[name]) / 1e6
        to_float = name.endswith(".fvecs")
        rates = {"write": mb / write_s}
        for path_name, read in (
            ("native", lambda: vecs.load_vectors(f[name], to_float=to_float)),
            ("numpy", lambda: vecs.load_vectors(f[name], to_float=to_float, native=False)),
            ("stream", lambda: np.concatenate(
                [c for _, c in VectorStream(f[name], CLI_CHUNK, to_float=to_float)])),
        ):
            t0 = time.perf_counter()
            back = read()
            rates[path_name] = mb / (time.perf_counter() - t0)
            check(back.dtype == a.dtype and np.array_equal(back, a),
                  f"files: {name} read back by {path_name} differs")
            del back
        io_rates[name] = {"MB": mb, **rates}
        print(f"files {name}: {a.shape} {mb:.1f} MB, MB/s write {rates['write']:.0f}, read "
              f"{read_path} {rates['native']:.0f} / numpy {rates['numpy']:.0f} / VectorStream "
              f"{rates['stream']:.0f}", flush=True)
    report.update(read_path=read_path, io=io_rates)
    print(f"files: read path {read_path} ({lib and native.BUILD_DIR}); exact top-{GT_K} of "
          f"{CLI_NQ} queries on the card {report['gt_s']:.2f} s [{card}]", flush=True)

    # ---- cli ------------------------------------------------------------------
    def run_cli(*argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli([*argv])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        out = buf.getvalue()
        for line in out.splitlines():
            print(f"  cli> {line}")
        print(f"cli {argv[0]}: {dt:.2f} s [{card}]", flush=True)
        seconds = report.setdefault("cli_s", {})
        seconds[argv[0]] = seconds.get(argv[0], 0.0) + dt
        return out

    def csv(out):
        header, row = out.strip().splitlines()[-2:]
        return dict(zip(header.split(","), row.split(",")))

    def api_labels(search, b):
        """The API's search of the queries in batches of b, the tail padded
        with zero queries as QueryEngine pads it."""
        out = []
        for s in range(0, CLI_NQ, b):
            real = queries_np[s:s + b]
            batch = np.zeros((b, real.shape[1]), np.float32)
            batch[:len(real)] = real
            out.append(search(torch.from_numpy(batch).to(device))[1][:len(real)])
        return torch.cat(out).cpu().numpy()

    run_cli("create-index", f["learn.fvecs"], f["ivf"], "--parts", "256", "--sq", "16x4",
            "--opq", "--seed", "0")
    run_cli("add", f["ivf"], f["base.fvecs"], "--chunk-size", str(CLI_CHUNK))
    info = run_cli("info", f["ivf"])
    t0 = time.perf_counter()
    sub = subprocess.run([sys.executable, "-m", "qadc_tpu_torch.cli.main", "info", f["ivf"]],
                         capture_output=True, text=True, timeout=300, cwd=str(work),
                         env={**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent)})
    check(sub.returncode == 0 and sub.stdout == info,
          f"`python -m qadc_tpu_torch.cli.main info` differs: {sub.stdout!r} {sub.stderr[-2000:]}")
    print(f"cli info as a subprocess: equal text, {time.perf_counter() - t0:.2f} s", flush=True)

    queries = {
        "cli_ivf_qadc": (f["ivf"], CLI_BATCH, ("-m", str(MA), "-k", str(CLI_KEEP_PCT))),
        "cli_ivf_adc": (f["ivf"], CLI_BATCH, ("-m", str(MA), "--adc-type", "adc")),
        "cli_flat_qadc": (f["flat"], FLAT_CLI_BATCH, ("-k", "1")),
    }
    rows, seen_all = {}, {}
    for phase, (idx, b, extra) in queries.items():
        if phase == "cli_flat_qadc":
            run_cli("create-flat", "--train", f["learn.fvecs"], f["flat"], "--sq", "16x4")
            run_cli("add", f["flat"], f["base.fvecs"], "--chunk-size", str(CLI_CHUNK))
        argv = ("query", idx, f["queries.fvecs"], f["gt.ivecs"], "-r", str(R), "-b", str(b),
                *extra)
        rows[phase] = csv(drive(phase, lambda: run_cli(*argv)))
        # Once more under the profiler, for the kernels it launches only (the
        # profiler slows the host, so the CSV above is the one kept).
        seen_all[phase] = require_kernels(phase, kernels_seen(torch, lambda: run_cli(*argv))[0])
    report["cli"] = rows

    ivf_index, flat_index = load_index(f["ivf"], device), load_index(f["flat"], device)
    check(ivf_index.n == TRAIN_N and ivf_index.part_count == 256, "cli: IVF index size")
    print(f"cli IVF index: largest partition {ivf_index.max_part_size}, part_pad "
          f"{ivf_index.part_pad}", flush=True)
    keep = CLI_KEEP_PCT / 100.0
    api = {
        "cli_ivf_qadc": api_labels(lambda qs: ivf.search_qadc(
            ivf_index, qs, r=R, ma=MA, keep=keep), CLI_BATCH),
        "cli_ivf_adc": api_labels(lambda qs: ivf.search_adc(ivf_index, qs, r=R, ma=MA),
                                  CLI_BATCH),
        "cli_flat_qadc": api_labels(lambda qs: flat.search_qadc(flat_index, qs, r=R, keep=0.01),
                                    FLAT_CLI_BATCH),
    }
    for phase, row in rows.items():
        want = recall_at_r(api[phase], gt)
        check(float(row["recall"]) == want,
              f"{phase}: CLI recall {row['recall']} != the API search's {want}")
        print(f"{phase}: recall@{R} {row['recall']} over {CLI_NQ} queries equals the API "
              f"search of the saved index; phases us/query index {row['index_us']} rotate "
              f"{row['rotate_us']} table {row['table_us']} scan {row['scan_us']} [{card}]",
              flush=True)
    ivf_recall = float(rows["cli_ivf_qadc"]["recall"])
    check(ivf_recall >= RECALL_FLOORS["ivf256_16x4_qadc_ma24"],
          f"cli: IVF Quick ADC recall {ivf_recall} below its floor")

    # ---- engine ---------------------------------------------------------------
    engine = QueryEngine(ivf_index, r=R, ma=MA, keep=keep, adc_type="qadc", batch_size=CLI_BATCH)
    _, labels, metrics = drive("engine", lambda: engine.run(queries_np, with_metrics=True))
    check(np.array_equal(labels, api["cli_ivf_qadc"]), "engine: labels differ from the API's")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run(queries_np)
    wall_ms = (time.perf_counter() - t0) * 1e3
    seen, busy_ms = kernels_seen(torch, lambda: engine.run(queries_np))
    seen_all["engine"] = require_kernels("engine", seen)
    report["engine"] = {"csv": f"{metrics.HEADER}\n{metrics.csv_row()}",
                        "us_per_query": wall_ms * 1e3 / CLI_NQ, "busy_ms": busy_ms,
                        "wall_ms": wall_ms, "idle_share": 1 - busy_ms / wall_ms}
    print(f"engine b={CLI_BATCH}: labels equal the API's; phases {metrics.HEADER} = "
          f"{metrics.csv_row()}; {CLI_NQ} queries {wall_ms:.1f} ms "
          f"({wall_ms * 1e3 / CLI_NQ:.2f} us/query), device busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f} [{card}]", flush=True)

    # ---- serve ----------------------------------------------------------------
    def serve_run():
        done = {}
        submitted = {}
        futs = [None] * SERVE_REQUESTS

        def submit(i):
            submitted[i] = time.perf_counter()
            futs[i] = srv.submit(queries_np[i])
            futs[i].add_done_callback(lambda _, i=i: done.__setitem__(i, time.perf_counter()))

        with SearchServer(ivf_index, r=R, ma=MA, keep=keep, batch_size=SERVE_BATCH,
                          max_wait_ms=SERVE_WAIT_MS) as srv:
            submit(0)  # a lone request: bucket 1, the direct path
            futs[0].result(timeout=300)
            t_burst = time.perf_counter()
            share = -(-(SERVE_REQUESTS - 1) // SERVE_THREADS)
            workers = [threading.Thread(target=lambda t=t: [
                submit(i) for i in range(1 + t * share, min(SERVE_REQUESTS, 1 + (t + 1) * share))])
                for t in range(SERVE_THREADS)]
            for w in workers:
                w.start()
            for w in workers:
                w.join(timeout=300)
                check(not w.is_alive(), "serve: a caller thread hung")
            results = [fut.result(timeout=300) for fut in futs]  # raises a batch's error
            batches = srv._batches
        end = max(done.values())
        lat = sorted((done[i] - submitted[i]) * 1e3 for i in range(SERVE_REQUESTS))
        return results, [fut.bucket for fut in futs], batches, lat, (
            (SERVE_REQUESTS - 1) / (end - t_burst))

    (results, buckets, batches, lat, qps) = drive("serve", serve_run)
    check(batches < SERVE_REQUESTS // 4, f"serve: {batches} batches for {SERVE_REQUESTS} requests")
    by_bucket = {}
    for i, bsz in enumerate(buckets):
        by_bucket.setdefault(bsz, []).append(i)
    for bsz, ids in sorted(by_bucket.items()):
        for s in range(0, len(ids), bsz):
            chunk = ids[s:s + bsz]
            batch = np.zeros((bsz, queries_np.shape[1]), np.float32)
            batch[:len(chunk)] = queries_np[chunk]
            wd, wl = ivf.search_qadc(ivf_index, torch.from_numpy(batch).to(device), r=R, ma=MA,
                                     keep=keep)
            wd, wl = wd.cpu().numpy(), wl.cpu().numpy()
            for j, i in enumerate(chunk):
                d, lab = results[i]
                check(np.array_equal(lab, wl[j]), f"serve: request {i} (bucket {bsz}) labels")
                np.testing.assert_allclose(d, wd[j], rtol=SERVE_RTOL,
                                           err_msg=f"serve: request {i} (bucket {bsz})")
    counts = {b: len(ids) for b, ids in sorted(by_bucket.items())}
    p50, p99 = statistics.median(lat), lat[int(0.99 * (len(lat) - 1))]
    report["serve"] = {"batches": batches, "requests_by_bucket": counts, "p50_ms": p50,
                       "p99_ms": p99, "qps": qps}
    print(f"serve: {SERVE_REQUESTS} requests from {SERVE_THREADS} threads in {batches} batches "
          f"(requests by bucket {counts}), every answer equal to its bucket's search; latency "
          f"p50 {p50:.2f} ms p99 {p99:.2f} ms, {qps:.0f} QPS [{card}]", flush=True)

    # Where a batch's time goes: the same burst through a search_fn that
    # times the search inside the executor (to the results on the host).
    inside = []

    def timed_search(index, batch):
        t0 = time.perf_counter()
        d, lab = ivf.search_qadc(index, batch, r=R, ma=MA, keep=keep)
        out = d.cpu(), lab.cpu()
        inside.append((time.perf_counter() - t0) * 1e3)
        return out

    with SearchServer(ivf_index, batch_size=SERVE_BATCH, max_wait_ms=SERVE_WAIT_MS,
                      search_fn=timed_search) as srv:
        t0 = time.perf_counter()
        for fut in [srv.submit(q) for q in queries_np[1:SERVE_REQUESTS]]:
            fut.result(timeout=300)
        wall = (time.perf_counter() - t0) * 1e3
    report["serve"].update(split_batches=len(inside), split_wall_ms=wall,
                           split_search_ms=inside)
    print(f"serve split: {SERVE_REQUESTS - 1} requests in {len(inside)} batches, {wall:.1f} ms; "
          f"the search inside the executor {sum(inside):.1f} ms (median "
          f"{statistics.median(inside):.2f} ms a batch, first {inside[0]:.2f}) [{card}]",
          flush=True)

    def serve_small():  # a lone request (bucket 1) and a full batch, profiled
        with SearchServer(ivf_index, r=R, ma=MA, keep=keep, batch_size=SERVE_BATCH,
                          max_wait_ms=50.0) as srv:
            srv.submit(queries_np[0]).result(timeout=300)
            for fut in [srv.submit(q) for q in queries_np[:SERVE_BATCH]]:
                fut.result(timeout=300)

    seen_all["serve"] = require_kernels("serve", kernels_seen(torch, serve_small)[0])

    # ---- direct / grouped crossover -------------------------------------------
    def crossover():
        out = {}
        for b in CROSSOVER_BATCHES:
            qs = torch.from_numpy(queries_np[:b]).to(device)
            for path, kw in (("direct", {"direct": True}), ("grouped", {"direct": False,
                                                                        "grouped": True})):
                fn = lambda: ivf.search_qadc(ivf_index, qs, r=R, ma=MA, keep=keep,  # noqa: E731
                                             **kw)
                ms = time_ms(torch, fn, CROSSOVER_REPS)[0]
                busy = device_ms(torch, fn, reps=CROSSOVER_REPS)
                out.setdefault(b, {})[path] = {"us_per_query": ms * 1e3 / b, "busy_us": busy * 1e3}
            d, g = out[b]["direct"], out[b]["grouped"]
            print(f"crossover b={b}: direct {d['us_per_query']:.2f} us/query (device busy "
                  f"{d['busy_us']:.1f} us/batch), grouped {g['us_per_query']:.2f} "
                  f"({g['busy_us']:.1f}) [{card}]", flush=True)
        return out

    report["crossover"] = drive("crossover", crossover)
    rule = {b: ("direct" if (b * MA * ivf_index.part_pad <= ivf.DIRECT_MAX_CODES
                             or b * MA / min(ivf_index.part_count, b * MA)
                             <= ivf.DIRECT_MAX_DENSITY) else "grouped")
            for b in CROSSOVER_BATCHES}
    report["crossover_rule"] = rule
    print(f"crossover: DIRECT_MAX_CODES / DIRECT_MAX_DENSITY send b={rule} (unchanged)",
          flush=True)

    # ---- autotune -------------------------------------------------------------
    q32 = torch.from_numpy(queries_np[:CLI_BATCH]).to(device)

    def tune():
        pick = autotune.tune_ivf_qadc(ivf_index, q32, r=R, ma=MA, keep=keep, verbose=True)
        key = autotune.geometry_key(ivf_index, "ivf_qadc_grouped", CLI_BATCH)
        check(key.startswith(torch.cuda.get_device_name(device) + "|"), f"autotune key {key}")
        check(autotune.lookup(key) == pick or not pick, "autotune: the pick was not recorded")
        got = ivf.search_qadc(ivf_index, q32, r=R, ma=MA, keep=keep)
        want = ivf.search_qadc(ivf_index, q32, r=R, ma=MA, keep=keep,
                               group_size=autotune.DEFAULT_GROUP_SIZE)
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              "autotune: the pick changed the results")
        return pick, key

    pick, key = drive("autotune", tune)
    report["autotune"] = {"pick": pick, "key": key}
    print(f"autotune: pick {pick} under {key}; search_qadc with no group_size consumes it and "
          f"gives the API's results [{card}]", flush=True)
    report["profiled_kernels"] = seen_all
    print(json.dumps({"workflow": report}, default=float), flush=True)
    return ivf_index


def sharded_phases(torch, np, device, card, drive, launches, index, queries, flat_indexes, fq,
                   work: Path) -> None:
    """Phase 8: the sharded searches (qadc_tpu_torch/dist) on the one card.

    A process group of one rank over NCCL through the QADC_* variables
    (maybe_init_distributed), and a mesh of SHARDS shards on the card (2 for
    the reshard). At the bench geometry (the indexes of phase 2): the
    partition-sharded IVF search at b=32 and 128, the code-sharded flat
    Quick ADC at b=128 and float ADC (4-bit b=128, 8-bit b=32), the
    query-parallel ivf.search_qadc at b=128, each held to the same call
    through lut_scan.PLAIN (equal; 4-bit float ADC rtol 1e-6), to the
    single-card search (top-1 labels equal) and to the float64 oracle; the
    IVF index saved as SHARDS shard files and loaded into 4 and 2 shards. At
    the Deep100M geometry (drawn on the card from a seeded generator): the
    sharded IVF search at b=32 and 512 against the unsharded grouped search
    (top-1 equal, recall of its top-100) and the oracle on 8 queries. Each
    path's launches are counted (drive) and seen by the profiler; one
    `sharded` JSON line holds us/query, device-busy ms, idle share and
    launches of each search.
    """
    import torch.distributed as dist

    from qadc_tpu_torch.core.layout import code_view
    from qadc_tpu_torch.core.packing import unpack_codes
    from qadc_tpu_torch.dist import (load_sharded_index, make_mesh, search_adc_flat_sharded,
                                     search_qadc_flat_sharded, search_qadc_ivf_sharded,
                                     search_query_parallel, shard_flat_codes,
                                     shard_ivf_partitions)
    from qadc_tpu_torch.dist.mesh import maybe_init_distributed
    from qadc_tpu_torch.eval.recall import recall_at_r
    from qadc_tpu_torch.index import flat, ivf
    from qadc_tpu_torch.io.checkpoint import save_index_sharded
    from qadc_tpu_torch.kernels.lut_scan import DISPATCH, PLAIN
    from qadc_tpu_torch.quantizers.pq import ProductQuantizer

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.update(QADC_COORDINATOR=f"127.0.0.1:{port}", QADC_NUM_PROCESSES="1",
                      QADC_PROCESS_ID="0")
    t0 = time.perf_counter()
    check(maybe_init_distributed(device=device) and dist.is_initialized(),
          "sharded: the process group did not start")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          f"sharded: backend {dist.get_backend()}, world {dist.get_world_size()}")
    probe = torch.ones(1, device=device)
    dist.all_reduce(probe)
    check(float(probe) == 1.0, "sharded: NCCL all_reduce")
    print(f"sharded: NCCL process group of 1 rank, all_reduce done, "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    out = {}
    try:
        mesh = make_mesh(SHARDS, device=device)
        check((mesh.shards, mesh.world, mesh.local_shards) == (SHARDS, 1, SHARDS),
              f"sharded: mesh {mesh}")

        def measure(name, path, b, fn, single_fn):
            """Time one search (CUDA events; profiler device time) and its
            single-card counterpart in turns, and record its path's launches."""
            ms, p90 = time_ms(torch, fn, SHARDED_REPS)
            busy = device_ms(torch, fn, reps=SHARDED_REPS)
            single_ms = time_ms(torch, single_fn, SHARDED_REPS)[0]
            ops, top = device_ops(torch, fn)
            out[name] = {"batch": b, "us_per_query_median": ms * 1e3 / b,
                         "us_per_query_p90": p90 * 1e3 / b, "ms_per_batch": ms,
                         "device_busy_ms": busy, "idle_share": 1 - busy / ms,
                         "single_card_us_per_query_median": single_ms * 1e3 / b,
                         "launches": {k: v for k, v in launches[path].items() if v},
                         "device_ops": ops, "largest_device_us": top, **out.get(name, {})}
            print(f"e2e sharded {name}: {ms * 1e3 / b:.2f} us/query median, {p90 * 1e3 / b:.2f} "
                  f"p90 (n={SHARDED_REPS}; device busy {busy:.4f} ms/batch, idle share "
                  f"{1 - busy / ms:.3f}; single card {single_ms * 1e3 / b:.2f} us/query; "
                  f"{ops} device ops, largest {top}) [{card}]", flush=True)

        def run(path, fn):
            """drive (counts reset, kernels required), then the profiler's view."""
            got = drive(path, fn)
            seen = require_kernels(path, kernels_seen(torch, fn)[0])
            return got, seen

        def hold(name, b, got, plain, single, exact=True):
            """Shape, order; the plain twin (equal, or rtol 1e-6 with equal
            top-1 and overlap >= 98); the single card's top-1."""
            (d, lab), (pd, pl) = got, plain
            check(d.shape == (b, R) and lab.shape == (b, R), f"{name}: result shape")
            check(bool(torch.isfinite(d).all()), f"{name}: non-finite distances")
            check(bool((d[:, 1:] >= d[:, :-1]).all()), f"{name}: distances not ascending")
            if exact:
                check(torch.equal(d, pd) and torch.equal(lab, pl), f"{name}: differs from plain")
            else:
                torch.testing.assert_close(d, pd, rtol=SHARDED_RTOL, atol=0.0,
                                           msg=lambda m: f"{name}: kernels vs plain: {m}")
                check(bool(torch.equal(lab[:, 0], pl[:, 0])) and overlap(lab, pl) >= 98,
                      f"{name}: labels vs plain")
            top1 = bool(torch.equal(lab[:, 0], single[1][:, 0]))
            check(top1, f"{name}: top-1 differs from the single-card search")
            out[name] = {"plain_equal": bool(torch.equal(d, pd) and torch.equal(lab, pl)),
                         "single_top1_equal": top1,
                         "overlap_with_single": overlap(lab, single[1])}

        def oracle_top1(name, lab, ol):
            rec = recall_at_r(lab.cpu().numpy(), ol[:, :1].cpu().numpy())
            check(rec >= MIN_ORACLE_RECALL, f"{name}: oracle recall {rec}")
            out[name]["oracle_top1_recall"] = rec
            return rec

        # -- the bench IVF-256 16x4 index, partition-sharded -----------------
        ivf_s = shard_ivf_partitions(index, mesh)

        def ivf_search(ix, b, k=DISPATCH, mesh_=mesh):
            return search_qadc_ivf_sharded(ix, queries[b], r=R, ma=MA, keep=KEEP, mesh=mesh_,
                                           kernels=k)

        def ivf_single(b):
            return ivf.search_qadc(index, queries[b], r=R, ma=MA, keep=KEEP)

        got, seen = run("sharded_ivf", lambda: {b: ivf_search(ivf_s, b)
                                                for b in SHARDED_IVF_BATCHES})
        for b, res in got.items():
            name = f"ivf b={b}"
            hold(name, b, res, ivf_search(ivf_s, b, PLAIN), ivf_single(b))
            _, ol = oracle(torch, index, queries[b], code_view, unpack_codes, ivf)
            oracle_top1(name, res[1], ol)
            out[name]["profiled_launches"] = seen
            measure(name, "sharded_ivf", b, lambda: ivf_search(ivf_s, b), lambda: ivf_single(b))

        # -- the sharded checkpoint: 4 files, loaded into 4 and into 2 shards --
        ck = str(work / "ivf_sharded")
        t0 = time.perf_counter()
        save_index_sharded(ck, index, SHARDS)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = load_sharded_index(ck, mesh)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        for f in ("codes", "labels", "part_sizes", "coarse_centroids"):
            check(torch.equal(getattr(loaded, f), getattr(ivf_s, f)), f"sharded load: {f}")
        back, seen = run("sharded_checkpoint", lambda: {b: ivf_search(loaded, b)
                                                        for b in SHARDED_IVF_BATCHES})
        for b, res in back.items():
            check(torch.equal(res[0], got[b][0]) and torch.equal(res[1], got[b][1]),
                  f"sharded checkpoint b={b}: differs from the sharded index's search")
        mesh2 = make_mesh(2, device=device)
        loaded2 = load_sharded_index(ck, mesh2)
        direct2 = shard_ivf_partitions(index, mesh2)
        for f in ("codes", "labels", "part_sizes", "coarse_centroids"):
            check(torch.equal(getattr(loaded2, f), getattr(direct2, f)), f"reshard load: {f}")
        for b in SHARDED_IVF_BATCHES:
            d2, l2 = ivf_search(loaded2, b, mesh_=mesh2)
            w2 = ivf_search(direct2, b, mesh_=mesh2)
            check(torch.equal(d2, w2[0]) and torch.equal(l2, w2[1]),
                  f"reshard b={b}: differs from the 2-shard index's search")
            check(torch.equal(l2[:, 0], got[b][1][:, 0]), f"reshard b={b}: top-1")
        out["checkpoint"] = {"save_s": t_save, "load_s": t_load, "shard_files": SHARDS,
                             "launches": {k: v for k, v in launches["sharded_checkpoint"].items()
                                          if v}, "profiled_launches": seen,
                             "reshard_2_shards_equal": True}
        print(f"sharded checkpoint: {SHARDS} shard files saved in {t_save:.3f} s, loaded in "
              f"{t_load:.3f} s; equal to the sharded index and its searches; loaded into 2 "
              f"shards: the 2-shard index's arrays and results [{card}]", flush=True)
        del loaded, loaded2, direct2, back

        # -- the flat indexes, code-sharded --------------------------------------
        fs = {bits: shard_flat_codes(flat_indexes[bits], mesh) for bits in (4, 8)}
        flat_cases = {
            "flat_qadc": ("sharded_flat_qadc", 128, True,
                          lambda k=DISPATCH: search_qadc_flat_sharded(
                              fs[4], fq[128], r=R, keep=FLAT_KEEP, mesh=mesh, kernels=k),
                          lambda: flat.search_qadc(flat_indexes[4], fq[128], r=R, keep=FLAT_KEEP)),
            "flat_adc4": ("sharded_flat_adc4", 128, False,
                          lambda k=DISPATCH: search_adc_flat_sharded(fs[4], fq[128], r=R,
                                                                     mesh=mesh, kernels=k),
                          lambda: flat.search_adc(flat_indexes[4], fq[128], r=R)),
            "flat_adc8": ("sharded_flat_adc8", 32, True,
                          lambda k=DISPATCH: search_adc_flat_sharded(fs[8], fq[32], r=R,
                                                                     mesh=mesh, kernels=k),
                          lambda: flat.search_adc(flat_indexes[8], fq[32], r=R)),
        }
        for name, (path, b, exact, fn, single_fn) in flat_cases.items():
            res, seen = run(path, fn)
            hold(name, b, res, fn(PLAIN), single_fn(), exact=exact)
            bits = 8 if name == "flat_adc8" else 4
            od, ol = flat_oracle(torch, flat_indexes[bits], fq[b], unpack_codes)
            oracle_top1(name, res[1], ol)
            if name != "flat_qadc":  # exact float ADC: the oracle's top-r
                torch.testing.assert_close(res[0].double(), od, rtol=SEARCH_RTOL, atol=0.0,
                                           msg=lambda m: f"{name} vs oracle: {m}")
            out[name]["profiled_launches"] = seen
            measure(name, path, b, fn, single_fn)

        # -- query-parallel ivf.search_qadc -----------------------------------
        def qp(k=DISPATCH):
            return search_query_parallel(ivf.search_qadc, index, queries[128], mesh=mesh, r=R,
                                         ma=MA, keep=KEEP, kernels=k)

        res, seen = run("sharded_query_parallel", qp)
        name = "query_parallel ivf b=128"
        hold(name, 128, res, qp(PLAIN), ivf_single(128))
        _, ol = oracle(torch, index, queries[128], code_view, unpack_codes, ivf)
        oracle_top1(name, res[1], ol)
        out[name]["profiled_launches"] = seen
        measure(name, "sharded_query_parallel", 128, qp, lambda: ivf_single(128))
        del ivf_s, fs

        # -- the Deep100M geometry, drawn on the card --------------------------
        gen = torch.Generator(device=device).manual_seed(0)
        part_real = DEEP_N // DEEP_PARTS
        part_pad = -(-part_real // 512) * 512
        t0 = time.perf_counter()
        deep = ivf.IVFIndex(
            pq=ProductQuantizer(centroids=torch.randn((DEEP_M, 16, DEEP_DIM // DEEP_M),
                                                      generator=gen, device=device), sq_bits=4),
            coarse_centroids=torch.randn((DEEP_PARTS, DEEP_DIM), generator=gen, device=device),
            codes=torch.randint(0, 256, (DEEP_PARTS, part_pad * DEEP_M // 2 // 128, 128),
                                generator=gen, device=device, dtype=torch.uint8),
            labels=(torch.arange(DEEP_PARTS, dtype=torch.int32, device=device)[:, None] * part_pad
                    + torch.arange(part_pad, dtype=torch.int32, device=device)[None, :]),
            part_sizes=torch.full((DEEP_PARTS,), part_real, dtype=torch.int32, device=device),
            n=DEEP_PARTS * part_real, max_part_size=part_real)
        qd = torch.randn((max(DEEP_BATCHES), DEEP_DIM), generator=gen, device=device)
        torch.cuda.synchronize()
        print(f"deep100m: IVF-{DEEP_PARTS} dim {DEEP_DIM} {DEEP_M}x4, part_real {part_real} "
              f"part_pad {part_pad}, {deep.n} codes: codes {deep.codes.numel() / 1e6:.1f} MB, "
              f"labels {deep.labels.numel() * 4 / 1e6:.1f} MB, drawn in "
              f"{time.perf_counter() - t0:.2f} s; {SHARDS} shards of "
              f"{DEEP_PARTS // SHARDS} partitions", flush=True)
        deep_s = shard_ivf_partitions(deep, mesh)

        def deep_search(b):
            return search_qadc_ivf_sharded(deep_s, qd[:b], r=R, ma=MA, keep=KEEP, mesh=mesh)

        def deep_single(b):
            return ivf.search_qadc(deep, qd[:b], r=R, ma=MA, keep=KEEP, grouped=True,
                                   direct=False)

        res, seen = run("sharded_deep100m", lambda: {b: deep_search(b) for b in DEEP_BATCHES})
        _, ol = oracle(torch, deep, qd[:DEEP_ORACLE_NQ], code_view, unpack_codes, ivf)
        for b, (d, lab) in res.items():
            name = f"deep100m b={b}"
            check(d.shape == (b, R) and bool(torch.isfinite(d).all())
                  and bool((d[:, 1:] >= d[:, :-1]).all()), f"{name}: shape, finite, order")
            single = deep_single(b)
            top1 = bool(torch.equal(lab[:, 0], single[1][:, 0]))
            check(top1, f"{name}: top-1 differs from the unsharded grouped search")
            out[name] = {"single_top1_equal": top1,
                         "recall_at_100_vs_single": overlap(lab, single[1]) / R,
                         "profiled_launches": seen}
            oracle_top1(name, lab[:DEEP_ORACLE_NQ], ol)
            print(f"search {name}: top-1 equals the unsharded grouped search; recall@{R} "
                  f"against it {out[name]['recall_at_100_vs_single']}; oracle top-1 recall "
                  f"over {DEEP_ORACLE_NQ} queries {out[name]['oracle_top1_recall']}", flush=True)
            measure(name, "sharded_deep100m", b, lambda: deep_search(b), lambda: deep_single(b))
        del deep, deep_s, res, single, qd
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    print(json.dumps({"sharded": out, "card": card}), flush=True)


def surface_phases(torch, np, device, card, ctx, sift) -> dict:
    """Phase 9: the example, the GIST1M geometry and 16-bit training.

    ctx: main's helpers kernel_phase, drive, m3_phases and e2e, and
    launches (the counts drive records a path). sift: the trained phase's
    data (base_np, its 128 queries tq, their true neighbours gt, the coarse
    quantizer, and flat 8x8 OPQ ADC's recall, the 16-bit floor).

    (a) examples/torch_sift_pipeline.py at its default size (the JAX
        example's stand-in: 100,000 learn, 200,000 base, 256 queries), its
        256 queries in one search (the grouped path: M1 int8 and M2);
        recall@100 at least EXAMPLE_FLOOR.
    (b) GIST1M's geometry on eval/synth.gist_moment_like (numpy seed 0):
        OPQ 16x8 and 32x4 flat indexes, IVF-256 with OPQ 16x8 and 32x4 on
        residuals; recall@100 of each in batches of 32 (IVF 32x4 Quick ADC
        with and without rerank, and one query at a time: M3); us/query,
        device busy and idle share at b=32 and 128; the kernels at these
        widths (flat_scan8 m=16, flat_scan int8 CB=16 by its warpgroup and
        mma.sync kernels, grouped_scan8 m=16, M1 CB=16, M2, M3) held to
        their plain versions, timed and bounded into the kernels line.
    (c) 16-bit training: train_pq 8x16 on the first 4 K = 262,144 of the
        trained phase's vectors (and on their IVF residuals), with the
        seeding timed apart and the training's peak device memory; flat
        and IVF-256 8x16 indexes of the 1M vectors, each search_adc's
        recall@100 at least flat 8x8 OPQ ADC's on the same queries.
    """
    import importlib.util

    from qadc_tpu_torch.eval.recall import recall_at_r
    from qadc_tpu_torch.eval.synth import gist_moment_like
    from qadc_tpu_torch.index import flat, ivf
    from qadc_tpu_torch.kernels import lut_scan
    from qadc_tpu_torch.ops.knn import assign_nearest
    from qadc_tpu_torch.quantizers.opq import train_opq
    from qadc_tpu_torch.quantizers.pq import train_pq

    kmeans_mod = importlib.import_module("qadc_tpu_torch.ops.kmeans")
    out = {}

    def profiled_kernels(phase, fn):
        """require_kernels over one run of fn, its profiler window taken
        again (three in all) where it holds no record of a required kernel:
        the profiler drops some events (a whole-smoke run missed
        flat_scan8's one launch in a window that phase 9 alone had seen)."""
        for window in range(1, 4):
            seen = kernels_seen(torch, fn)[0]
            if all(any(k in name for name in seen) for k in PROFILED_KERNELS[phase]):
                break
            print(f"{phase}: profiler window {window} holds no record of a required kernel "
                  f"(kernels seen: {sorted(n for n in seen if 'kernel' in n)})", flush=True)
        return require_kernels(phase, seen)

    def recall_in_batches(path, search_fn, qs, gt, batch):
        labels = ctx.drive(path, lambda: torch.cat(
            [search_fn(qs[s:s + batch])[1] for s in range(0, qs.shape[0], batch)]).cpu().numpy())
        check(labels.shape == (qs.shape[0], R) and labels.min() >= 0, f"{path}: labels")
        rec = recall_at_r(labels, gt)
        print(f"recall@{R} {path}: {rec} (true neighbours, {qs.shape[0]} queries, batches of "
              f"{batch}) [{card}]", flush=True)
        return rec

    # ---- (a) the example ----------------------------------------------------
    path = Path(__file__).resolve().parent / "examples" / "torch_sift_pipeline.py"
    spec = importlib.util.spec_from_file_location("torch_sift_pipeline", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)

    def timed_s(label, fn, into: dict):
        """fn(), timed to a synchronise; into[label up to " ("] = seconds."""
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        into[label.split(" (")[0]] = s = time.perf_counter() - t
        print(f"{label}: {s:.2f} s [{card}]", flush=True)
        return res

    secs = {}

    learn, base, query, gt, name = timed_s(
        f"example data (the stand-in: {ex.LEARN} learn, {ex.BASE} base, {ex.QUERIES} queries, "
        "and its exact top-10)", lambda: ex.load_or_synthesize(None, device), secs)
    check(name == "synthetic" and query.device == device, "example: data")
    index, seconds = ex.build(learn, base)
    labels = ctx.drive("example", lambda: ex.search(index, query)[1]).cpu().numpy()
    rec = recall_at_r(labels, gt)
    seen = profiled_kernels("example", lambda: ex.search(index, query))
    print(f"example: recall@{R} {rec} over {query.shape[0]} queries in one search (floor "
          f"{EXAMPLE_FLOOR}; the JAX example on the CPU: 0.7930); stage seconds "
          f"{json.dumps(seconds)} [{card}]", flush=True)
    check(rec >= EXAMPLE_FLOOR, f"example: recall@{R} {rec} below {EXAMPLE_FLOOR}")
    out["example"] = {"recall": rec, "seconds": {**secs, **seconds}, "profiled": seen,
                      "part_pad": index.part_pad}
    del learn, base, query, index

    # ---- (b) the GIST1M geometry ---------------------------------------------
    t0 = time.perf_counter()
    gbase_np, gq_np = gist_moment_like(np.random.default_rng(0), GIST_N, nq=GIST_NQ)
    draw_s = time.perf_counter() - t0
    print(f"gist data: gist_moment_like {GIST_N} x {gbase_np.shape[1]} + {GIST_NQ} queries "
          f"(host): {draw_s:.2f} s", flush=True)
    gbase = torch.from_numpy(gbase_np).to(device)
    gq = torch.from_numpy(gq_np).to(device)
    del gbase_np, gq_np
    secs = {"draw_host": draw_s}
    ggt = timed_s(f"gist ground truth (exact 1-NN of {GIST_NQ} queries)",
                  lambda: assign_nearest(gq, gbase), secs).cpu().numpy()
    glearn = gbase[:GIST_LEARN]

    opq_kw = dict(opq_iters=6, kmeans_iters=12)
    g168 = timed_s(f"train_opq 16x8 (opq_iters 6, kmeans_iters 12, {GIST_LEARN} x 960)",
                   lambda: train_opq(20, glearn, 16, 8, **opq_kw), secs)
    g324 = timed_s("train_opq 32x4", lambda: train_opq(21, glearn, 32, 4, **opq_kw), secs)
    gcoarse = timed_s("train_coarse 256 (iters 25, balance_cap 3.0)",
                      lambda: ivf.train_coarse(22, glearn, 256, iters=25, balance_cap=3.0), secs)
    gres = glearn - gcoarse[assign_nearest(glearn, gcoarse).long()]
    r168 = timed_s("train_opq 16x8 on residuals", lambda: train_opq(23, gres, 16, 8, **opq_kw), secs)
    r324 = timed_s("train_opq 32x4 on residuals", lambda: train_opq(24, gres, 32, 4, **opq_kw), secs)
    del gres
    g = {
        "flat_16x8": timed_s(f"build flat 16x8, {GIST_N}", lambda: flat.add(
            flat.FlatIndex.create(g168), gbase), secs),
        "flat_32x4": timed_s(f"build flat 32x4, {GIST_N}", lambda: flat.add(
            flat.FlatIndex.create(g324), gbase), secs),
        "ivf_16x8": timed_s(f"build IVF-256 16x8, {GIST_N}", lambda: ivf.add(
            ivf.IVFIndex.create(r168, gcoarse), gbase), secs),
        "ivf_32x4": timed_s(f"build IVF-256 32x4, {GIST_N}", lambda: ivf.add(
            ivf.IVFIndex.create(r324, gcoarse), gbase), secs),
    }
    del gbase, glearn
    for nm in ("ivf_16x8", "ivf_32x4"):
        ix = g[nm]
        check(ix.n == GIST_N and int(ix.part_sizes.sum()) == GIST_N, f"gist {nm}: code count")
        print(f"gist {nm}: part_pad {ix.part_pad}, largest partition {ix.max_part_size}, "
              f"smallest {int(ix.part_sizes.min())}", flush=True)
    flat_keep = max(200 / GIST_N, 0.00213)
    gist_runs = {
        "gist_flat_adc8": lambda qs, k=lut_scan.DISPATCH: flat.search_adc(
            g["flat_16x8"], qs, r=R, kernels=k),
        "gist_flat_qadc": lambda qs, k=lut_scan.DISPATCH: flat.search_qadc(
            g["flat_32x4"], qs, r=R, keep=flat_keep, kernels=k),
        "gist_ivf_adc8": lambda qs, k=lut_scan.DISPATCH: ivf.search_adc(
            g["ivf_16x8"], qs, r=R, ma=MA, kernels=k),
        "gist_ivf_qadc": lambda qs, k=lut_scan.DISPATCH: ivf.search_qadc(
            g["ivf_32x4"], qs, r=R, ma=MA, keep=GIST_IVF_KEEP, kernels=k),
        "gist_ivf_qadc_norerank": lambda qs, k=lut_scan.DISPATCH: ivf.search_qadc(
            g["ivf_32x4"], qs, r=R, ma=MA, keep=GIST_IVF_KEEP, rerank=False, kernels=k),
    }
    recalls = {p: recall_in_batches(p, fn, gq, ggt, TRAIN_BATCH) for p, fn in gist_runs.items()}
    recalls["gist_ivf_qadc_b1"] = recall_in_batches("gist_ivf_qadc_b1", gist_runs["gist_ivf_qadc"],
                                                    gq, ggt, 1)
    check(ctx.launches["gist_ivf_qadc_b1"]["grouped_scan"] == 0, "gist b=1: M1 launched")
    for p in PROFILED_KERNELS:
        if p.startswith("gist_"):
            b = 128 if p.endswith("b128") else 1 if p.endswith("b1") else TRAIN_BATCH
            run = gist_runs[p.replace("_b128", "").replace("_b1", "")]
            out.setdefault("gist_profiled", {})[p] = profiled_kernels(p, lambda: run(gq[:b]))
    for p, fn in gist_runs.items():
        for b in (32, 128):
            ctx.e2e(p, b, lambda: fn(gq[:b]))
    ctx.e2e("gist_ivf_qadc", 1, lambda: gist_runs["gist_ivf_qadc"](gq[:1]))

    # The kernels at the GIST widths, at the arguments the searches hand them:
    # a Kernels whose entries keep their arguments (and call the real ones).
    def recorded(run, *fields):
        calls = {f: [] for f in fields}

        def keeping(f):
            real = getattr(lut_scan.DISPATCH, f)

            def fn(*args):
                calls[f].append(args)
                return real(*args)
            return fn

        run(lut_scan.DISPATCH._replace(**{f: keeping(f) for f in fields}))
        torch.cuda.synchronize()
        return [calls[f] for f in fields]

    def exact(what):
        def compare(got, want):
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            check(all(a is b is None or torch.equal(a, b) for a, b in pairs),
                  f"{what} differs from its plain version")
            return 0.0
        return compare

    def minima_err(what):  # float minima rtol 1e-6, ids equal where minima are
        def compare(got, want):
            (gv, gi), (wv, wi) = got, want
            err = inf_float_err(torch, gv, wv, f"{what} minima")
            check(torch.equal(gi[gv == wv], wi[gv == wv]), f"{what} argmin ids")
            return err
        return compare

    def row(name, cu_name, src, replaces, fn, plain, compare, moved, ops, peak, path):
        ctx.kernel_phase(name, cu_name, f"qadc_tpu_torch/csrc/{src}",
                         f"qadc_tpu/kernels/lut_scan.py:{replaces}", fn, plain, compare,
                         moved, ops, peak, path=path)

    def flat_row(name, cu_name, src, replaces, fn, plain, compare, args, path):
        codes, tables, n = args[:3]   # codes and tables once; a sum a (query, code, sq)
        peak = PEAK_INT8 if tables.dtype == torch.int8 else PEAK_F32
        row(name, cu_name, src, replaces, lambda: fn(*args), lambda: plain(*args), compare,
            nbytes(codes, tables), tables.shape[0] * n * tables.shape[1], peak, path)

    def grouped_row(name, cu_name, src, replaces, fn, plain, compare, ix, qs, args, path):
        probes = ivf.assign_queries(ix, qs, MA)[0].reshape(-1).long()
        moved = (torch.unique(probes).numel() * ix.codes.shape[1] * 128
                 + nbytes(*args[1:]))  # each probed partition once, tables, routing
        adds = int(ix.part_sizes[probes].sum()) * ix.pq.sq_count
        row(name, cu_name, src, replaces, lambda: fn(*args), lambda: plain(*args), compare,
            moved, adds, PEAK_INT8 if args[1].dtype == torch.int8 else PEAK_F32, path)

    def m2_rows(tag, calls, path):
        check(len(calls) == 2, f"{tag}: {len(calls)} rows_adc launches, not 2")
        for stage, args in zip(("keep-prefix", "rerank"), calls):
            row_ids, pair_ids, tlo = args[1], args[2], args[3]
            cpr = 128 // (tlo.shape[1] // 16)
            moved = (torch.unique(row_ids).numel() * 128 + nbytes(row_ids, pair_ids)
                     + torch.unique(pair_ids).numel() * 2 * tlo.shape[1] * 4)
            row(f"rows_adc[{tag} {stage} A={row_ids.shape[0]}]", "rows_adc_kernel",
                "rows_adc.cu", 1148, lambda args=args: lut_scan.rows_adc(*args),
                lambda args=args: lut_scan.rows_adc_plain(*args), exact("rows_adc"),
                moved, row_ids.shape[0] * cpr * (tlo.shape[1] // 8), PEAK_F32, path)

    q32, q128 = gq[:32], gq[:128]
    (f8,) = recorded(lambda k: gist_runs["gist_flat_adc8"](q32, k), "flat_scan8")
    flat_row("flat_scan8[gist m=16 b=32]", "flat_scan8_qm_kernel", "flat_scan8_qm.cuh", 1601,
             lut_scan.flat_scan8, lut_scan.flat_scan8_plain, minima_err("flat_scan8"), f8[0],
             "gist_flat_adc8")
    for qs, tag, cu_name, src in ((q128, "b=128", "flat_scan_wgmma_kernel", "scan_wgmma.cu"),
                                  (q32, "b=32", "flat_scan_mma_kernel", "scan_mma.cu")):
        fs, m2 = recorded(lambda k: gist_runs["gist_flat_qadc"](qs, k), "flat_scan", "rows_adc")
        flat_row(f"flat_scan[gist cb=16 {tag}]", cu_name, src, 522, lut_scan.flat_scan,
                 lut_scan.flat_scan_plain, exact("flat_scan"), fs[0], "gist_flat_qadc")
        if tag == "b=128":
            m2_rows("gist flat b=128", m2, "gist_flat_qadc")
    (g8,) = recorded(lambda k: gist_runs["gist_ivf_adc8"](q32, k), "grouped_scan8")
    grouped_row("grouped_scan8[gist m=16 b=32]", "grouped_scan8_sm_kernel", "grouped_scan8_sm.cu",
                1872, lut_scan.grouped_scan8, lut_scan.grouped_scan8_plain,
                minima_err("grouped_scan8"), g["ivf_16x8"], q32, g8[0], "gist_ivf_adc8")
    for qs, tag in ((q32, "b=32"), (q128, "b=128")):
        m1, m2 = recorded(lambda k: gist_runs["gist_ivf_qadc"](qs, k), "grouped_scan", "rows_adc")
        grouped_row(f"grouped_scan[gist cb=16 {tag}]", "grouped_scan_mma_kernel", "scan_mma.cu",
                    857, lut_scan.grouped_scan, lut_scan.grouped_scan_plain, exact("grouped_scan"),
                    g["ivf_32x4"], qs, m1[0], "gist_ivf_qadc")
        m2_rows(f"gist ivf {tag}", m2, "gist_ivf_qadc")
    (m3,) = recorded(lambda k: ivf.search_qadc(g["ivf_32x4"], gq[:1], r=R, ma=MA,
                                               keep=GIST_IVF_KEEP, direct=True, kernels=k),
                     "direct_scan")
    ctx.m3_phases(g["ivf_32x4"], "gist b=1", m3[0], "gist_ivf_qadc_b1")
    out["gist"] = {"recall": recalls, "seconds": secs,
                   "part_pad": g["ivf_32x4"].part_pad, "n": GIST_N, "nq": GIST_NQ}
    del g, gq, gcoarse
    torch.cuda.empty_cache()

    # ---- (c) 16-bit training -------------------------------------------------
    base = torch.from_numpy(sift["base_np"]).to(device)
    learn = base[:SIXTEEN_LEARN]
    seeding = []
    seed_fn = kmeans_mod.kmeans_plusplus_init

    def timed_seeding(*args, **kw):  # k-means++ alone, inside train_pq
        torch.cuda.synchronize()
        t = time.perf_counter()
        c = seed_fn(*args, **kw)
        torch.cuda.synchronize()
        seeding.append(time.perf_counter() - t)
        return c

    sixteen = {}
    kmeans_mod.kmeans_plusplus_init = timed_seeding
    try:
        for nm, data in (("flat", lambda: learn),
                         ("ivf", lambda: learn - sift["coarse"][
                             assign_nearest(learn, sift["coarse"]).long()])):
            x = data()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            before = torch.cuda.memory_allocated(device)
            t = time.perf_counter()
            q16 = train_pq(30 + len(sixteen), x, 8, 16, iters=SIXTEEN_ITERS)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated(device) - before
            check(bool(torch.isfinite(q16.centroids).all()), f"8x16 {nm}: centroids")
            sixteen[nm] = {"pq": q16, "train_s": sec, "seeding_s": seeding[-1],
                           "peak_bytes": peak}
            print(f"train_pq 8x16 ({nm}: {SIXTEEN_LEARN} vectors{', residuals' if nm == 'ivf' else ''}, "
                  f"iters {SIXTEEN_ITERS}): {sec:.2f} s, k-means++ seeding of 65,536 centroids "
                  f"{seeding[-1]:.2f} s, peak device memory {peak / 2**30:.2f} GiB over "
                  f"{before / 2**30:.2f} GiB held [{card}]", flush=True)
            del x
    finally:
        kmeans_mod.kmeans_plusplus_init = seed_fn
    build_s = {}
    i16 = {
        "flat": timed_s(f"build flat 8x16, {base.shape[0]}", lambda: flat.add(
            flat.FlatIndex.create(sixteen["flat"]["pq"]), base), build_s),
        "ivf": timed_s(f"build IVF-256 8x16, {base.shape[0]}", lambda: ivf.add(
            ivf.IVFIndex.create(sixteen["ivf"]["pq"], sift["coarse"]), base), build_s),
    }
    del base, learn
    tq, floor = sift["tq"], sift["floor"]
    for nm, run in (("sixteen_flat", lambda qs: flat.search_adc(i16["flat"], qs, r=R)),
                    ("sixteen_ivf", lambda qs: ivf.search_adc(i16["ivf"], qs, r=R, ma=MA))):
        rec = recall_in_batches(nm, run, tq, sift["gt"], TRAIN_BATCH)
        check(rec >= floor, f"{nm}: recall@{R} {rec} below flat 8x8 OPQ ADC's {floor}")
        sixteen[nm.split("_")[1]]["recall"] = rec
        ctx.e2e(nm, TRAIN_BATCH, lambda: run(tq[:TRAIN_BATCH]))
    out["sixteen"] = {k: {kk: vv for kk, vv in v.items() if kk != "pq"}
                      for k, v in sixteen.items()}
    out["sixteen"]["floor"] = floor
    out["sixteen"]["build_s"] = build_s
    print(json.dumps({"surface": out, "card": card}), flush=True)
    return out


def oracle(torch, index, queries, code_view, unpack_codes, ivf):
    """Exact float64 ADC over every real code of the probed partitions, at 4,
    8 or 16 bits.

    The probes are the search's own (ivf.assign_queries); tables, sums and
    the ranking are recomputed here in float64 with plain torch. The bench
    indexes are plain PQ, so residuals need no rotation.
    Returns (dists (Q, R) float64, labels (Q, R) int64).
    """
    parts, _ = ivf.assign_queries(index, queries, MA)
    parts = parts.long()
    m, k, dsq = index.pq.centroids.shape
    cents = index.pq.centroids.double()
    codes = code_view(index.codes, index.pq.code_size)
    out_d, out_l = [], []
    step = 8 if k <= 256 else 1  # 16-bit tables: 1.6 GB of float64 a query
    for s in range(0, queries.shape[0], step):
        p = parts[s:s + step]
        res = queries[s:s + step].double()[:, None, :] - index.coarse_centroids.double()[p]
        tab = ((res.reshape(*p.shape, m, 1, dsq) - cents) ** 2).sum(-1)  # (q, ma, M, K)
        idx = unpack_codes(codes[p], m, index.pq.sq_bits).long()          # (q, ma, pad, M)
        d = torch.gather(tab[:, :, None].expand(*idx.shape, k), -1, idx[..., None])
        d = d[..., 0].sum(-1)                                             # (q, ma, pad)
        col = torch.arange(index.part_pad, device=d.device)
        d = torch.where(col < index.part_sizes[p][..., None], d, torch.inf)
        lab = index.labels[p].long()
        sv, order = torch.sort(d.reshape(d.shape[0], -1), dim=-1, stable=True)
        out_d.append(sv[:, :R])
        out_l.append(torch.gather(lab.reshape(d.shape[0], -1), 1, order[:, :R]))
    return torch.cat(out_d), torch.cat(out_l)


def flat_oracle(torch, index, queries, unpack_codes):
    """Exact float64 ADC over every real code of a flat index, at 4, 8 or 16
    bits: tables, sums and the ranking recomputed in float64 with plain
    torch, a few queries at a time. The bench indexes are plain PQ, so the
    queries need no rotation.
    Returns (dists (Q, R) float64, labels (Q, R) int64).
    """
    m, k, dsq = index.pq.centroids.shape
    cents = index.pq.centroids.double()
    idx = unpack_codes(index.codes.reshape(-1, index.pq.code_size), m,
                       index.pq.sq_bits).long()                          # (n_pad, M)
    real = torch.arange(idx.shape[0], device=idx.device) < index.n
    out_d, out_l = [], []
    step = 8 if k <= 256 else 2  # 16-bit tables: 64 MB of float64 a query
    for s in range(0, queries.shape[0], step):
        qs = queries[s:s + step].double()
        tab = ((qs.reshape(-1, m, 1, dsq) - cents) ** 2).sum(-1)          # (q, M, K)
        d = torch.zeros((qs.shape[0], idx.shape[0]), dtype=torch.float64, device=qs.device)
        for mm in range(m):
            d += tab[:, mm][:, idx[:, mm]]
        d = torch.where(real, d, torch.inf)
        sv, order = torch.sort(d, dim=-1, stable=True)
        out_d.append(sv[:, :R])
        out_l.append(order[:, :R])
    return torch.cat(out_d), torch.cat(out_l)


if __name__ == "__main__":
    sys.exit(main())
