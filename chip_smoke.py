#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card: its IVF and flat searches
over seeded random indexes, then train -> build -> save -> load -> search on
one million SIFT-like vectors, held to recall against true neighbours.

    python3 chip_smoke.py        # from the root of a checkout, one CUDA card

It builds the hand-written CUDA kernels from qadc_tpu_torch/csrc/ with nvcc
(into build/kernels/, one compiler per source, in parallel), makes the
seeded indexes of qadc_tpu_torch/eval/synth.py on the card: the bench IVF
geometry (IVF-256, dim 128, 3906 codes per partition, about 1M codes: 16x4
PQ, 8x8 PQ and 8x16 PQ) and the reference's flat SIFT1M size (1M codes
padded to 1,000,448, dim 128: 16x4, 8x8 and 8x16 PQ), and then:

  1. kernel phases: each kernel against its plain PyTorch version on the
     card, at the shapes the search gives it (M1 at b=128's routed groups,
     M2 at b=128's keep-prefix and rerank shapes, M3 at b=1's 24 pairs; M1
     with float tables and grouped_scan8 at search_adc's b=32 groups on the
     16x4 and 8x8 indexes; flat_scan with int8 tables, with and without
     argmin rows, and with float tables over the 1M flat 16x4 codes at
     b=128, and flat_scan8 over the flat 8x8 codes at b=32);
  2. search phases, each with the launch counts reset just before and read
     just after, and every kernel of its path required to have launched:
     ivf.search_qadc at b=1 (direct path), b=32 and b=128 (grouped path),
     r=100, ma=24, keep=0.005; ivf.search_adc at b=32, r=100, ma=24 on the
     4-, 8- and 16-bit indexes; flat.search_qadc (keep=0.01) and
     flat.search_adc 4-bit at b=128, flat.search_adc 8- and 16-bit at b=32,
     r=100. Each result is held against the same search through the plain
     versions and against an exact float64 ADC oracle over the same codes
     (the probed partitions; every real flat code);
  3. timing with CUDA events (warm-up, then the median and p90 of 100 runs): us/query
     per batch, and each kernel beside its plain version; torch.profiler's
     CUDA events give device time (each kernel alone; the device's busy and
     idle share of a search);
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
     flat_scan_window against its plain version at (block 1024, W 16)
     min-only, transposed, with argmin ids and with float tables, and at
     (block 512, W 8); flat_scan_window_regs against flat_scan_window, exact;
     lut_scan_topk_int8 r=100 against the exact scan; the same over a 32x4
     index (W 16 != cpr 8), and the three scans' device times side by side.

Beside each kernel's time the `kernels` line gives its bound: the larger of
the bytes it must move (each input read once, each output written once) over
3.35 TB/s and its additions over the peak for their type (int8 tables: 1,979
TOP/s; float sums: 67 TFLOP/s), counted from this run's inputs.

Any failed check raises, so the script exits non-zero and prints no result.
The line before the last is the card's name and power limit as nvidia-smi
reports them, and the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

R, MA, KEEP = 100, 24, 0.005
BATCHES = (1, 32, 128)
ADC_BATCH = 32           # search_adc's phases (bench.py's adc4_b32 / adc8_b32)
# Timed runs per measurement: 100 leave ten samples beyond the p90. A plain
# version (tens of ms at the flat shapes) is timed over PLAIN_REPS runs.
REPS, PLAIN_REPS, WARMUP = 100, 10, 3
# Published peaks of one H100 SXM: HBM bytes/s, int8 and float32 operations/s.
PEAK_BYTES, PEAK_INT8, PEAK_F32 = 3.35e12, 1979e12, 67e12
# M2/M3 float sums: rtol 1e-6, atol 1e-5 * max|plain| (same sum order, but
# the compiler may round differently); M1 int32: exact.
RTOL, ATOL_REL = 1e-6, 1e-5
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
}
# The path whose run gives a kernel phase its launch count (default: qadc).
PATH_OF = {"grouped_scan_f32": "adc4", "grouped_scan8": "adc8", "flat_scan": "flat_qadc",
           "flat_scan_f32": "flat_adc4", "flat_scan8": "flat_adc8",
           "flat_scan_window": "window_scan", "flat_scan_window_regs": "window_scan"}
# The trained phase (bench.py:_bench_recall_parity): sizes, the keep of the
# reference's -k 0.213 (% of N; per partition here), and the recall floors:
# the JAX package's 1M record (0.9063 / 0.9844 / 0.9141) less 0.035 for 128
# queries and another PRNG.
TRAIN_N, TRAIN_LEARN, TRAIN_NQ, TRAIN_BATCH = 1_000_000, 100_000, 128, 32
TRAIN_KEEP = 0.00213 * 4
RECALL_FLOORS = {"flat_8x8_adc": 0.87, "ivf256_8x8_adc_ma24": 0.95,
                 "ivf256_16x4_qadc_ma24": 0.88}
WINDOW_N32 = 100_000     # codes of the 32x4 window-scan index


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and (kernel is None or kernel in e.key))
    check(total > 0, f"profiler saw no device time ({kernel or 'all'})")
    return total / reps / 1e3


def nbytes(*tensors) -> int:
    """Bytes of the tensors (nested tuples and None allowed)."""
    total = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            total += nbytes(*t)
        elif t is not None:
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
                                           sift_moment_like)
    from qadc_tpu_torch.index import flat, ivf
    from qadc_tpu_torch.index.routing import route_queries
    from qadc_tpu_torch.io.checkpoint import load_index, save_index
    from qadc_tpu_torch.kernels import build, lut_scan
    from qadc_tpu_torch.kernels.scan_ref import adc_scan_int8, scan_topk_int8
    from qadc_tpu_torch.ops.knn import assign_nearest
    from qadc_tpu_torch.quantizers.opq import train_opq
    from qadc_tpu_torch.quantizers.pq import train_pq

    t_start = time.perf_counter()
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
                     in_bytes, ops, peak):
        """Hold a kernel to its plain version, time both, and bound it:
        in_bytes are the input bytes the function must read (the outputs'
        are added here), ops its additions, peak their peak rate."""
        got, want = kernel_fn(), plain_fn()
        torch.cuda.synchronize()
        err = compare(got, want)
        del want
        # ms: device time (the kernel alone; all of the plain version's
        # kernels); call_ms: CUDA events around one call, host work included.
        ms = device_ms(torch, kernel_fn, cu_name)
        plain_ms = device_ms(torch, plain_fn, reps=PLAIN_REPS)
        call_ms = time_ms(torch, kernel_fn)[0]
        plain_call_ms = time_ms(torch, plain_fn, PLAIN_REPS)[0]
        least, by = bound_ms(in_bytes + nbytes(got), ops, peak)
        kernels[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": least, "bound_by": by,
                         "library_ms": None,  # no one PyTorch call computes a LUT scan
                         "call_ms": call_ms, "plain_call_ms": plain_call_ms}
        print(f"kernel {name}: max_abs_err={err:.3g} device ms={ms:.4f} (plain {plain_ms:.4f}; "
              f"bound {least:.4f} by {by}) call ms={call_ms:.4f} (plain {plain_call_ms:.4f}) "
              f"[{card}]", flush=True)

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
        check(torch.equal(got, want), "grouped_scan differs from its plain version")
        return 0.0

    kernel_phase("grouped_scan", "grouped_scan_kernel", "qadc_tpu_torch/csrc/grouped_scan.cu",
                 "qadc_tpu/kernels/lut_scan.py:857",
                 lambda: lut_scan.grouped_scan(*m1_args),
                 lambda: lut_scan.grouped_scan_plain(*m1_args), exact_int,
                 *grouped_work(index, parts, m1_args[1], m1_args[2:]), PEAK_INT8)

    rpp = index.codes.shape[1]
    ppr = -(-prefix_pad // index.cpr)
    flat_rows = index.codes.reshape(-1, 128)
    gen = torch.Generator(device=device).manual_seed(0)
    a_rerank = qb.shape[0] * R                     # Q * wq selected windows
    m2_shapes = {
        "keep-prefix": (
            (parts.reshape(qa, 1) * rpp + torch.arange(ppr, device=device,
                                                       dtype=torch.int32)).reshape(-1),
            torch.arange(qa, device=device, dtype=torch.int32).repeat_interleave(ppr)),
        "rerank": (
            torch.randint(0, flat_rows.shape[0], (a_rerank,), generator=gen,
                          device=device, dtype=torch.int32),
            torch.randint(0, qa, (a_rerank,), generator=gen, device=device,
                          dtype=torch.int32)),
    }
    for shape_name, (row_ids, pair_ids) in m2_shapes.items():
        m2_args = (flat_rows, row_ids, pair_ids, tlo, thi)
        kernel_phase(f"rows_adc[{shape_name} A={row_ids.shape[0]}]", "rows_adc_kernel",
                     "qadc_tpu_torch/csrc/rows_adc.cu", "qadc_tpu/kernels/lut_scan.py:1148",
                     lambda: lut_scan.rows_adc(*m2_args),
                     lambda: lut_scan.rows_adc_plain(*m2_args),
                     lambda got, want: float_err(torch, got, want, "rows_adc"),
                     # each scored row and referenced table once, the two id lists
                     torch.unique(row_ids).numel() * 128 + nbytes(row_ids, pair_ids)
                     + torch.unique(pair_ids).numel() * 2 * tlo.shape[1] * 4,
                     row_ids.shape[0] * index.cpr * index.pq.sq_count, PEAK_F32)

    p1, rot1 = ivf.assign_queries(index, queries[1], MA)
    t1lo, t1hi = ivf.tile_tables_rows(
        ivf.adc_tables(rot1, index.pq.centroids).reshape(MA, 16, 16))
    pflat = p1.reshape(MA)
    m3_args = (index.codes, pflat, t1lo, t1hi, index.part_sizes[pflat.long()])

    def direct_err(got, want):
        (gd, gm), (wd, wm) = got, want
        big = wd == lut_scan.MASK_BIG
        check(torch.equal(gd == lut_scan.MASK_BIG, big), "direct_scan MASK_BIG placement")
        err = float_err(torch, torch.where(big, 0.0, gd), torch.where(big, 0.0, wd),
                        "direct_scan distances")
        return max(err, float_err(torch, gm, wm, "direct_scan tile minima"))

    kernel_phase("direct_scan", "direct_scan_kernel", "qadc_tpu_torch/csrc/rows_adc.cu",
                 "qadc_tpu/kernels/lut_scan.py:1206",
                 lambda: lut_scan.direct_scan(*m3_args),
                 lambda: lut_scan.direct_scan_plain(*m3_args), direct_err,
                 torch.unique(pflat).numel() * rpp * 128 + nbytes(*m3_args[1:]),
                 int(m3_args[4].sum()) * index.pq.sq_count, PEAK_F32)

    # search_adc's kernels at its b=32 groups: M1 with float tables on the
    # 16x4 index, grouped_scan8 with bf16 tables on the 8x8 index.
    adc_indexes = {bits: ivf_index_from_arrays(*make(rng), device) for bits, make in
                   ((8, bench_ivf8_arrays), (16, bench_ivf16_arrays))}
    adc_indexes[4] = index
    qadc = queries[ADC_BATCH]

    def adc_group_args(ix):
        p, rot = ivf.assign_queries(ix, qadc, MA)
        t = ivf.adc_tables(rot, ix.pq.centroids).reshape(qadc.shape[0] * MA, ix.pq.sq_count, -1)
        rt = route_queries(p, ix.part_count, 128)
        return p, t, (rt.group_part, rt.slot_pairs(), ivf._group_sizes(ix, rt))

    p4, t4, groups4 = adc_group_args(index)
    m1f_args = (index.codes, t4, *groups4)
    kernel_phase("grouped_scan_f32", "grouped_scan_kernel", "qadc_tpu_torch/csrc/grouped_scan.cu",
                 "qadc_tpu/kernels/lut_scan.py:857",
                 lambda: lut_scan.grouped_scan(*m1f_args),
                 lambda: lut_scan.grouped_scan_plain(*m1f_args),
                 lambda got, want: inf_float_err(torch, got, want, "grouped_scan_f32"),
                 *grouped_work(index, p4, t4, groups4), PEAK_F32)

    p8, t8, groups8 = adc_group_args(adc_indexes[8])
    m8_args = (adc_indexes[8].codes, t8.to(torch.bfloat16), *groups8)

    def scan8_err(got, want):
        (gv, gi), (wv, wi) = got, want
        err = inf_float_err(torch, gv, wv, "grouped_scan8 minima")
        same = gv == wv  # where the minima agree bit for bit, so must the argmin
        check(torch.equal(gi[same], wi[same]), "grouped_scan8 argmin indices")
        return err

    kernel_phase("grouped_scan8", "grouped_scan8_kernel", "qadc_tpu_torch/csrc/grouped_scan8.cu",
                 "qadc_tpu/kernels/lut_scan.py:1872",
                 lambda: lut_scan.grouped_scan8(*m8_args),
                 lambda: lut_scan.grouped_scan8_plain(*m8_args), scan8_err,
                 *grouped_work(adc_indexes[8], p8, m8_args[1], groups8), PEAK_F32)

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

    for name, args, compare, replaces in (
        ("flat_scan", (fi4.codes, fqt, fi4.n), flat_rows_exact, 522),
        ("flat_scan[with_rows]", (fi4.codes, fqt, fi4.n, True), flat_rows_exact, 281),
        ("flat_scan_f32", (fi4.codes, ft4, fi4.n),
         lambda got, want: inf_float_err(torch, got[0], want[0], "flat_scan_f32"), 522),
    ):
        kernel_phase(name, "flat_scan_kernel", "qadc_tpu_torch/csrc/flat_scan.cu",
                     f"qadc_tpu/kernels/lut_scan.py:{replaces}",
                     lambda a=args: lut_scan.flat_scan(*a),
                     lambda a=args: lut_scan.flat_scan_plain(*a), compare,
                     *flat_work(*args[:3]))
    kernel_phase("flat_scan8", "flat_scan8_kernel", "qadc_tpu_torch/csrc/flat_scan8.cu",
                 "qadc_tpu/kernels/lut_scan.py:1601",
                 lambda: lut_scan.flat_scan8(fi8.codes, ft8, fi8.n),
                 lambda: lut_scan.flat_scan8_plain(fi8.codes, ft8, fi8.n),
                 argmin_err("flat_scan8"), *flat_work(fi8.codes, ft8, fi8.n))

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
        return out

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

    trng = np.random.default_rng(7)  # the JAX bench's recall stage draws from the same seed
    base_np, tq_np = timed(f"data: sift_moment_like {TRAIN_N} x 128 (host)",
                           lambda: sift_moment_like(trng, TRAIN_N, nq=TRAIN_NQ))
    base = torch.from_numpy(base_np).to(device)
    tq = torch.from_numpy(tq_np).to(device)
    del base_np
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

    def window_f32(got, want):
        return inf_float_err(torch, got[0], want[0], "flat_scan_window float minima")

    window_src = "qadc_tpu_torch/csrc/flat_scan_window.cu"
    for tag, ix, tab, bn, w, kw, compare, replaces in (
        ("b1024 w16", fw, wqt, 1024, 16, {}, window_exact, 281),
        ("b1024 w16 transposed", fw, wqt, 1024, 16, {"transpose_out": True}, window_exact, 281),
        ("b1024 w16 with_rows", fw, wqt, 1024, 16, {"with_rows": True}, window_exact, 281),
        ("b1024 w16 f32", fw, wft, 1024, 16, {}, window_f32, 281),
        ("b512 w8", fw, wqt, 512, 8, {}, window_exact, 281),
        ("32x4 b1024 w16 with_rows", fw32, wqt32, 1024, 16, {"with_rows": True},
         window_exact, 1991),
    ):
        kernel_phase(f"flat_scan_window[{tag}]", "flat_scan_window_kernel", window_src,
                     f"qadc_tpu/kernels/lut_scan.py:{replaces}",
                     lambda: lut_scan.flat_scan_window(ix.codes, tab, ix.n, bn, w, **kw),
                     lambda: lut_scan.flat_scan_window_plain(ix.codes, tab, ix.n, bn, w, **kw),
                     compare, *flat_work(ix.codes, tab, ix.n))

    def regs_exact(got, want):
        check(torch.equal(got, want), "flat_scan_window_regs differs from flat_scan_window")
        return 0.0

    for tag, ix, tab, bn, w in (("b1024 w16", fw, wqt, 1024, 16), ("b512 w8", fw, wqt, 512, 8),
                                ("32x4 b1024 w16", fw32, wqt32, 1024, 16)):
        # Held to kernel (a), exact; its plain version is (a)'s.
        check(torch.equal(lut_scan.flat_scan_window_regs(ix.codes, tab, ix.n, bn, w),
                          lut_scan.flat_scan_window(ix.codes, tab, ix.n, bn, w)[0]),
              f"flat_scan_window_regs[{tag}] differs from flat_scan_window")
        kernel_phase(f"flat_scan_window_regs[{tag}]", "flat_scan_window_regs_kernel", window_src,
                     "qadc_tpu/kernels/lut_scan.py:631",
                     lambda: lut_scan.flat_scan_window_regs(ix.codes, tab, ix.n, bn, w),
                     lambda: lut_scan.flat_scan_window_plain(ix.codes, tab, ix.n, bn, w)[0],
                     regs_exact, *flat_work(ix.codes, tab, ix.n))

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
        print(f"window path {tag}: lut_scan_topk_int8 r={R} values exact, ids < n, top-1 equal "
              f"to the exact scan; flat_scan_window_regs' best window equal", flush=True)

    ab = {k: kernels[k]["ms"] for k in ("flat_scan_window[b1024 w16]",
                                        "flat_scan_window_regs[b1024 w16]")}
    flat_now = device_ms(torch, lambda: lut_scan.flat_scan(fw.codes, wqt, fw.n),
                         "flat_scan_kernel")
    print(f"A/B b=128 x {fw.n_pad} trained 16x4 codes, device ms: flat_scan (W = cpr, "
          f"transposed) {flat_now:.4f}; flat_scan_window (block 1024, W 16) "
          f"{ab['flat_scan_window[b1024 w16]']:.4f}; flat_scan_window_regs "
          f"{ab['flat_scan_window_regs[b1024 w16]']:.4f} [{card}]", flush=True)

    # The launch count of each kernel phase comes from the path that runs it.
    line = {"kernels": []}
    for name, k in kernels.items():
        base = name.split("[")[0]
        line["kernels"].append({**k, "launches": launches[PATH_OF.get(base, "qadc")][base]})
    print(f"total: {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps(line))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


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
