#!/usr/bin/env python3
"""The scan lab on one CUDA card: where the time of the 4-bit int8 scans goes.

    python3 scripts/torch_scan_lab.py          # one CUDA card, about 100 s
    python3 scripts/torch_scan_lab.py grouped  # the grouped section alone
    python3 scripts/torch_scan_lab.py window   # the window section alone

The counterpart of the JAX package's scratch scripts benchmarks/ab_tq.py,
ab_tq_ablate.py, kernel_lab.py and diag_direct.py, for the tensor-core scans
of qadc_tpu_torch/csrc/scan_mma.cu and scan_wgmma.cu (see qadc_tpu_torch/kernels/scan_lab.py
for the table of modes). Over 1,000,448 seeded random 16x4 codes and 128
queries' int8 tables it prints, in device milliseconds (torch.profiler,
100 launches each):

  A/B      flat_scan and flat_scan_window (int8 one-hot x table product:
           wgmma at this batch) against flat_scan_window_regs (tables in
           registers), after checking that all three give the plain
           version's minima bit for bit;
  sweep    flat_scan by its wgmma kernel and by its mma.sync kernel at 8 to
           128 queries: the crossover behind lut_scan.WGMMA_MIN_QUERIES;
  modes    the mma.sync scan with parts removed: full, const_onehot, no_mma,
           no_min, copy, expand_only, acc_only, min_only, and full with 32
           or 16 queries a warp;
  exact    mismatches of the mma scan against the plain version over
           adversarial tables (all 127, all 0, one-hot rows, random) at 16
           and 32 sub-quantizers, and the float32 selector sum's largest
           relative error against float64;
  M1       grouped_scan, held to its plain version, at the routed groups of
           32 and 128 queries x 24 probes over the seeded IVF-256 index.

  query-minor  the float32 flat_scan and flat_scan8 by their query-minor
           kernels (csrc/flat_scan_qm.cuh, flat_scan8_qm.cuh) against the
           kernels they replaced, at 128 and 32 queries; each at every chunk
           of queries it can stage; their lab modes (copy, no_min,
           const_code, and const_code of the replaced 8-bit kernel); both
           kernels of each scan by batch (the crossovers behind
           lut_scan.QUERY_MINOR_MIN_QUERIES and QUERY_MINOR_MIN_QUERIES8);
           an empty kernel (the launch floor), and selector_sum against
           torch.matmul in ten runs of 100 launches each.

  grouped  M1 with float32 tables and grouped_scan8 by their slot-minor
           kernels (csrc/grouped_scan_sm.cu, grouped_scan8_sm.cu), held to
           their plain versions, over the seeded IVF-256 16x4 and 8x8
           indexes at search_adc's routed groups of 1 to 128 queries x 24
           probes and at a hot partition (128 near-duplicate queries: whole
           groups of 128 live slots); each with its lab modes (copy, no_min,
           const_code, and every slot dead) at 32 queries and at the hot
           partition; the kernels' b=32 time in ten runs.

  window   the float32 flat_scan_window by its query-minor kernel
           (csrc/flat_scan_window_qm.cu) and by the lookup kernel
           (flat_scan_window_f32_lookup) at 1 to 128 queries, at
           (block 1024, W 16) and (512, 8) over the 16x4 codes and (1024, 16)
           over 1,000,448 seeded random 32x4 codes, both equal bit for bit
           at every batch first: the crossover behind the kernel choice of
           lut_scan.flat_scan_window.

The last two lines are one JSON object {"scan_lab": ...} and the card's name
and power limit. It exits non-zero without a card or on any disagreement.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from qadc_tpu_torch.convert import ivf_index_from_arrays  # noqa: E402
from qadc_tpu_torch.eval.synth import bench_ivf8_arrays, bench_ivf_arrays  # noqa: E402
from qadc_tpu_torch.index import ivf  # noqa: E402
from qadc_tpu_torch.index.routing import route_queries  # noqa: E402
from qadc_tpu_torch.kernels import lut_scan, scan_lab  # noqa: E402

N_PAD, N, Q, MA, REPS = 1_000_448, 1_000_000, 128, 24, 100


def device_ms(fn, kernel: str, reps: int = REPS, whole_call: bool = False) -> float:
    """Device milliseconds of the named kernel in one call of fn, or with
    whole_call of every kernel the call launches (a library call's)."""
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
                  if e.device_type == DeviceType.CUDA and kernel in e.key]
        count = sum(e.count for e in events)
        if count > 0:
            break
    if count <= 0:
        raise RuntimeError(f"the profiler saw no launch of {kernel!r} in three windows")
    total = sum(e.self_device_time_total for e in events)
    if whole_call:
        return total / reps / 1e3
    # The mean over the launches the profiler recorded: on a busy host it drops some.
    return total / count / 1e3


def query_minor(codes, dev, card: str) -> dict:
    """The query-minor section: see the module docstring."""
    rng = np.random.default_rng(1)
    t4 = torch.from_numpy(rng.random((Q, 16, 16)).astype(np.float32)).to(dev)
    t8 = torch.from_numpy(rng.random((32, 8, 256)).astype(np.float32)).to(torch.bfloat16).to(dev)
    scan_lab.check_query_minor(codes, t4, t8, N)
    new4, old4, new8, old8 = ("flat_scan_qm_kernel", "flat_scan_kernel", "flat_scan8_qm_kernel",
                              "flat_scan8_kernel")
    out = {"ab_ms": {
        "flat_scan_f32 b=128": device_ms(lambda: lut_scan.flat_scan(codes, t4, N), new4),
        "flat_scan_f32_lookup b=128": device_ms(
            lambda: lut_scan.flat_scan_f32_lookup(codes, t4, N), old4),
        "flat_scan_f32 b=128 with_rows": device_ms(
            lambda: lut_scan.flat_scan(codes, t4, N, True), new4),
        "flat_scan8 b=32": device_ms(lambda: lut_scan.flat_scan8(codes, t8, N), new8),
        "flat_scan8_lookup b=32": device_ms(lambda: lut_scan.flat_scan8_lookup(codes, t8, N), old8),
    }}
    print(f"query-minor A/B x {N_PAD} codes, device ms: {out['ab_ms']} [{card}]", flush=True)
    out["chunk_ms"] = {
        **{f"f32 b=128 chunk {c}": device_ms(
            lambda c=c: scan_lab.query_minor_by_chunk(codes, t4, N, c), new4) for c in (32, 64, 128)},
        **{f"u8 b=32 chunk {c}": device_ms(
            lambda c=c: scan_lab.query_minor_by_chunk(codes, t8, N, c), new8) for c in (8, 16, 32)}}
    print(f"query-minor by chunk of queries, device ms: {out['chunk_ms']} [{card}]", flush=True)
    out["mode_ms"] = {
        mode: device_ms(lambda mode=mode, scan=scan: scan_lab.query_minor_lab(
            codes, t4 if scan == "f32" else t8, N, mode),
            {"f32": new4, "u8": new8, "u8_lookup": old8}[scan])
        for mode, (scan, _, _) in scan_lab.QM_LAB_MODES.items()}
    print(f"query-minor modes, device ms: {out['mode_ms']} [{card}]", flush=True)

    # Both kernels of each scan at every batch: the wrappers' thresholds forced.
    out["crossover_ms"] = {}
    floors = lut_scan.QUERY_MINOR_MIN_QUERIES, lut_scan.QUERY_MINOR_MIN_QUERIES8
    try:
        lut_scan.QUERY_MINOR_MIN_QUERIES = lut_scan.QUERY_MINOR_MIN_QUERIES8 = 1
        for q in (1, 2, 4, 8, 16, 20, 24, 32, 64, Q):
            part = t4[:q].contiguous()
            out["crossover_ms"][f"f32 b{q}"] = {
                "query_minor": device_ms(lambda: lut_scan.flat_scan(codes, part, N), new4),
                "lookup": device_ms(lambda: lut_scan.flat_scan_f32_lookup(codes, part, N), old4)}
        for q in (1, 2, 3, 4, 8, 16, 32):
            part = t8[:q].contiguous()
            out["crossover_ms"][f"u8 b{q}"] = {
                "query_minor": device_ms(lambda: lut_scan.flat_scan8(codes, part, N), new8),
                "lookup": device_ms(lambda: lut_scan.flat_scan8_lookup(codes, part, N), old8)}
    finally:
        lut_scan.QUERY_MINOR_MIN_QUERIES, lut_scan.QUERY_MINOR_MIN_QUERIES8 = floors
    print(f"query-minor and replaced kernels by batch, device ms: {out['crossover_ms']} (the "
          f"wrappers take query-minor from {floors[0]} / {floors[1]} queries) [{card}]", flush=True)

    gen = torch.Generator(device=dev).manual_seed(11)
    x = torch.rand((512, 128), generator=gen, device=dev) * 500
    sel = (torch.arange(128, device=dev)[:, None] // 8
           == torch.arange(16, device=dev)[None, :]).to(torch.float32)
    out["launch_floor_ms"] = [device_ms(lambda: scan_lab.empty_kernel(dev), "empty_kernel")
                              for _ in range(10)]
    out["selector_sum_ms"] = [device_ms(lambda: scan_lab.selector_sum(x, 8), "selector_sum_kernel")
                              for _ in range(10)]
    out["matmul_ms"] = [device_ms(lambda: torch.matmul(x, sel), "", whole_call=True)
                        for _ in range(10)]
    print(f"launch floor (empty kernel), ten runs, device ms: {out['launch_floor_ms']}; "
          f"selector_sum {out['selector_sum_ms']}; torch.matmul {out['matmul_ms']} [{card}]",
          flush=True)
    return out


def window_crossover(codes, dev, card: str) -> dict:
    """The window section: see the module docstring."""
    rng = np.random.default_rng(4)
    codes32 = torch.from_numpy(rng.integers(0, 256, (N_PAD // 8, 128), dtype=np.uint8)).to(dev)
    tables = {16: torch.from_numpy(rng.random((Q, 16, 16)).astype(np.float32)).to(dev),
              32: torch.from_numpy(rng.random((Q, 32, 16)).astype(np.float32)).to(dev)}
    out = {}
    floor = lut_scan.WINDOW_QUERY_MINOR_MIN_QUERIES
    try:
        lut_scan.WINDOW_QUERY_MINOR_MIN_QUERIES = 1
        for m, ix_codes, bn, w in ((16, codes, 1024, 16), (16, codes, 512, 8),
                                   (32, codes32, 1024, 16)):
            for q in (1, 2, 4, 8, 12, 16, 20, 24, 26, 28, 30, 32, 64, Q):
                args = (ix_codes, tables[m][:q].contiguous(), N, bn, w)
                got, want = (lut_scan.flat_scan_window(*args, with_rows=True),
                             lut_scan.flat_scan_window_f32_lookup(*args, with_rows=True))
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise AssertionError(f"{m}x4 ({bn}, {w}) b={q}: the query-minor window "
                                         "kernel differs from the lookup kernel")
                out[f"{m}x4 b{bn} w{w} b={q}"] = {
                    "query_minor": device_ms(lambda: lut_scan.flat_scan_window(*args),
                                             "flat_scan_window_qm_kernel"),
                    "lookup": device_ms(lambda: lut_scan.flat_scan_window_f32_lookup(*args),
                                        "flat_scan_window_kernel")}
    finally:
        lut_scan.WINDOW_QUERY_MINOR_MIN_QUERIES = floor
    print(f"float window scan by kernel and batch, device ms: {out} [{card}]", flush=True)
    return out


def grouped(dev, card: str) -> dict:
    """The grouped section: see the module docstring."""
    rng = np.random.default_rng(2)
    indexes = {4: ivf_index_from_arrays(*bench_ivf_arrays(rng), dev),
               8: ivf_index_from_arrays(*bench_ivf8_arrays(rng), dev)}
    gen = torch.Generator(device=dev).manual_seed(3)
    batches = {f"b={b}": torch.randn((b, 128), generator=gen, device=dev)
               for b in (1, 8, 32, 64, Q)}
    batches["hot"] = batches["b=1"] + 1e-3 * torch.randn((Q, 128), generator=gen, device=dev)
    kernels = {4: (lut_scan.grouped_scan, "grouped_scan_sm_kernel", lut_scan.grouped_scan_plain),
               8: (lut_scan.grouped_scan8, "grouped_scan8_sm_kernel", lut_scan.grouped_scan8_plain)}
    out = {"ms": {}, "live": {}, "mode_ms": {}}
    for bits, ix in indexes.items():
        scan, name, plain = kernels[bits]
        for tag, qs in batches.items():
            parts, rot = ivf.assign_queries(ix, qs, MA)
            t = ivf.adc_tables(rot, ix.pq.centroids).reshape(qs.shape[0] * MA, ix.pq.sq_count, -1)
            routed = route_queries(parts, ix.part_count, 128)
            args = (ix.codes, t if bits == 4 else t.to(torch.bfloat16), routed.group_part,
                    routed.slot_pairs(), ivf._group_sizes(ix, routed))
            got, want = scan(*args), plain(*args)
            same = (torch.equal(got, want) if bits == 4
                    else torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
            if not same:
                raise AssertionError(
                    f"{bits}-bit {tag}: the slot-minor kernel differs from the plain version")
            live = (args[3] >= 0).sum(1)
            out["live"][f"{bits}-bit {tag}"] = {"groups": int((live > 0).sum()),
                                                "mean": float(live[live > 0].float().mean()),
                                                "max": int(live.max())}
            out["ms"][f"{bits}-bit {tag}"] = device_ms(lambda: scan(*args), name)
            if tag in ("b=32", "hot"):
                for mode, (lab_scan, _, _) in scan_lab.GROUPED_LAB_MODES.items():
                    if (lab_scan == "f32") == (bits == 4):
                        out["mode_ms"][f"{mode} {tag}"] = device_ms(
                            lambda mode=mode: scan_lab.grouped_lab(*args, mode),
                            scan_lab.GROUPED_LAB_KERNELS[lab_scan], reps=30)
                if tag == "b=32":
                    out["ms"][f"{bits}-bit b=32 ten runs"] = [
                        device_ms(lambda: scan(*args), name) for _ in range(10)]
    print(f"grouped live slots: {out['live']}", flush=True)
    print(f"grouped slot-minor kernels, device ms: {out['ms']} [{card}]", flush=True)
    print(f"grouped lab modes, device ms: {out['mode_ms']} [{card}]", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    if sys.argv[1:] == ["grouped"]:  # the grouped section alone
        print(json.dumps({"scan_lab": {"grouped": grouped(dev, card)}, "card": card}))
        print(card)
        return 0
    rng = np.random.default_rng(0)
    codes = torch.from_numpy(rng.integers(0, 256, (N_PAD // 16, 128), dtype=np.uint8)).to(dev)
    if sys.argv[1:] == ["window"]:  # the window section alone
        print(json.dumps({"scan_lab": {"window": window_crossover(codes, dev, card)},
                          "card": card}))
        print(card)
        return 0
    tables = torch.from_numpy(rng.integers(0, 128, (Q, 16, 16)).astype(np.int8)).to(dev)

    print(f"modes: {json.dumps({k: v[2] for k, v in scan_lab.LAB_MODES.items()})}")
    out = scan_lab.run(codes, tables, N, device_ms)
    print(f"A/B b={Q} x {N_PAD} codes, device ms: {out['ab_ms']} [{card}]", flush=True)
    print(f"modes, device ms: {out['mode_ms']} [{card}]", flush=True)
    print(f"exactness (mismatches against the plain version): {out['exactness']}; "
          f"selector sum max rel err {out['selector_sum_max_rel_err']:.3g}", flush=True)
    bad = sum(sum(v.values()) for v in out["exactness"].values())
    if bad or out["selector_sum_max_rel_err"] >= 1e-6:
        print("the exactness probe failed", file=sys.stderr)
        return 1

    # The crossover of flat_scan's two int8 kernels: each forced at every batch.
    out["crossover_ms"] = {}
    floor = lut_scan.WGMMA_MIN_QUERIES
    try:
        for q in (8, 16, 32, 48, 64, 96, Q):
            part = tables[:q].contiguous()
            row = {}
            for name, forced in (("wgmma", 1), ("mma_sync", 1 << 30)):
                lut_scan.WGMMA_MIN_QUERIES = forced
                row[name] = device_ms(lambda: lut_scan.flat_scan(codes, part, N), "mma_kernel")
            out["crossover_ms"][f"b{q}"] = row
    finally:
        lut_scan.WGMMA_MIN_QUERIES = floor
    print(f"flat_scan by kernel and batch, device ms: {out['crossover_ms']} (the wrapper takes "
          f"wgmma from {floor} queries) [{card}]", flush=True)

    out["query_minor"] = query_minor(codes, dev, card)
    out["window"] = window_crossover(codes, dev, card)
    out["grouped"] = grouped(dev, card)

    arrays, manifest = bench_ivf_arrays(rng)
    index = ivf_index_from_arrays(arrays, manifest, dev)
    out["m1_ms"] = {}
    for b in (32, Q):
        queries = torch.from_numpy(rng.normal(size=(b, 128)).astype(np.float32)).to(dev)
        parts, _ = ivf.assign_queries(index, queries, MA)
        routed = route_queries(parts, index.part_count, 128)
        qt = torch.from_numpy(rng.integers(0, 128, (b * MA, 16, 16)).astype(np.int8)).to(dev)
        args = (index.codes, qt, routed.group_part, routed.slot_pairs(),
                ivf._group_sizes(index, routed))
        if not torch.equal(lut_scan.grouped_scan(*args), lut_scan.grouped_scan_plain(*args)):
            print(f"M1 b={b}: the mma kernel differs from the plain version", file=sys.stderr)
            return 1
        out["m1_ms"][f"b{b}"] = device_ms(lambda: lut_scan.grouped_scan(*args),
                                          "grouped_scan_mma_kernel")
    print(f"M1 routed groups, device ms: {out['m1_ms']} [{card}]", flush=True)
    print(json.dumps({"scan_lab": out, "card": card}))
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
