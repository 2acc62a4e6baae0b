"""Readings for setting the limits of `correct`.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 --seconds 2 \
        [--control] [--faults rotation_identity ... --fault-seeds 21 22 23]

For each of --seeds, one run of the cell as the benchmark makes it (a short
window at the cell's own load) and the numbers of its sampled answers as
the program returned them; with --control, the same answers judged again
with the reference computed one precision lower put in the program's place
(check.searched): for a Quick ADC configuration TF32 products and int4
tables, for an 8-bit conventional ADC one (`adc_type` "adc") TF32 products
and the rerank summed from the bfloat16 tables the screen sums. For each
fault of --faults (faults.py) and each of --fault-seeds, one run with that
fault planted in the program's training. One JSON line a run. Not part of
a benchmark run. The cell is found in the repository's own BENCHMARK.json.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)

    import torch

    from portbench import check, faults, harness

    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    runs = [(None, s) for s in args.seeds] + [(f, s) for f in args.faults
                                              for s in args.fault_seeds]
    for fault, seed in runs:
        cell = harness.find_cell(args.workload, ROOT)
        keep = {}
        with faults.planted(fault) if fault else contextlib.nullcontext():
            _, shown = harness.run_cell(cell, seed, args.seconds, False, device,
                                        time.perf_counter(), keep=keep)
        line = {"workload": args.workload, "seed": seed, "fault": fault,
                "program": {k: v["value"] for k, v in shown.items()}}
        if args.control and fault is None:
            line["control"] = check.judge(keep["dep"], keep["got"], control=True)
        print(json.dumps(line), flush=True)
        del keep
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
