"""The benchmark of qadc_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is the result (JSON): `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
--trace 1 its per-layer ones), `device`, and with --trace 1 `breakdown`.
Each number compared with its limit closes standard error. The run exits
non-zero, and prints no result, without enough CUDA cards, when a JAX
module is loaded at the end, or when the program cannot be imported.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None, root: Path = ROOT, device=None) -> int:
    """One run. root: the benchmark's root; device: None for the first CUDA
    card, which the run requires (the harness's own tests pass the CPU)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    cell = harness.find_cell(args.workload, root)
    if device is None:
        chips = cell.workload.get("chips", 1)
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if found < chips:
            print(f"portbench: needs {chips} CUDA card(s), found {found}", file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    # One thread: the loop is bound by the host's dispatch, and a pool of
    # CPU threads would only contend for the cores that other processes on
    # the host share.
    torch.set_num_threads(1)
    result, shown = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                                     T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: JAX modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, v in shown.items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
