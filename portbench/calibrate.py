"""Readings that set the limits of a cell's check: the program's numbers over
many seeds, the control's (the reference in TF32 in the program's place)
and each planted fault's, all in one process, each run as the benchmark
runs it but with a short window.

    python3 portbench/calibrate.py --workload <cell> --seeds 11,12,13 \\
        --control-seeds 21,22,23 --faults half_batch:31,32,33 --seconds 3

Prints one JSON line a reading (and appends it to ``--out``). Runs on the
card only; the benchmark's own runs never call it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="", help="name:seed,seed;name:seed")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve().parent
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench import faults, harness, spec
    from portbench.reference import ops

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    ops.full_float32()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    cell = spec.load_cell(spec.load_benchmark(ROOT), args.workload)
    table = faults.TRAIN if cell.kind == "train" else faults.SERVE
    jobs = [("program", int(s), None, False) for s in args.seeds.split(",") if s]
    jobs += [("control", int(s), None, True) for s in args.control_seeds.split(",") if s]
    for part in filter(None, args.faults.split(";")):
        name, seeds = part.split(":")
        jobs += [(f"fault:{name}", int(s), table[name], False) for s in seeds.split(",")]
    for kind, seed, fault, control in jobs:
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats(device)
        run = harness.Run(cell, seed, args.seconds, False, device, lambda: 0.0, fault=fault,
                          control=control)
        numbers = run.numbers()
        line = {"workload": cell.name, "kind": kind, "seed": seed, "numbers": numbers,
                "failed": run.failed, "attempted": run.attempted,
                "measured": {k: v for k, v in run.measured.items() if k != "setup_s"},
                "seconds": time.perf_counter() - t0,
                "peak_gb": torch.cuda.max_memory_allocated(device) / 1e9}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
