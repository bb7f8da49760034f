"""Run one cell of the port's benchmark on one card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell, its configuration and its
metrics come from ``BENCHMARK.json`` and the files under ``portbench/``
(``spec.py``). With ``--trace 0`` the result's metrics are the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones. The last line of
standard output is one JSON object; the last lines of standard error are
the numbers that decided ``correct``, each beside its limit. Without a card,
or with fewer cards than the cell asks for, the run prints no result and
exits with 2; a run in whose process ``jax``, ``jaxlib``, ``flax`` or
``mpa_tpu`` was imported exits with 3.

``--control 1`` puts the reference computed in TF32 in the program's place
(no window): the check has to fail it, as it has to fail each fault of
``faults.py`` (``calibrate.py --faults``). A measured run uses neither.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "mpa_tpu")


def process_seconds() -> float:
    """Seconds since this process started (its start time in ``/proc``), or
    since this file began to run where ``/proc`` has none."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one that no run may load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs(root: Path) -> None:
    """Keep every compiler cache at a fixed path inside the checkout (the
    program's kernel library builds into its own ``kernels/_build/``)."""
    cache = root / ".portbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
        os.environ[var] = str(cache / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them: the
    utilisations and rates of a run hold at that limit."""
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"card: power limit not read ({e})"
    return "card: " + (out.stdout.strip().splitlines() or ["power limit not read"])[0]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def result_line(run, cell, correct: bool, table: dict, trace: bool) -> dict:
    from portbench import harness

    if trace:
        metrics = harness.per_layer(cell, run.record)
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        missing = [n for n in units if n not in run.measured]
        if missing and not run.control:  # the control runs no window
            raise KeyError(f"cell {cell.name} measures no {missing}")
        metrics = {n: {"value": run.measured[n], "unit": u} for n, u in units.items()
                   if n in run.measured}
    line = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
            "metrics": metrics,
            "device": harness.device_block(run.device, run.memory_peak, run.record)}
    if trace and run.record:
        from portbench import tracing

        line["breakdown"] = tracing.breakdown(run.record["trace"])
    line["checks"] = table
    return line


def main(argv=None, *, root: Path = ROOT, device=None, fault=None) -> int:
    """Run a cell of the checkout at ``root``; ``device`` (a test's CPU
    device) skips the look for a card, ``fault`` plants a fault object
    directly."""
    args = parse(argv)
    set_cache_dirs(ROOT)
    here = Path(__file__).resolve().parent  # as the script's directory, it would shadow names
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != here]
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from portbench import check, harness, spec

    bench = spec.load_benchmark(root)
    cell = spec.load_cell(bench, args.workload, root / "portbench")
    if device is None:
        chips = cell.entry.get("chips", 1)
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: {args.workload} needs {chips} CUDA card(s); this machine has "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        from portbench.reference import ops

        ops.full_float32()
    run = harness.Run(cell, args.seed, args.seconds, bool(args.trace) and device.type == "cuda",
                      device, process_seconds, fault=fault, control=bool(args.control))
    numbers = run.numbers()
    correct, table = check.judge(numbers, cell.params["limits"])
    correct = correct and run.failed == 0
    line = result_line(run, cell, correct, table, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for name, t in table.items():
        print(f"check {name} {t['value']!r} limit {t['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    if device.type == "cuda":
        print(card_line())
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
