"""The program's own spans and counters (``mpa_tpu_torch/utils/profiling.py``)
as the benchmark reads them.

Two readings. The program's counters count over the whole run, whatever its
spans do, and are read once the run has ended: :func:`host_syncs` (the
points a serve call blocks the host on the device, a call) and
:func:`input_empty_share` (the share of the input pipeline's waits that
found its queue empty) are the metrics ``host_syncs.serve`` and
``input_empty_share.train``. A program without those counters gives None.

The program's spans need them on, which the measured window and the
benchmark's profiled pass leave off. So

    python3 portbench/program_trace.py --workload <cell> --seed <n> --seconds <s>

runs the cell as ``run.py --trace 1`` does and then a second profiled pass
of the same units with the spans on (:func:`program_pass`). Its last line of
standard output is the run's result line with a ``program`` object: the
readings of the spans (:data:`SPAN_READERS`), the idle gaps of the second
pass labelled by the program span open at their middle and the device
milliseconds of the operations each model block launched
(:func:`program_breakdown`), the benchmark's ``dispatch`` host
milliseconds and the wall milliseconds a unit in both passes (the spans'
cost), the share of the second pass's ``dispatch`` time the program's
entry spans cover, and, in a served cell, the host syncs that
``torch.cuda.set_sync_debug_mode`` flags in one call beside those the
counter counts. It also writes the line to
``chiprun_out/program_trace/<cell>-<seed>.json``. Needs a card.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
import warnings
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[1]
MAIN = "MainThread"  # the thread the harness runs its units on
# The spans under the benchmark's ``dispatch``: a train step's and a serve call's.
ENTRY_SPANS = {"train": ("train.augment", "train.step"),
               "serve": ("serve.inputs", "serve.forward")}
ALLOCATOR = ("num_device_alloc", "num_device_free")
SPAN_PREFIXES = ("train.", "serve.", "pipeline.", "block.")


# -- the program's counters ------------------------------------------------

def counts() -> Optional[Dict[str, int]]:
    """A copy of the program's counters, or None where it has none."""
    from mpa_tpu_torch.utils import profiling

    found = getattr(profiling, "COUNTS", None)
    return dict(found) if found is not None else None


def host_syncs(record: dict, found: Optional[Dict[str, int]] = None) -> Optional[float]:
    """Host syncs a serve call: every ``host_syncs.<site>`` over the run's
    serve calls (``found``: the counters, else the program's own)."""
    found = counts() if found is None else found
    if not found or not found.get("serve_calls"):
        return None
    from mpa_tpu_torch.utils.profiling import host_syncs as syncs

    return syncs(found) / found["serve_calls"]


def input_empty_share(record: dict, found: Optional[Dict[str, int]] = None) -> Optional[float]:
    """The input pipeline's waits that found its queue empty, in percent of
    its waits over the run."""
    found = counts() if found is None else found
    if not found or not found.get("input_waits"):
        return None
    return 100.0 * found["input_empty"] / found["input_waits"]


# -- the program-span pass -------------------------------------------------

def _allocator() -> Dict[str, int]:
    import torch

    stats = torch.cuda.memory_stats()
    return {k: int(stats.get(k, 0)) for k in ALLOCATOR}


def _profile(run_units: Callable) -> dict:
    """``tracing.profile``'s trace of ``run_units(spans)``, with ``launched``:
    each device operation's ``(launch s, start s, end s)``, its launch the
    host call that kineto correlates with it."""
    import torch

    from portbench import tracing

    spans = tracing.Spans()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        start = time.time_ns() * 1e-9
        run_units(spans)
        torch.cuda.synchronize()
        end = time.time_ns() * 1e-9
    host, device = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                device.append(e)
        elif e.correlation_id():
            host[e.correlation_id()] = e.start_ns() * 1e-9
    ops = [(e.name(), e.start_ns() * 1e-9, e.end_ns() * 1e-9) for e in device]
    launched = [(host[e.correlation_id()], a, b) for e, (_, a, b) in zip(device, ops)
                if e.correlation_id() in host]
    return {"device_ops": ops, "launched": launched, "host_spans": spans.items,
            "start": start, "end": end}


def program_pass(run_units: Callable, units: int) -> dict:
    """Profile ``run_units`` again with the program's spans on: the record's
    ``program_trace``, ``program_spans`` (``(name, parent, unit, thread,
    start s, end s)`` on the trace's clock) and ``program_counts`` (a unit's
    share of the change in the program's counters and in the caching
    allocator's cudaMalloc and cudaFree calls)."""
    from mpa_tpu_torch.utils import profiling

    before = {**profiling.COUNTS, **_allocator()}
    profiling.spans = []
    try:
        trace = _profile(run_units)
        kept = profiling.spans
    finally:
        profiling.spans = None
    after = {**profiling.COUNTS, **_allocator()}
    return {"program_trace": trace,
            "program_spans": [(n, p, u, t, a * 1e-9, b * 1e-9) for n, p, u, t, a, b in kept],
            "program_counts": {k: (after[k] - before[k]) / units for k in after}}


def _innermost(spans: List[tuple], at: float) -> Optional[str]:
    """The name of the latest-started of ``spans`` open at ``at``."""
    open_ = [(s[4], s[0]) for s in spans if s[4] <= at <= s[5]]
    return max(open_)[1] if open_ else None


def program_breakdown(record: dict, top: int = 10) -> Optional[dict]:
    """The second pass's longest idle gaps, each labelled by the innermost
    program span open on the harness's thread at its middle, else by the
    benchmark's span; and the device milliseconds a unit of the operations
    each ``block.*`` span launched."""
    from portbench import roofline

    trace = record.get("program_trace")
    if trace is None:
        return None
    main = [s for s in record["program_spans"] if s[3] == MAIN]
    gaps = roofline.idle_gaps([(a, b) for _, a, b in trace["device_ops"]], trace["start"],
                              trace["end"])
    labelled = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        label = _innermost(main, mid)
        if label is None:
            bench = [n for n, s, e in trace["host_spans"] if s <= mid <= e]
            label = bench[-1] if bench else "between_spans"
        labelled.append((label, b - a))
    labelled.sort(key=lambda kv: -kv[1])
    blocks = sorted((s[4], s[5], s[0]) for s in main if s[0].startswith("block."))
    starts = [b[0] for b in blocks]
    device: Dict[str, float] = {}
    for at, a, b in trace["launched"]:
        i = bisect.bisect_right(starts, at) - 1
        if i >= 0 and at <= blocks[i][1]:
            name = blocks[i][2]
            device[name] = device.get(name, 0.0) + 1e3 * (b - a) / record["units"]
    return {"program_idle_gaps": [[n, s] for n, s in labelled[:top]],
            "block_device_ms": dict(sorted(device.items(), key=lambda kv: -kv[1]))}


def span_ms(record: dict, name: str) -> Optional[float]:
    """Host milliseconds a unit of the program's ``name`` spans in the
    second pass; None without them."""
    times = [s[5] - s[4] for s in record.get("program_spans", ()) if s[0] == name]
    return 1e3 * sum(times) / record["units"] if times else None


def allocator_calls(record: dict) -> Optional[float]:
    """The caching allocator's cudaMalloc and cudaFree calls a unit in the
    second pass."""
    c = record.get("program_counts")
    return sum(c[k] for k in ALLOCATOR) if c else None


SPAN_READERS = {
    "train": {"forward_ms.train": lambda r: span_ms(r, "train.forward"),
              "backward_ms.train": lambda r: span_ms(r, "train.backward"),
              "optimizer_ms.train": lambda r: span_ms(r, "train.optimizer"),
              "allocator_calls.train": allocator_calls},
    "serve": {"inputs_ms.serve": lambda r: span_ms(r, "serve.inputs"),
              "forward_ms.serve": lambda r: span_ms(r, "serve.forward"),
              "allocator_calls.serve": allocator_calls},
}


def dispatch_ms(trace: dict) -> Optional[float]:
    """Mean host milliseconds of the benchmark's ``dispatch`` spans of a
    profiled pass."""
    times = [b - a for n, a, b in trace["host_spans"] if n == "dispatch"]
    return 1e3 * sum(times) / len(times) if times else None


def dispatch_covered(record: dict) -> Optional[float]:
    """The share, in percent, of the second pass's ``dispatch`` host time
    that the program's entry spans (``ENTRY_SPANS``) cover."""
    names = ENTRY_SPANS[record["kind"]]
    dispatch = [(a, b) for n, a, b in record["program_trace"]["host_spans"] if n == "dispatch"]
    total = sum(b - a for a, b in dispatch)
    if not total:
        return None
    covered = 0.0
    for s in record["program_spans"]:
        if s[0] in names and s[3] == MAIN:
            covered += sum(max(0.0, min(b, s[5]) - max(a, s[4])) for a, b in dispatch)
    return 100.0 * covered / total


def program_block(record: dict) -> dict:
    """The ``program`` object of :func:`main`'s line."""
    readings = {n: read(record) for n, read in SPAN_READERS[record["kind"]].items()}
    first, second = dispatch_ms(record["trace"]), dispatch_ms(record["program_trace"])
    passes = (record["trace"], record["program_trace"])
    named = [n for n, _, _ in record["program_trace"]["device_ops"]
             if n.startswith(SPAN_PREFIXES)]
    return {"metrics": readings, **(program_breakdown(record) or {}),
            "dispatch_ms": [first, second],
            "spans_on_cost_pct": 100.0 * (second - first) / first if first and second else None,
            "unit_ms": [1e3 * (t["end"] - t["start"]) / record["units"] for t in passes],
            "spans_a_unit": len(record["program_spans"]) / record["units"],
            "span_ms": {n: span_ms(record, n) for n in sorted({s[0] for s in
                                                               record["program_spans"]})},
            "dispatch_covered_pct": dispatch_covered(record),
            "span_named_device_ops": len(named)}


# -- the command -----------------------------------------------------------

def sync_check(cell, seed: int, device) -> dict:
    """One serve call of the cell's program at its size, with
    ``torch.cuda.set_sync_debug_mode("warn")``: the syncs it flags and those
    the program's counter counts."""
    import torch

    from portbench import harness, weights

    mod = cell.config()
    call, _ = mod.serve_program(cell.sizes, weights.derive(seed, "serve"), device)
    request = harness._traffic(cell, cell.params["batch"], seed, "sync")
    for _ in range(2):
        call(request)
    torch.cuda.synchronize()
    before = counts()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            call(request)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    after = counts()
    flagged = [str(w.message).splitlines()[0] for w in caught
               if "synchroniz" in str(w.message)]
    counted = {k: after[k] - before[k] for k in after
               if k.startswith("host_syncs.") and after[k] != before[k]}
    return {"flagged": len(flagged), "counted": sum(counted.values()), "sites": counted,
            "messages": sorted(set(flagged))}


def main(argv=None) -> int:
    from portbench import run

    args = run.parse(argv)
    run.set_cache_dirs(ROOT)
    import torch

    from portbench import check, harness, spec

    if not torch.cuda.is_available():
        print("program_trace: needs a CUDA card", file=sys.stderr)
        return 2

    class ProgramRun(harness.Run):
        def _traced(self, units, one_unit, ops_per_unit):
            super()._traced(units, one_unit, ops_per_unit)
            self.record.update(program_pass(units, self.record["units"]))

    bench = spec.load_benchmark(ROOT)
    cell = spec.load_cell(bench, args.workload, ROOT / "portbench")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    from portbench.reference import ops

    ops.full_float32()
    r = ProgramRun(cell, args.seed, args.seconds, True, device, run.process_seconds)
    correct, table = check.judge(r.numbers(), cell.params["limits"])
    line = run.result_line(r, cell, correct and r.failed == 0, table, True)
    line["program"] = program_block(r.record)
    if cell.kind == "serve":
        line["program"]["sync_check"] = sync_check(cell, args.seed, device)
    print(run.card_line())
    out = ROOT / "chiprun_out" / "program_trace" / f"{args.workload}-{args.seed}.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(line, indent=1))
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    here = str(Path(__file__).resolve().parent)  # as the script's directory, it shadows names
    sys.path[:] = [p for p in sys.path if str(Path(p or ".").resolve()) != here]
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
