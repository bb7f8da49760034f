"""The benchmark's host spans and its read of the device trace.

Host spans are taken by the benchmark around its own calls into the program
(``dispatch``, ``input_wait``, ``answer_copy``, ``loss_read``), on the
wall clock in nanoseconds: ``torch.profiler``'s trace (kineto) stamps its
events on the same clock, so a gap in the device's work can be laid beside
what the host was doing then. The profiler records device activity only
(kernels, copies and fills), which keeps its cost on the host small; no
trace is written to disk.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Callable, Iterator, List, Tuple

import torch

from portbench import roofline

Interval = Tuple[str, float, float]  # (name, start s, end s) on the wall clock


class Spans:
    """Named host intervals, kept in memory."""

    def __init__(self):
        self.items: List[Interval] = []

    @contextlib.contextmanager
    def __call__(self, name: str) -> Iterator[None]:
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.items.append((name, t0 * 1e-9, time.time_ns() * 1e-9))


def profile(run_units: Callable[[Spans], None]) -> dict:
    """Run ``run_units(spans)`` under the profiler (device activity) and
    return ``{"device_ops": [(name, start, end)], "host_spans": [...],
    "start": s, "end": s}``; the span ends once the device is idle."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    spans = Spans()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        start = time.time_ns() * 1e-9
        run_units(spans)
        torch.cuda.synchronize()
        end = time.time_ns() * 1e-9
    origin = prof.profiler.kineto_results.trace_start_ns() * 1e-9
    ops = []
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA or getattr(e, "is_user_annotation",
                                                                      False):
            continue
        ops.append((e.name, origin + e.time_range.start * 1e-6, origin + e.time_range.end * 1e-6))
    return {"device_ops": ops, "host_spans": spans.items, "start": start, "end": end}


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took the most time, by name, and the
    longest idle gaps, each labelled by the host span open at its middle."""
    by_name = defaultdict(float)
    for name, a, b in trace["device_ops"]:
        by_name[name] += b - a
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = roofline.idle_gaps([(a, b) for _, a, b in trace["device_ops"]], trace["start"],
                              trace["end"])
    labelled = []
    for a, b in gaps:
        mid = 0.5 * (a + b)
        open_spans = [n for n, s, e in trace["host_spans"] if s <= mid <= e]
        labelled.append((open_spans[-1] if open_spans else "between_spans", b - a))
    labelled.sort(key=lambda kv: -kv[1])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": [[n, s] for n, s in
                                                                  labelled[:top]]}
