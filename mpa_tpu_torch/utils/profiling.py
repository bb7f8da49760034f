"""Profiling hooks: device traces, parameter counts and FLOP estimates
(counterpart of ``mpa_tpu/utils/profiling.py``).

:func:`profile_trace` records ``torch.profiler`` (CPU and, where a card is
present, CUDA activity) into a directory TensorBoard's profiler plugin
reads; :func:`estimate_flops` counts the FLOPs of one call with
``torch.utils.flop_counter.FlopCounterMode``, which counts the PyTorch
operators it knows (matmuls, convolutions) and not the port's own kernels
or elementwise work, as XLA's cost analysis in ``mpa_tpu`` counts what
XLA compiles. :func:`op_breakdown` and :func:`category_breakdown` read the
device time of a finished ``torch.profiler`` profile by kernel and by
category (:func:`kernel_category`: the port's kernels one by one, cuBLAS's
matrix products, everything else), as ``mpa_tpu``'s read an XSpace by XLA
op and HLO category. ``mpa_tpu``'s ``load_xspace`` has no counterpart:
the profile is read in the process that took it, with no trace file.

The program's own spans and counters live here too. :func:`span` marks a
layer boundary of the program (the serve and train entries, the input
pipeline, each model block; ``PERF.md`` lists the names). While
``spans`` is None, the default, a span costs one read of that global;
while it is a list, each span appends ``(name, parent, unit, thread,
start_ns, end_ns)`` to it on ``time.time_ns()``'s clock, the one a
``torch.profiler`` trace's events map onto through ``trace_start_ns()``,
and enters a ``RecordFunction`` of the name (the profiler's
``_RecordFunctionFast``, about 2 us; ``torch.profiler.record_function``
costs 15-17 us a span on the card's host), so a profile shows the same
names. ``COUNTS`` counts, whatever ``spans`` is, the points where
the program blocks the host on the device (``host_syncs.<site>``), the
serve calls, the input pipeline's waits and how many found its queue
empty, the train-mode BatchNorms that took the fused kernels
(``batch_norm_act.fused``, ``ops/batch_norm.py``), and each neighbour
search where it is dispatched: ``knn.windowed`` in
``ops/window.py::windowed_knn_with_spec``, ``knn.exact`` in
``ops/knn.py::knn`` (a window mode's scale pair that admits no window
searches exactly, and counts there).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
from torch import nn

# None: no span is kept. A list: each span appends
# ``(name, parent, unit, thread, start_ns, end_ns)`` to it.
spans: Optional[list] = None

# The sites where the program blocks the host on the device, each counted
# under ``host_syncs.<site>`` (:func:`host_syncs` sums them).
SYNC_SITES = ("serve.input_copy", "serve.category_read", "window.check")
COUNTS: Dict[str, int] = {**{f"host_syncs.{s}": 0 for s in SYNC_SITES},
                          "serve_calls": 0, "input_waits": 0, "input_empty": 0,
                          "batch_norm_act.fused": 0, "knn.windowed": 0, "knn.exact": 0}

_OFF = contextlib.nullcontext()
_open = threading.local()  # each thread's stack of open spans, as (name, unit)


def reset_counts() -> None:
    for name in COUNTS:
        COUNTS[name] = 0


def host_sync(site: str) -> None:
    """Count one point where the program blocks the host on the device."""
    COUNTS["host_syncs." + site] += 1


def host_syncs(counts: Dict[str, int]) -> int:
    """The host syncs of ``counts`` (a copy of ``COUNTS``), over every site."""
    return sum(n for name, n in counts.items() if name.startswith("host_syncs."))


class _Span:
    __slots__ = ("out", "name", "unit", "parent", "start", "rf")

    def __init__(self, out: list, name: str, unit):
        self.out, self.name, self.unit = out, name, unit

    def __enter__(self) -> None:
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        self.parent = stack[-1][0] if stack else None
        if self.unit is None and stack:
            self.unit = stack[-1][1]
        stack.append((self.name, self.unit))
        self.rf = torch._C._profiler._RecordFunctionFast(self.name)
        self.rf.__enter__()
        self.start = time.time_ns()

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        self.rf.__exit__(*exc)
        _open.stack.pop()
        self.out.append((self.name, self.parent, self.unit, threading.current_thread().name,
                         self.start, end))


def span(name: str, unit=None):
    """A context that marks the program's layer ``name``; ``unit`` identifies
    the step, request or batch (a span without one takes its parent's). A
    no-op while ``spans`` is None, and under ``torch.compile`` or
    ``torch.export``, whose graphs take no profiler op."""
    if spans is None or torch.compiler.is_compiling():
        return _OFF
    return _Span(spans, name, unit)


@contextlib.contextmanager
def profile_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Trace the block into ``log_dir`` (a TensorBoard trace file); yields
    the profiler, whose ``key_averages()`` the caller may read."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def count_params(module: nn.Module) -> int:
    """The number of parameter entries (the BatchNorm statistics are
    buffers, as they are ``batch_stats`` in ``mpa_tpu``)."""
    return sum(p.numel() for p in module.parameters())


def estimate_flops(fn: Callable, *args, **kwargs) -> float:
    """The FLOPs ``FlopCounterMode`` counts in one call ``fn(*args,
    **kwargs)``."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


# The port's kernels by launch name; the windowed ones first, since
# "knn_kernel" and "scatter_mean_kernel" are parts of their names.
PORT_KERNELS = ("windowed_knn_kernel", "windowed_attention_fwd_kernel",
                "windowed_attention_bwd_kernel", "windowed_scatter_mean_kernel",
                "knn_kernel", "fps_kernel", "gather_rows_kernel",
                "transition_attention_fwd_kernel", "scatter_add_rows_kernel",
                "transition_attention_bwd_kernel", "scatter_mean_kernel", "ball_query_kernel")
MATMUL = "matmul (cuBLAS)"
OTHER = "other PyTorch kernels"


def kernel_category(name: str) -> str:
    """The category of a device kernel named ``name``: the port kernel it
    belongs to (``fps_slice_kernel``, the sliced form, is ``fps_kernel``),
    ``MATMUL`` for cuBLAS's and CUTLASS's products, else ``OTHER``."""
    if "fps_slice_kernel" in name:
        return "fps_kernel"
    for k in PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "gemm" in low or "sgemm" in low or "cutlass" in low or "xmma" in low:
        return MATMUL
    return OTHER


def device_events(prof: torch.profiler.profile) -> list:
    """The device kernels of a finished profile: its CUDA events less the
    spans that annotate a region (an optimizer's step), which overlap the
    kernels inside them."""
    return [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def op_breakdown(prof: torch.profiler.profile) -> Tuple[float, List[dict]]:
    """Device time by kernel name of a finished profile: ``(total_ms,
    rows)``, rows ``{"name", "category", "ms", "count", "source"}`` sorted by
    time, largest first (``category`` by :func:`kernel_category`;
    ``source`` the ``.cu`` file of a port kernel, else empty). ``ms`` sums
    every launch in the profile: divide by the steps for a step's share."""
    from mpa_tpu_torch.kernels import SOURCES

    rows: dict = {}
    total = 0.0
    for e in device_events(prof):
        ms = (e.time_range.end - e.time_range.start) / 1e3  # us -> ms
        cat = kernel_category(e.name)
        row = rows.setdefault(e.name, {"name": e.name, "category": cat, "ms": 0.0, "count": 0,
                                       "source": SOURCES.get(cat, "")})
        row["ms"] += ms
        row["count"] += 1
        total += ms
    return total, sorted(rows.values(), key=lambda r: -r["ms"])


def category_breakdown(prof: torch.profiler.profile) -> Tuple[float, List[dict]]:
    """:func:`op_breakdown` summed by category: ``(total_ms, rows)``, rows
    ``{"category", "ms", "count"}`` sorted by time, largest first."""
    total, rows = op_breakdown(prof)
    cats: dict = {}
    for r in rows:
        c = cats.setdefault(r["category"], {"category": r["category"], "ms": 0.0, "count": 0})
        c["ms"] += r["ms"]
        c["count"] += r["count"]
    return total, sorted(cats.values(), key=lambda r: -r["ms"])
