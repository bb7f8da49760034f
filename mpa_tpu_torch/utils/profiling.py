"""Profiling hooks: device traces, parameter counts and FLOP estimates
(counterpart of ``mpa_tpu/utils/profiling.py``).

:func:`profile_trace` records ``torch.profiler`` (CPU and, where a card is
present, CUDA activity) into a directory TensorBoard's profiler plugin
reads; :func:`estimate_flops` counts the FLOPs of one call with
``torch.utils.flop_counter.FlopCounterMode``, which counts the PyTorch
operators it knows (matmuls, convolutions) and not the port's own kernels
or elementwise work, as XLA's cost analysis in ``mpa_tpu`` counts what
XLA compiles. ``mpa_tpu``'s xplane parsing has no counterpart: the
profiler's ``key_averages()`` gives the breakdown by kernel
(``profile_port.py``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator

import torch
from torch import nn


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
