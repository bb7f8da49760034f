"""What the per-layer metrics read from a traced run's record.

The record (``harness.Run._traced``): ``kind`` (``train`` or ``serve``),
``units`` (the profiled units), ``trace`` (``device_ops`` as ``(name,
start, end)`` seconds on the wall clock, the profiled span's ``start`` and
``end``, its ``host_spans``), ``window_spans`` (the benchmark's host spans
over the measured window), ``least_s_per_unit`` (the least time of one
unit's kernel launches, ``roofline.bound``), ``ops_per_unit`` (the
configuration's count) and ``peak_flops``. Each reader returns None where
it finds nothing to read. A metric's file under ``metrics/`` names its
reader here; the cells that report it are listed in ``BENCHMARK.json``.
"""

from __future__ import annotations

from typing import Optional

from portbench import roofline


def device_ms_per_unit(record: dict, select) -> Optional[float]:
    """Device milliseconds a unit of the kernels whose name ``select``
    accepts; None when the trace has none."""
    times = [b - a for n, a, b in record["trace"]["device_ops"] if select(n)]
    return 1e3 * sum(times) / record["units"] if times else None


def is_glue(name: str) -> bool:
    return not roofline.is_copy(name) and roofline.kernel_category(name) == roofline.OTHER


def is_port(name: str) -> bool:
    return roofline.kernel_category(name) in roofline.PORT_KERNELS


def span_ms(record: dict, name: str) -> Optional[float]:
    """Mean milliseconds of the benchmark's ``name`` host spans over the
    measured window."""
    times = [b - a for n, a, b in record["window_spans"] if n == name]
    return 1e3 * sum(times) / len(times) if times else None


def dispatch_ms(record: dict) -> Optional[float]:
    return span_ms(record, "dispatch")


def input_wait_ms(record: dict) -> Optional[float]:
    return span_ms(record, "input_wait")


def glue_ms(record: dict) -> Optional[float]:
    return device_ms_per_unit(record, is_glue)


def kernel_ms(record: dict) -> Optional[float]:
    return device_ms_per_unit(record, is_port)


def kernel_roofline(record: dict) -> Optional[float]:
    """The least time of a unit's port kernel launches over their device
    time, in percent."""
    ms = device_ms_per_unit(record, is_port)
    if not ms or not record["least_s_per_unit"]:
        return None
    return 100.0 * record["least_s_per_unit"] * 1e3 / ms


def idle_share(record: dict) -> Optional[float]:
    t = record["trace"]
    if not t["device_ops"]:
        return None
    busy = roofline.busy_seconds((a, b) for _, a, b in t["device_ops"])
    return 100.0 * (1.0 - busy / (t["end"] - t["start"]))


def mfu(record: dict) -> Optional[float]:
    t = record["trace"]
    if not t["device_ops"]:
        return None
    seconds = t["end"] - t["start"]
    return 100.0 * record["ops_per_unit"] * record["units"] / (seconds * record["peak_flops"])
