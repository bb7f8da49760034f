"""The yardstick's arithmetic: the chip's peaks, the least work of each of the
program's kernel launches, the union of device intervals, and the category
of a device kernel by its name.

:func:`bound` is a copy of ``chip_smoke.py::bound`` (as repaired there: a
gather counts each named row once), with a ball-query count of its own;
:func:`busy_seconds` the interval union of ``chip_smoke.py::busy_share``;
:func:`kernel_category` a copy of
``mpa_tpu_torch/utils/profiling.py::kernel_category``.
``tests/test_portbench_counts.py`` holds each copy to its original.
"""

from __future__ import annotations

from typing import Iterable, Tuple

import numpy as np
import torch

from portbench.reference.ops import square_distance

# NVIDIA H100 SXM (NVIDIA's data sheet, dense rates, at the 700 W limit):
# float32 outside the tensor cores (the program keeps TF32 off) and HBM3.
PEAK_FLOPS = 67e12
PEAK_BYTES = 3.35e12

# The program's kernels by launch name; the windowed ones first, since
# "knn_kernel" and "scatter_mean_kernel" are parts of their names.
PORT_KERNELS = ("windowed_knn_kernel", "windowed_attention_fwd_kernel",
                "windowed_attention_bwd_kernel", "windowed_scatter_mean_kernel",
                "knn_kernel", "fps_kernel", "gather_rows_kernel",
                "transition_attention_fwd_kernel", "scatter_add_rows_kernel",
                "transition_attention_bwd_kernel", "scatter_mean_kernel", "ball_query_kernel")
MATMUL = "matmul (cuBLAS)"
OTHER = "other PyTorch kernels"


def kernel_category(name: str) -> str:
    """The port kernel a device kernel named ``name`` belongs to
    (``fps_slice_kernel`` is ``fps_kernel``), ``MATMUL`` for cuBLAS's and
    CUTLASS's products, else ``OTHER``."""
    if "fps_slice_kernel" in name:
        return "fps_kernel"
    for k in PORT_KERNELS:
        if k in name:
            return k
    low = name.lower()
    if "gemm" in low or "sgemm" in low or "cutlass" in low or "xmma" in low:
        return MATMUL
    return OTHER


def is_copy(name: str) -> bool:
    """A copy or fill of device memory, not a kernel of the model."""
    return name.startswith(("Memcpy", "Memset"))


def knn_ops(B: int, N: int, S: int, C: int) -> int:
    """A kNN of ``S`` queries among ``N`` rows of ``C`` channels: each
    distance ``2C + 3``, and the norms."""
    return B * S * N * (2 * C + 3) + 2 * B * (S + N) * C


def attention_ops(B: int, S: int, Wo: int, K: int, shift: bool) -> int:
    """A transition attention's forward over ``Wo`` output channels."""
    return B * S * Wo * K * (6 if shift else 5)


def ball_query_tests(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> int:
    """Distance tests a ball query makes: each centre tests points in index
    order until its ``nsample``-th hit, or every point where it has fewer
    (a hit: the expanded squared distance within ``radius ** 2`` rounded
    once to float32)."""
    d = square_distance(new_xyz, xyz)
    r2 = float(np.float32(float(radius) * float(radius)))
    hits = torch.cumsum((d <= r2).to(torch.int64), dim=-1)  # [B, S, N]
    N = xyz.shape[1]
    reached = hits >= nsample
    first = torch.where(reached.any(-1), reached.float().argmax(-1) + 1, torch.full_like(
        hits[..., 0], N))
    return int(first.sum())


def bound(name: str, inp: dict) -> Tuple[int, int]:
    """(bytes, operations) a launch of ``name`` on ``inp`` needs at least:
    each input read once and each output written once, each at its own
    element size; operations counted from the shapes."""
    if name == "knn_kernel":
        B, N, C = inp["base"].shape
        S, k = inp["query"].shape[1], inp["k"]
        nbytes = 4 * (B * N * C + B * S * C) + 8 * B * S * k
        ops = knn_ops(B, N, S, C)
    elif name == "windowed_knn_kernel":
        B, N, C = inp["base"].shape
        S, k = inp["query"].shape[1], inp["k"]
        nbytes = 4 * (B * N * C + B * S * C) + 8 * B * S * k
        ops = B * S * inp["spec"].window * (2 * C + 3) + 2 * B * (S + N) * C + 3 * B * S * k * C
    elif name == "ball_query_kernel":
        B, N, C = inp["xyz"].shape
        S, ns = inp["new_xyz"].shape[1], inp["nsample"]
        nbytes = 4 * (B * N * C + B * S * C + B * S * ns)
        ops = ball_query_tests(inp["radius"], ns, inp["xyz"], inp["new_xyz"]) * (2 * C + 3)
    elif name == "fps_kernel":
        B, N, C = inp["points"].shape
        npoint = inp["npoint"]
        nbytes = 4 * B * N * C + 4 * B * npoint
        ops = B * npoint * N * 3 * C
    elif name == "gather_rows_kernel":
        B, _, W = inp["points"].shape
        E = inp["idx"].shape[1]
        s = torch.sort(inp["idx"], dim=1).values
        named = B * min(E, 1) + int((s[:, 1:] != s[:, :-1]).sum())
        nbytes = inp["points"].element_size() * (named + B * E) * W + 4 * B * E
        ops = 0
    elif name == "scatter_add_rows_kernel":
        B, E, W = inp["grads"].shape
        es = inp["grads"].element_size()
        nbytes = es * (B * E * W + B * inp["num_points"] * W) + 4 * B * E
        ops = B * E * W
    elif name in ("scatter_mean_kernel", "windowed_scatter_mean_kernel"):
        B, S, C = inp["features"].shape
        K, N = inp["knn_idx"].shape[2], inp["num_fine"]
        es = inp["features"].element_size()
        nbytes = es * (B * S * C + B * N * C) + 4 * (B * S * K + B * N)
        idx = inp["knn_idx"]
        ops = int(((idx >= 0) & (idx < N)).sum()) * C + B * N * C
    elif name in ("transition_attention_bwd_kernel", "windowed_attention_bwd_kernel"):
        B, N, Win = inp["packed"].shape
        S, K = inp["idx"].shape[1:]
        Wo = inp["n_branches"] * inp["c"]
        sh = int(inp["shifts"] is not None)
        es = inp["packed"].element_size()
        nbytes = es * (2 * B * N * Win + B * S * Wo * (1 + 2 * sh)) + 4 * B * S * K
        ops = B * S * Wo * (K * (6 + sh) + 17 + 2 * sh)
    else:
        B, N, Win = inp["packed"].shape
        S, K = inp["idx"].shape[1:]
        Wo = inp["n_branches"] * inp["c"]
        has_shift = inp["shifts"] is not None
        es = inp["packed"].element_size()
        nbytes = es * (B * N * Win + B * S * Wo * (2 if has_shift else 1)) + 4 * B * S * K
        ops = attention_ops(B, S, Wo, K, has_shift)
    return nbytes, ops


def least_seconds(name: str, inp: dict) -> float:
    """The least time of one launch: its bytes at the peak bandwidth or its
    operations at the float32 peak, whichever is longer."""
    nbytes, ops = bound(name, inp)
    return max(nbytes / PEAK_BYTES, ops / PEAK_FLOPS)


def busy_seconds(intervals: Iterable[Tuple[float, float]]) -> float:
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


def idle_gaps(intervals: Iterable[Tuple[float, float]], start: float, stop: float):
    """The gaps between ``start`` and ``stop`` that no interval covers, as
    ``(gap start, gap end)``."""
    gaps, at = [], start
    for a, b in sorted(intervals):
        if a > at:
            gaps.append((at, min(a, stop)))
        at = max(at, b)
        if at >= stop:
            break
    if at < stop:
        gaps.append((at, stop))
    return [(a, b) for a, b in gaps if b > a]
