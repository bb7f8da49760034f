"""Radius (ball) grouping.

Counterpart of ``mpa_tpu/ops/ball_query.py::ball_query``: for each centre,
the first ``nsample`` base points in index order whose squared distance is
within ``radius**2``; slots left over repeat the first hit, and a centre with
no hit at all gets index 0.

It runs in two stages. The sentinel stage marks the missing slots with N: on
a CUDA tensor ``ball_query_kernel`` (``kernels/csrc/ball_query.cu``, in
:func:`ball_query_form`'s form) computes it, always, at any size; on a CPU
tensor :func:`ball_query_plain` does. The backfill then runs in torch on
both.

Membership must agree where a distance lies within a last bit of the radius:
both stages take the distance of ``ops/pairwise.py::square_distance`` and
compare it with ``radius * radius`` taken in double and rounded once to
float32, as JAX does (:func:`radius_squared`). The indices carry no gradient.
The kernel's entry is the custom op ``mpa::ball_query`` (``ops/library.py``),
which :func:`ball_query_cuda` calls.
"""

from __future__ import annotations

import numpy as np
import torch

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.ops import library
from mpa_tpu_torch.ops.pairwise import square_distance
from mpa_tpu_torch.utils.device import on_cuda

MAX_C = 256
MAX_B = 65535  # the kernel's grid runs the batch along y
# ball_query_kernel's warps take 8 centres each, halved down to 1 while the
# launch has fewer than FILL_WARPS warps (16 a streaming multiprocessor of
# the H100's 132): a warp reads each staged base row once for all its
# centres, and a launch wants enough warps to hide each test's latency.
MAX_CENTRES, FILL_WARPS = 8, 16 * 132


def radius_squared(radius: float) -> float:
    """``radius * radius`` in double, rounded once to float32."""
    return float(np.float32(float(radius) * float(radius)))


def ball_query_plain(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """Plain sentinel stage: each base point in radius marked with its index,
    every other with N, and the ``nsample`` smallest marks in ascending order
    (``mpa_tpu/ops/ball_query.py:56-60``). ``[B, S, nsample]`` int32."""
    N = xyz.shape[1]
    d = square_distance(new_xyz, xyz)  # [B, S, N]
    r2 = torch.tensor(radius_squared(radius), dtype=torch.float32, device=d.device)
    arange = torch.arange(N, dtype=torch.int32, device=d.device)
    marked = torch.where(d <= r2, arange, torch.full_like(arange, N))
    return torch.topk(marked, nsample, dim=-1, largest=False, sorted=True).values


def ball_query_form(B: int, S: int) -> int:
    """The centres a warp of ``ball_query_kernel`` holds for ``B`` clouds of
    ``S`` centres: ``MAX_CENTRES`` halved down to 1 while ``B * ceil(S /
    G)`` warps fall short of ``FILL_WARPS``. The kernel's entry refuses any
    other value than 1, 2, 4 or 8."""
    g = MAX_CENTRES
    while g > 1 and B * -(-S // g) < FILL_WARPS:
        g //= 2
    return g


def _check(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> None:
    if xyz.dim() != 3 or new_xyz.dim() != 3:
        raise ValueError(f"ball_query: xyz/new_xyz must be [B,N,C]/[B,S,C], got "
                         f"{tuple(xyz.shape)}, {tuple(new_xyz.shape)}")
    if xyz.shape[0] != new_xyz.shape[0] or xyz.shape[2] != new_xyz.shape[2]:
        raise ValueError(f"ball_query: batch/channel mismatch {tuple(xyz.shape)} vs "
                         f"{tuple(new_xyz.shape)}")
    if not 1 <= nsample <= xyz.shape[1]:
        raise ValueError(f"ball_query: nsample={nsample} must be in [1, N={xyz.shape[1]}]")


def _check_kernel(nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor) -> None:
    _check(nsample, xyz, new_xyz)
    B, N, C = xyz.shape
    S = new_xyz.shape[1]
    if C > MAX_C or not 1 <= B <= MAX_B or S < 1:
        raise ValueError(f"ball_query_kernel supports C <= {MAX_C}, 1 <= B <= {MAX_B} and "
                         f"S >= 1, got C={C}, B={B}, S={S}")
    for name, t in (("xyz", xyz), ("new_xyz", new_xyz)):
        if not library.kernel_device(t) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"ball_query_kernel: {name} must be a contiguous float32 CUDA tensor")
    if xyz.device != new_xyz.device:
        raise ValueError("ball_query_kernel: xyz and new_xyz on different devices")


def _ball_query_impl(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    """``mpa::ball_query`` on the card: launch ``ball_query_kernel``, the
    sentinel stage, in :func:`ball_query_form`'s form."""
    _check_kernel(nsample, xyz, new_xyz)
    B, N, C = xyz.shape
    S = new_xyz.shape[1]
    g = ball_query_form(B, S)
    out = torch.empty((B, S, nsample), dtype=torch.int32, device=xyz.device)
    lib = build.load()
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_ball_query(xyz.data_ptr(), new_xyz.data_ptr(), out.data_ptr(), B, N, S, C,
                               nsample, radius_squared(radius), g, stream),
            f"ball_query_kernel ({g} centres a warp)",
        )
    kernels.launched("ball_query_kernel",
                     {"radius": radius, "nsample": nsample, "xyz": xyz, "new_xyz": new_xyz})
    return out


def _ball_query_fake(radius: float, nsample: int, xyz: torch.Tensor,
                     new_xyz: torch.Tensor) -> torch.Tensor:
    _check_kernel(nsample, xyz, new_xyz)
    return xyz.new_empty((xyz.shape[0], new_xyz.shape[1], nsample), dtype=torch.int32)


ball_query_op = library.define(
    "ball_query(float radius, int nsample, Tensor xyz, Tensor new_xyz) -> Tensor",
    _ball_query_impl, _ball_query_fake)


def ball_query_cuda(radius: float, nsample: int, xyz: torch.Tensor,
                    new_xyz: torch.Tensor) -> torch.Tensor:
    """``ball_query_kernel``, the sentinel stage on CUDA tensors, through
    ``mpa::ball_query``."""
    library.check_device("ball_query_kernel", xyz, new_xyz)
    return ball_query_op(float(radius), nsample, xyz, new_xyz)


def ball_query(radius: float, nsample: int, xyz: torch.Tensor,
               new_xyz: torch.Tensor) -> torch.Tensor:
    """Group up to ``nsample`` base points within ``radius`` of each centre.

    Args:
      radius: grouping radius.
      nsample: group size, ``<= N``.
      xyz: ``[B, N, C]`` base points.
      new_xyz: ``[B, S, C]`` centres.

    Returns:
      ``[B, S, nsample]`` int32 indices into N, ascending, the empty slots
      repeating the first hit.
    """
    xyz, new_xyz = xyz.detach(), new_xyz.detach()
    if on_cuda(xyz, "xyz"):
        group_idx = ball_query_cuda(radius, nsample, xyz.float().contiguous(),
                                    new_xyz.float().contiguous())
    else:
        _check(nsample, xyz, new_xyz)
        group_idx = ball_query_plain(radius, nsample, xyz, new_xyz)
    # The backfill (mpa_tpu/ops/ball_query.py:61-64): a sentinel becomes the
    # centre's first hit, and a centre with no hit gets 0.
    N = xyz.shape[1]
    group_idx = torch.where(group_idx == N, group_idx[..., :1], group_idx)
    return torch.where(group_idx == N, torch.zeros_like(group_idx), group_idx)
