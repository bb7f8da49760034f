"""Farthest point sampling.

Counterpart of ``mpa_tpu/ops/fps.py::farthest_point_sample`` with a fixed
start index (the keyed random start is training-only and not ported yet).
Semantics of the XLA loop there: ``out[:, i] = last`` is recorded before the
update; distances are direct differences ``sum_c (p_c - last_c)^2`` accumulated
in channel order; the running minimum starts at ``inf``; the argmax takes the
first maximum. On a CUDA tensor it launches ``fps_kernel``
(``kernels/csrc/fps.cu``); on a CPU tensor it takes :func:`fps_plain`.

:func:`banded_farthest_point_sample` is the window modes' FPS
(``mpa_tpu/ops/fps.py:89-165``): a Morton-sorted cloud cut into contiguous
index bands, each sampled exactly, the bands folded into the batch axis, so
one ``fps_kernel`` launch runs them all.
"""

from __future__ import annotations

import torch

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.utils.device import on_cuda

MAX_N = 16384  # 1024 threads of 16 points each
SMEM_BYTES = 227 * 1024 - 512  # shared memory a Hopper block may use, less the kernel's own


def fps_plain(points: torch.Tensor, npoint: int, start_idx: int = 0) -> torch.Tensor:
    """Plain version: the selection loop in PyTorch (``torch.argmax`` returns
    the first maximum)."""
    B, N, C = points.shape
    pts = points.float()
    batch = torch.arange(B, device=pts.device)
    min_d = torch.full((B, N), float("inf"), dtype=torch.float32, device=pts.device)
    last = torch.full((B,), start_idx, dtype=torch.long, device=pts.device)
    out = torch.empty((B, npoint), dtype=torch.int32, device=pts.device)
    for i in range(npoint):
        out[:, i] = last
        diff = pts - pts[batch, last].unsqueeze(1)  # [B, N, C]
        d = diff[..., 0] * diff[..., 0]
        for c in range(1, C):
            d = d + diff[..., c] * diff[..., c]
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
    return out


def _check(points: torch.Tensor, npoint: int, start_idx: int) -> None:
    if points.dim() != 3:
        raise ValueError(f"farthest_point_sample: points must be [B,N,C], got {tuple(points.shape)}")
    N = points.shape[1]
    if not 1 <= npoint <= N:
        raise ValueError(f"farthest_point_sample: npoint={npoint} must be in [1, N={N}]")
    if not 0 <= start_idx < N:
        raise ValueError(f"farthest_point_sample: start_idx={start_idx} out of [0, {N})")


def fps_cuda(points: torch.Tensor, npoint: int, start_idx: int = 0) -> torch.Tensor:
    """Launch ``fps_kernel`` on a CUDA tensor."""
    _check(points, npoint, start_idx)
    B, N, C = points.shape
    if points.device.type != "cuda" or points.dtype != torch.float32 or not points.is_contiguous():
        raise ValueError("fps_kernel: points must be a contiguous float32 CUDA tensor")
    if N > MAX_N or N * C * 4 > SMEM_BYTES:
        raise ValueError(f"fps_kernel: cloud [N={N}, C={C}] does not fit one block's shared memory")
    out = torch.empty((B, npoint), dtype=torch.int32, device=points.device)
    lib = build.load()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_fps(points.data_ptr(), out.data_ptr(), B, N, C, npoint, start_idx, stream),
            "fps_kernel",
        )
    kernels.launched("fps_kernel", {"points": points, "npoint": npoint, "start_idx": start_idx})
    return out


def farthest_point_sample(
    points: torch.Tensor, npoint: int, *, start_idx: int = 0
) -> torch.Tensor:
    """Iterative farthest point sampling.

    Args:
      points: ``[B, N, C]`` coordinates (or features).
      npoint: number of samples, ``<= N``.
      start_idx: the first pick of every batch element.

    Returns:
      ``[B, npoint]`` int32 indices into N.
    """
    points = points.detach()
    if on_cuda(points, "points"):
        return fps_cuda(points.float().contiguous(), npoint, start_idx)
    _check(points, npoint, start_idx)
    return fps_plain(points, npoint, start_idx)


def pick_fps_bands(N: int, npoint: int, *, min_band: int = 512, min_samples: int = 64) -> int:
    """The largest power-of-two band count G such that every band keeps at
    least ``min_band`` points and gives at least ``min_samples`` samples; 1
    (exact FPS) when no banding fits."""
    g = 1
    while (N % (g * 2) == 0 and npoint % (g * 2) == 0
           and N // (g * 2) >= min_band and npoint // (g * 2) >= min_samples):
        g *= 2
    return g


def banded_farthest_point_sample(
    points: torch.Tensor, npoint: int, n_bands: int, *, start_idx: int = 0
) -> torch.Tensor:
    """FPS inside each of ``n_bands`` contiguous index bands of a
    Morton-sorted cloud, ``npoint / n_bands`` samples per band, each band
    starting at its own ``start_idx``.

    Returns ``[B, npoint]`` int32 indices into N, grouped by band in index
    order (each band's block in selection order); ``n_bands == 1`` is
    :func:`farthest_point_sample`.
    """
    if n_bands <= 1:
        return farthest_point_sample(points, npoint, start_idx=start_idx)
    B, N, C = points.shape
    if N % n_bands or npoint % n_bands:
        raise ValueError(f"n_bands={n_bands} must divide N={N} and npoint={npoint}")
    nb, pb = N // n_bands, npoint // n_bands
    local = farthest_point_sample(points.reshape(B * n_bands, nb, C), pb, start_idx=start_idx)
    offsets = torch.arange(n_bands, dtype=torch.int32, device=local.device)[None, :, None] * nb
    return (local.reshape(B, n_bands, pb) + offsets).reshape(B, npoint)
