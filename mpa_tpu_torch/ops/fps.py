"""Farthest point sampling.

Counterpart of ``mpa_tpu/ops/fps.py::farthest_point_sample``. Semantics of
the XLA loop there: ``out[:, i] = last`` is recorded before the update;
distances are direct differences ``sum_c (p_c - last_c)^2`` accumulated in
channel order; the running minimum starts at ``inf``; the argmax takes the
first maximum. Each cloud starts at its own index (``mpa_tpu`` draws them
with ``jax.random.randint(key, (B,), 0, N)``; a caller passes the drawn
``[B]`` tensor) or every cloud at one ``start_idx``. On a CUDA tensor it
launches ``fps_kernel`` (``kernels/csrc/fps.cu``) through the custom op
``mpa::fps`` (``ops/library.py``; a start tensor is its ``starts``
argument, else the index ``start``); on a CPU tensor it takes
:func:`fps_plain`.

:func:`banded_farthest_point_sample` is the window modes' FPS
(``mpa_tpu/ops/fps.py:89-165``): a Morton-sorted cloud cut into contiguous
index bands, each sampled exactly, the bands folded into the batch axis, so
one ``fps_kernel`` launch runs them all.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.ops import library
from mpa_tpu_torch.utils.device import on_cuda

Start = Union[int, torch.Tensor]
MAX_CLUSTER = 16  # CTAs a cloud: the largest cluster Hopper launches
MAX_SLOTS = 64  # cluster size x warps a block (fps.cu kMaxSlots)
# Shared memory a block may use (227 KB), less the kernel's own 1 KB of slots.
SMEM_BYTES = 227 * 1024 - 1024
RESIDENT_BYTES = 192 * 1024  # the resident form's whole cloud: 16384 3-channel points


def fps_plain(points: torch.Tensor, npoint: int, start: Start = 0) -> torch.Tensor:
    """Plain version: the selection loop in PyTorch (``torch.argmax`` returns
    the first maximum); ``start`` is one index for every cloud or a ``[B]``
    tensor."""
    B, N, C = points.shape
    pts = points.float()
    batch = torch.arange(B, device=pts.device)
    min_d = torch.full((B, N), float("inf"), dtype=torch.float32, device=pts.device)
    if torch.is_tensor(start):
        last = start.to(device=pts.device, dtype=torch.long).reshape(B)
    else:
        last = torch.full((B,), int(start), dtype=torch.long, device=pts.device)
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


def _check_shape(points: torch.Tensor, npoint: int) -> None:
    if points.dim() != 3:
        raise ValueError(f"farthest_point_sample: points must be [B,N,C], got {tuple(points.shape)}")
    N = points.shape[1]
    if not 1 <= npoint <= N:
        raise ValueError(f"farthest_point_sample: npoint={npoint} must be in [1, N={N}]")


def _check(points: torch.Tensor, npoint: int, start: Start) -> None:
    """Shapes and starts; the values of a start tensor on the card are left to
    :func:`_device_start`, which checks them there without waiting for it."""
    _check_shape(points, npoint)
    B, N = points.shape[:2]
    if not torch.is_tensor(start):
        if not 0 <= start < N:
            raise ValueError(f"farthest_point_sample: start_idx={start} out of [0, {N})")
        return
    if start.numel() != B or start.dtype.is_floating_point or start.dtype == torch.bool:
        raise ValueError(f"farthest_point_sample: start must be B={B} integer indices, got "
                         f"{tuple(start.shape)} {start.dtype}")
    if start.device.type != "cuda" and start.numel() and not bool(((start >= 0) & (start < N)).all()):
        raise ValueError(f"farthest_point_sample: a start index out of [0, {N})")


def _device_start(start: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """A ``[B]`` start tensor as the kernel reads it: int32 on the points'
    card. One that was already there is checked on the card, by an
    asynchronous assert, so that no call waits for the card."""
    B, N = points.shape[:2]
    on_card = start.device.type == "cuda"
    start = start.to(device=points.device, dtype=torch.int32).reshape(B).contiguous()
    if on_card:
        torch._assert_async(((start >= 0) & (start < N)).all(),
                            f"fps_kernel: a start index out of [0, {N})")
    return start


def _slice_bytes(N: int, C: int, cs: int, nw: int) -> int:
    L = -(-N // cs)
    return 4 * (C * L + L + nw * C)


def fps_form(B: int, N: int, C: int) -> Tuple[bool, int, int]:
    """``fps_kernel``'s form for ``B`` clouds of ``[N, C]``: ``(resident,
    cluster size, warps a block)``, fixed by the shape (``PERF.md`` section
    6 gives the times that set it).

    Resident (C == 3 and the cloud within ``RESIDENT_BYTES``): clouds of up
    to 2048 points keep one block of N / 64 warps (1 to 16), about two
    points a thread; larger ones spread over 4 CTAs (up to 4096 points) or
    8, of 4 warps. Sliced (every other shape): the fewest CTAs whose slices
    fit shared memory, doubled while a slice holds more than 256 points, of
    8 warps up to 2 CTAs and 4 from 4. ``mpa_fps`` refuses any other form.
    Raises ValueError, naming the limit, for a cloud whose slices do not fit
    16 CTAs."""
    if C == 3 and 12 * N <= RESIDENT_BYTES:
        if N <= 2048:
            return True, 1, min(16, max(1, N // 64))
        return True, 4 if N <= 4096 else 8, 4
    cs = 1
    while cs <= MAX_CLUSTER and _slice_bytes(N, C, cs, 8) > SMEM_BYTES:
        cs *= 2
    if cs > MAX_CLUSTER:
        raise ValueError(
            f"fps_kernel: a [N={N}, C={C}] cloud does not fit the shared memory of "
            f"{MAX_CLUSTER} CTAs (4 * (C + 1) * ceil(N / 16) bytes <= {SMEM_BYTES} a CTA)")
    while cs < MAX_CLUSTER and -(-N // cs) > 256:
        cs *= 2
    return False, cs, 8 if cs <= 2 else 4


def _launch(points: torch.Tensor, npoint: int, start: Start, chain: bool) -> torch.Tensor:
    """``fps_kernel`` in :func:`fps_form`'s form; an int ``start`` goes to the
    kernel as a value (no start tensor), a tensor one as ``[B]`` int32."""
    _check(points, npoint, start)
    if points.device.type != "cuda" or points.dtype != torch.float32 or not points.is_contiguous():
        raise ValueError("fps_kernel: points must be a contiguous float32 CUDA tensor")
    B, N, C = points.shape
    resident, cs, nw = fps_form(B, N, C)
    starts = _device_start(start, points) if torch.is_tensor(start) else None
    out = torch.empty((B, npoint), dtype=torch.int32, device=points.device)
    lib = build.load()
    with torch.cuda.device(points.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_fps(points.data_ptr(), None if starts is None else starts.data_ptr(),
                        0 if starts is not None else int(start), out.data_ptr(), B, N, C, npoint,
                        cs, nw, int(resident), int(chain), stream),
            f"fps_kernel (B={B}, N={N}, C={C}, resident={resident}, cluster={cs}, warps={nw})",
        )
    return out


def _fps_impl(points: torch.Tensor, npoint: int, start: int,
              starts: Optional[torch.Tensor]) -> torch.Tensor:
    """``mpa::fps`` on the card: ``fps_kernel`` from ``starts`` (``[B]``
    integer indices) where given, else from index ``start`` in every cloud."""
    chosen = start if starts is None else starts
    out = _launch(points, npoint, chosen, chain=False)
    kernels.launched("fps_kernel", {"points": points, "npoint": npoint, "start": chosen})
    return out


def _fps_fake(points: torch.Tensor, npoint: int, start: int,
              starts: Optional[torch.Tensor]) -> torch.Tensor:
    _check_shape(points, npoint)
    return points.new_empty((points.shape[0], npoint), dtype=torch.int32)


fps_op = library.define("fps(Tensor points, int npoint, int start, Tensor? starts) -> Tensor",
                        _fps_impl, _fps_fake)


def fps_cuda(points: torch.Tensor, npoint: int, start: Start = 0) -> torch.Tensor:
    """``fps_kernel`` on a contiguous float32 CUDA tensor, through ``mpa::fps``."""
    library.check_device("fps_kernel", points)
    if torch.is_tensor(start):
        return fps_op(points, npoint, 0, start)
    return fps_op(points, npoint, int(start), None)


def fps_chain_cuda(points: torch.Tensor, npoint: int, start: Start = 0) -> torch.Tensor:
    """A measurement, not a sampler: ``fps_kernel``'s ``npoint`` steps in the
    same form with the distance work cut (the same barriers, reductions and
    loads of the pick), so that its time is the chain floor of that launch.
    Not counted as a launch; its output is not FPS."""
    return _launch(points, npoint, start, chain=True)


def farthest_point_sample(
    points: torch.Tensor, npoint: int, *, start_idx: Start = 0
) -> torch.Tensor:
    """Iterative farthest point sampling.

    Args:
      points: ``[B, N, C]`` coordinates (or features).
      npoint: number of samples, ``<= N``.
      start_idx: the first pick, one index for every cloud or a ``[B]``
        integer tensor of one per cloud.

    Returns:
      ``[B, npoint]`` int32 indices into N.
    """
    points = points.detach()
    if on_cuda(points, "points"):
        return fps_cuda(points.float().contiguous(), npoint, start_idx)
    _check(points, npoint, start_idx)
    return fps_plain(points, npoint, start_idx)


def draw_starts(generator: torch.Generator, batch: int, n: int, n_bands: int = 1
                ) -> torch.Tensor:
    """Keyed FPS starts drawn from ``generator`` on its device: one index in
    ``[0, n)`` a cloud (``[batch]``), or with ``n_bands > 1`` one band-local
    index in ``[0, n / n_bands)`` a band (``[batch, n_bands]``), uniform, as
    ``mpa_tpu`` draws them with ``jax.random.randint`` (torch draws other
    values from the same seed)."""
    shape = (batch,) if n_bands <= 1 else (batch, n_bands)
    return torch.randint(0, n // max(n_bands, 1), shape, generator=generator,
                         device=generator.device, dtype=torch.int32)


def keyed_start(keyed: bool, i: int, generator: Optional[torch.Generator], starts,
                batch: int, n: int, n_bands: int = 1) -> Union[int, torch.Tensor]:
    """The start of FPS scale ``i`` (ladder order) over ``batch`` clouds of
    ``n`` points: with ``keyed`` (train mode, ``mpa_tpu`` keys FPS in no
    other), the caller's ``starts[i]`` or else a :func:`draw_starts` draw
    from ``generator``; index 0 otherwise, or when neither is given."""
    if keyed and starts is not None:
        return starts[i]
    if keyed and generator is not None:
        return draw_starts(generator, batch, n, n_bands)
    return 0


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
    points: torch.Tensor, npoint: int, n_bands: int, *, start_idx: Start = 0
) -> torch.Tensor:
    """FPS inside each of ``n_bands`` contiguous index bands of a
    Morton-sorted cloud, ``npoint / n_bands`` samples per band, each band
    starting at ``start_idx`` (one band-local index, or a ``[B, n_bands]``
    integer tensor of one per band, as ``mpa_tpu`` draws them for the folded
    ``[B * n_bands]`` batch).

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
    if torch.is_tensor(start_idx):
        start_idx = start_idx.reshape(B * n_bands)
    local = farthest_point_sample(points.reshape(B * n_bands, nb, C), pb, start_idx=start_idx)
    offsets = torch.arange(n_bands, dtype=torch.int32, device=local.device)[None, :, None] * nb
    return (local.reshape(B, n_bands, pb) + offsets).reshape(B, npoint)
