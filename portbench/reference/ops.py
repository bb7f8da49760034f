"""Plain PyTorch operations of the reference models, in float32.

Nothing here comes from the program. The neighbour selections follow the
semantics the models are defined with (``mpa_tpu``'s, which the port keeps):

- squared distances in the expanded form ``|a|^2 + |b|^2 - 2 a.b``, the dot
  products accumulated channel by channel in channel order, clamped at 0;
  the k smallest by a stable sort, so ties go to the lowest index;
- farthest point sampling from index 0, direct differences summed in
  channel order, a running minimum from ``inf``, the first maximum.

Everything else is the plain formula. Matrix products go through
:func:`linear`; inside :func:`tf32_matmuls` they run in TF32 (the control of
``portbench/check.py``): on the card by cuBLAS's TF32 path, on the CPU by
rounding both operands to TF32's 10-bit mantissa first.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

_emulate_tf32 = [False]


@contextlib.contextmanager
def tf32_matmuls() -> Iterator[None]:
    """Run the block's float32 matrix products in TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    _emulate_tf32[0] = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
        _emulate_tf32[0] = False


def full_float32() -> None:
    """Keep float32 matrix products in float32 on the card (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits), to nearest even."""
    v = x.float().contiguous().view(torch.int32).to(torch.int64)
    v = (v + 0xFFF + ((v >> 13) & 1)) & ~0x1FFF
    v = torch.where(v > 0x7FFFFFFF, v - (1 << 32), v)
    return v.to(torch.int32).view(torch.float32)


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32, its gradient passed through unchanged."""
    return x + (round_tf32(x) - x).detach()


def linear(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor]) -> torch.Tensor:
    if _emulate_tf32[0] and x.device.type == "cpu":
        x, weight = _tf32(x), _tf32(weight)
    return F.linear(x, weight, bias)


def batch_norm(x: torch.Tensor, weight, bias, running_mean, running_var, training: bool,
               eps: float = 1e-5, momentum: float = 0.9) -> torch.Tensor:
    """BatchNorm over every axis but the last, as flax computes it. Train
    mode: the batch mean, the biased variance ``mean((x - mean)^2)``, ``y =
    (x - mean) * (rsqrt(var + eps) * weight) + bias``, and the running
    statistics moved by ``momentum`` (``running = momentum * running + (1 -
    momentum) * batch``); eval mode normalises with the running ones."""
    if not training:
        flat = x.reshape(-1, x.shape[-1])
        return F.batch_norm(flat, running_mean, running_var, weight, bias, False, 0.0,
                            eps).reshape(x.shape)
    dims = tuple(range(x.dim() - 1))
    mean = torch.mean(x, dim=dims)
    centred = x - mean
    var = torch.mean(centred * centred, dim=dims)
    with torch.no_grad():
        running_mean.copy_(momentum * running_mean + (1.0 - momentum) * mean)
        running_var.copy_(momentum * running_var + (1.0 - momentum) * var)
    return centred * (torch.rsqrt(var + eps) * weight) + bias


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope=0.2)


def dropout(x: torch.Tensor, p: float, generator: Optional[torch.Generator]) -> torch.Tensor:
    """Keep each value with probability ``1 - p``, scaled by ``1 / (1 - p)``;
    the mask is ``rand < 1 - p`` drawn from ``generator``."""
    if generator is None or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros_like(x))


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    acc = a[..., 0] * b[..., 0]
    for c in range(1, a.shape[-1]):
        acc = acc + a[..., c] * b[..., c]
    return acc


def square_distance(query: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """``[B, S, C]`` x ``[B, N, C]`` -> ``[B, S, N]`` squared distances."""
    q, b = query.float(), base.float()
    out = (_dot(q, q)[..., :, None] + _dot(b, b)[..., None, :]) - 2.0 * _dot(q[..., :, None, :],
                                                                         b[..., None, :, :])
    return torch.clamp_min(out, 0.0)


@torch.no_grad()
def knn(k: int, base: torch.Tensor, query: torch.Tensor, rows: int = 1 << 25) -> torch.Tensor:
    """Indices ``[B, S, k]`` (int64) of the k nearest ``base`` rows of each
    ``query`` row, nearest first; searched a few clouds at a time, so that
    the distances of at most about ``rows`` pairs are held at once."""
    B, S, N = query.shape[0], query.shape[1], base.shape[1]
    step = max(1, rows // (S * N))
    out = []
    for b in range(0, B, step):
        d = square_distance(query[b:b + step], base[b:b + step])
        out.append(torch.sort(d, dim=-1, stable=True)[1][..., :k])
    return torch.cat(out).contiguous()


@torch.no_grad()
def farthest_point_sample(points: torch.Tensor, npoint: int) -> torch.Tensor:
    """``[B, npoint]`` (int64) indices of iterative farthest point sampling."""
    B, N, C = points.shape
    pts = points.float()
    batch = torch.arange(B, device=pts.device)
    min_d = torch.full((B, N), float("inf"), dtype=torch.float32, device=pts.device)
    last = torch.zeros((B,), dtype=torch.long, device=pts.device)
    out = torch.empty((B, npoint), dtype=torch.long, device=pts.device)
    for i in range(npoint):
        out[:, i] = last
        diff = pts - pts[batch, last].unsqueeze(1)
        d = diff[..., 0] * diff[..., 0]
        for c in range(1, C):
            d = d + diff[..., c] * diff[..., c]
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
    return out


def gather(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``points[b, idx[b, ...]]``: ``[B, N, C]`` by ``[B, *dims]`` ->
    ``[B, *dims, C]``."""
    B = points.shape[0]
    batch = torch.arange(B, device=points.device).view((B,) + (1,) * (idx.dim() - 1))
    return points[batch, idx]


def scatter_mean(features: torch.Tensor, idx: torch.Tensor, num_fine: int) -> torch.Tensor:
    """Each coarse row ``s`` gives its features to the fine rows
    ``idx[b, s, :]``; each fine row is the mean of what it received, zero
    where it received nothing. ``[B, S, C]``, ``[B, S, K]`` -> ``[B,
    num_fine, C]``. A fine row's sum is taken one claim after another in
    the order of the claims (coarse row, then neighbour), the order that
    defines its rounding, on every device: the claims are laid out in a
    padded table, a fine row's own in its row, and the table's columns are
    added in turn (the padding adds exact zeros)."""
    B, S, C = features.shape
    K = idx.shape[-1]
    seg = (idx + torch.arange(B, device=idx.device)[:, None, None] * num_fine).reshape(-1)
    order = torch.argsort(seg, stable=True)
    target = seg[order]
    count = torch.bincount(target, minlength=B * num_fine)
    first = torch.cumsum(count, 0) - count  # each fine row's first place in ``target``
    rank = torch.arange(target.numel(), device=idx.device) - first[target]
    table = features.new_zeros((B * num_fine, int(count.max()), C))
    table = table.index_put((target, rank), features.reshape(B * S, C)[order // K])
    total = table[:, 0]
    for j in range(1, table.shape[1]):
        total = total + table[:, j]
    mean = total / count.clamp_min(1).to(features.dtype)[:, None]
    return mean.reshape(B, num_fine, C)
