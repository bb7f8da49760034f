"""Train-mode BatchNorm + LeakyReLU(0.2) over channel-last rows, fused,
forward and backward.

No Pallas kernel of ``mpa_tpu`` has this function: its BatchNorm is flax's
``nn.BatchNorm(momentum=0.9, epsilon=1e-5, use_fast_variance=False)``
(``mpa_tpu/nn/linear.py``), which XLA fuses with the activation. The port ran
the same arithmetic as plain tensor code, about 18 launches forward and 22
backward a norm, and :func:`batch_norm_act` replaces them.

:func:`batch_norm_act` is the train-mode, single-process step of
``nn/linear.py::BatchNorm``: the batch statistics over every axis but the
last, the normalised output, the running statistics' update and, where
``act``, the LeakyReLU. On a CUDA tensor it is a ``torch.autograd.Function``
whose forward launches ``batch_norm_act_kernel`` (``kernels/csrc/
batch_norm.cu``) and keeps only the input and the per-channel mean and rstd,
and whose backward launches ``batch_norm_act_bwd_kernel``; a CUDA tensor that
is not float32 raises. On a CPU tensor it takes :func:`batch_norm_act_plain`,
the arithmetic the port ran before the kernel, which autograd differentiates.

The kernels take every sum over the rows in the order PyTorch's own CUDA
reduction takes it (:func:`reduce_config`), and round every other step as
the plain version's operations and autograd's backward through them do, so
that on the card the fused forward and backward give the plain version's
values bit for bit: the models search neighbours in feature space after
their norms, and a norm that rounds otherwise moves a near-tied neighbour and
with it the loss. :func:`batch_norm_act_bwd_plain` writes that backward out
in tensor operations, for the tests and ``chip_smoke.py``.

The kernels' entries are the custom ops ``mpa::batch_norm_act`` (which
updates the running statistics in place) and ``mpa::batch_norm_act_bwd``
(``ops/library.py``). Each counts its call in ``kernels.NORM_LAUNCHES``, and
neither is recorded (``kernels.norm_launched``). Each fused call counts
``COUNTS["batch_norm_act.fused"]`` (``utils/profiling.py``).
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.ops import library
from mpa_tpu_torch.utils import profiling
from mpa_tpu_torch.utils.device import on_cuda

# PyTorch's column reduction (ATen/native/cuda/Reduce.cuh) for float32: at
# most MAX_THREADS / vec threads a block, four accumulators a thread, a warp
# of 32; the H100's SM and thread counts where no card is asked.
MAX_THREADS, WARP = 512, 32
H100_SMS, H100_THREADS_PER_SM = 132, 2048
NEGATIVE_SLOPE = 0.2


def leaky_relu(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """``jax.nn.leaky_relu(x, 0.2)``: in float32 ``F.leaky_relu``; in bf16
    ``where(x >= 0, x, bf16(0.2) * x)``, the slope a bf16 weak scalar as in
    JAX (``F.leaky_relu`` would multiply by the float32 0.2). ``inplace``
    overwrites a float32 ``x`` with the same values."""
    if x.dtype != torch.bfloat16:
        return F.leaky_relu(x, negative_slope=NEGATIVE_SLOPE, inplace=inplace)
    return torch.where(x >= 0, x, x * torch.tensor(NEGATIVE_SLOPE, dtype=x.dtype))


def normalise_plain(centred: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                    weight: torch.Tensor, bias: torch.Tensor, running_mean: torch.Tensor,
                    running_var: torch.Tensor, eps: float, momentum: float) -> torch.Tensor:
    """flax's ``_normalize`` from the batch statistics, ``centred * (rsqrt(var
    + eps) * weight) + bias``, and the running statistics' update
    ``keep * running + (1 - keep) * batch`` (flax's ``momentum`` is ``keep``,
    torch's ``momentum`` is ``1 - keep``)."""
    y = centred * (torch.rsqrt(var + eps) * weight) + bias
    keep = 1.0 - momentum
    with torch.no_grad():
        running_mean.copy_(keep * running_mean + (1.0 - keep) * mean)
        running_var.copy_(keep * running_var + (1.0 - keep) * var)
    return y


def batch_norm_act_plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                         running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                         momentum: float, act: bool) -> torch.Tensor:
    """Plain version: ``mean`` and the biased ``var = mean((x - mean)^2)``
    over every axis but the last, in two passes; :func:`normalise_plain`;
    :func:`leaky_relu` where ``act``."""
    dims = tuple(range(x.dim() - 1))
    mean = torch.mean(x, dim=dims)
    centred = x - mean
    var = torch.mean(centred * centred, dim=dims)
    y = normalise_plain(centred, mean, var, weight, bias, running_mean, running_var, eps,
                        momentum)
    return leaky_relu(y) if act else y


def batch_norm_act_bwd_plain(dy: torch.Tensor, x: torch.Tensor, weight: torch.Tensor,
                             bias: torch.Tensor, mean: torch.Tensor, rstd: torch.Tensor,
                             act: bool) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The closed-form backward of :func:`batch_norm_act` at rows ``x [R, C]``
    with the forward's ``mean`` and ``rstd``: ``(dx, dweight, dbias)``,
    autograd's steps through :func:`batch_norm_act_plain` written out, as
    the kernel takes them. With ``c = x - mean``, ``gy`` the gradient at the
    pre-activation output (``dy`` through the LeakyReLU's slope):
    ``dbias = sum(gy)``, ``dweight = sum(gy * c) * rstd``; the variance's
    gradient ``gsq`` a row (``-0.5 * sum(gy * c) * weight * rstd^3 / R``);
    the centred rows' ``gc = gy * rstd * weight + 2 * gsq * c``; ``dx = gc -
    sum(gc) / R``."""
    R = x.shape[0]
    c = x - mean
    s = rstd * weight
    gy = dy
    if act:
        gy = torch.where(c * s + bias > 0, dy, dy * NEGATIVE_SLOPE)
    dbias = gy.sum(dim=0)
    gs = (gy * c).sum(dim=0)
    gsq = gs * weight * -0.5 * (rstd * rstd * rstd) * (1.0 / R)
    gc = gy * s + gsq * c + gsq * c
    dx = gc - gc.sum(dim=0) * (1.0 / R)
    return dx, gs * rstd, dbias


def reduce_config(rows: int, channels: int, sms: int = H100_SMS,
                  threads_per_sm: int = H100_THREADS_PER_SM) -> Tuple[int, ...]:
    """The shape PyTorch's ``setReduceConfig`` gives a sum over the rows of a
    contiguous, 16-byte aligned float32 ``[rows, channels]`` tensor on a card
    of ``sms`` SMs of ``threads_per_sm`` threads, which the kernels follow so
    that their sums are PyTorch's, bit for bit: ``(vec, bw, bh, ctas,
    out_mult_y, in_mult_y, step_output, step_input)``. A thread adds ``vec``
    channels (4, 2 or 1, the most that divides ``channels``); a block is
    ``bw`` lanes of channels by ``bh`` row groups; where the rows are many,
    the row groups split them (``in_mult_y`` 1, else each takes channels of
    its own, ``out_mult_y`` = ``bw``) and ``ctas`` blocks of a column split
    them further, their partials added by a second launch; a thread's rows
    lie ``step_input`` apart, a block's channel groups ``step_output``. The
    kernels' entries refuse any other shape."""
    vec = next(v for v in (4, 2, 1) if channels % v == 0)
    most = MAX_THREADS // vec
    dim0 = channels // vec

    def pow2(n: int) -> int:
        return 1 << (n.bit_length() - 1) if n < most else most

    bw = min(pow2(dim0), WARP)
    bh = min(pow2(rows), most // bw)
    bw = min(pow2(dim0), most // bh)
    step_output, step_input, out_mult_y, in_mult_y, ctas = bw, 1, 0, 0, 1
    if rows >= min(bh * 16, 256):  # the row groups split the rows
        in_mult_y, step_input = 1, bh
    else:  # each row group its own channels
        out_mult_y, step_output = bw, bw * bh
    target = sms * (threads_per_sm // (bw * bh))
    grid = -(-dim0 // step_output)
    per_thread = -(-rows // step_input)
    if in_mult_y and per_thread >= 256 and grid <= target:
        ctas = max(min(-(-target // grid), -(-per_thread // 16)), -(-per_thread // 256))
        if ctas > 1:
            step_input *= ctas
    return vec, bw, bh, ctas, out_mult_y, in_mult_y, step_output, step_input


@functools.lru_cache(maxsize=None)
def _card(index: int) -> Tuple[int, int]:
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.max_threads_per_multi_processor


def _aligned(t: torch.Tensor, vec: int) -> torch.Tensor:
    """``t`` itself where it starts on a boundary of ``vec`` floats, else a
    copy that does (the caching allocator aligns every block)."""
    return t if t.data_ptr() % (4 * vec) == 0 else t.clone()


def check_args(name: str, rows: torch.Tensor, *channels: torch.Tensor) -> None:
    """The kernels' arguments: ``rows`` (x, dy) ``[R, C]`` and ``channels``
    (weight, bias, statistics) ``[C]``, float32, contiguous, on one CUDA
    device, ``1 <= R < 2^31``."""
    for t in (rows,) + channels:
        if not library.kernel_device(t) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: contiguous float32 CUDA tensors expected, got "
                             f"{t.dtype} on {t.device}")
        if t.device != rows.device:
            raise ValueError(f"{name}: tensors on different devices")
    if rows.dim() != 2 or not 1 <= rows.shape[0] < 2 ** 31 or rows.shape[1] < 1:
        raise ValueError(f"{name}: rows [R, C] with 1 <= R < 2^31 expected, got "
                         f"{tuple(rows.shape)}")
    for t in channels:
        if tuple(t.shape) != (rows.shape[1],):
            raise ValueError(f"{name}: [{rows.shape[1]}] per-channel tensors expected, got "
                             f"{tuple(t.shape)}")


def _fwd_fake(x, weight, bias, running_mean, running_var, eps, momentum, act):
    """``mpa::batch_norm_act``'s fake: ``(y [R,C], mean [C], rstd [C])``."""
    check_args("batch_norm_act_kernel", x, weight, bias, running_mean, running_var)
    return x.new_empty(x.shape), x.new_empty(x.shape[1]), x.new_empty(x.shape[1])


def _bwd_fake(dy, x, weight, bias, mean, rstd, act):
    """``mpa::batch_norm_act_bwd``'s fake: ``(dx [R,C], dweight [C], dbias
    [C])``."""
    check_args("batch_norm_act_bwd_kernel", x, weight, bias, mean, rstd)
    check_args("batch_norm_act_bwd_kernel", dy)
    if dy.shape != x.shape:
        raise ValueError(f"batch_norm_act_bwd_kernel: dy {tuple(dy.shape)} against x "
                         f"{tuple(x.shape)}")
    return x.new_empty(x.shape), x.new_empty(x.shape[1]), x.new_empty(x.shape[1])


def _config(rows: torch.Tensor):
    """``(R, C, reduce_config)`` of a launch on ``rows [R, C]``."""
    R, C = rows.shape
    return R, C, reduce_config(R, C, *_card(rows.device.index or 0))


def _fwd_impl(x, weight, bias, running_mean, running_var, eps, momentum, act):
    """``mpa::batch_norm_act`` on the card: launch ``batch_norm_act_kernel``
    in :func:`reduce_config`'s shape; the running statistics are updated in
    place."""
    name = "batch_norm_act_kernel"
    y, mean, rstd = _fwd_fake(x, weight, bias, running_mean, running_var, eps, momentum, act)
    R, C, config = _config(x)
    x = _aligned(x, config[0])
    part = x.new_empty((config[3], C))
    factor = float(np.float32(C) / np.float32(R * C))  # PyTorch's mean: float(C) / numel
    keep = 1.0 - momentum
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_batch_norm_act(x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                                   running_mean.data_ptr(), running_var.data_ptr(), y.data_ptr(),
                                   mean.data_ptr(), rstd.data_ptr(), part.data_ptr(), R, C,
                                   *config, factor, eps, keep, 1.0 - keep, int(act), stream),
            f"{name} (reduction {config})")
    kernels.norm_launched(name)
    return y, mean, rstd


def _bwd_impl(dy, x, weight, bias, mean, rstd, act):
    """``mpa::batch_norm_act_bwd`` on the card: launch
    ``batch_norm_act_bwd_kernel`` in the same shape."""
    name = "batch_norm_act_bwd_kernel"
    dx, dweight, dbias = _bwd_fake(dy, x, weight, bias, mean, rstd, act)
    R, C, config = _config(x)
    dy, x = _aligned(dy, config[0]), _aligned(x, config[0])
    part = x.new_empty((2 * config[3] + 2, C))
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_batch_norm_act_bwd(dy.data_ptr(), x.data_ptr(), weight.data_ptr(),
                                       bias.data_ptr(), mean.data_ptr(), rstd.data_ptr(),
                                       dx.data_ptr(), dweight.data_ptr(), dbias.data_ptr(),
                                       part.data_ptr(), R, C, *config, int(act), stream),
            f"{name} (reduction {config})")
    kernels.norm_launched(name)
    return dx, dweight, dbias


batch_norm_act_op = library.define(
    "batch_norm_act(Tensor x, Tensor weight, Tensor bias, Tensor(a!) running_mean, "
    "Tensor(b!) running_var, float eps, float momentum, bool act) -> (Tensor, Tensor, Tensor)",
    _fwd_impl, _fwd_fake)
batch_norm_act_bwd_op = library.define(
    "batch_norm_act_bwd(Tensor dy, Tensor x, Tensor weight, Tensor bias, Tensor mean, "
    "Tensor rstd, bool act) -> (Tensor, Tensor, Tensor)",
    _bwd_impl, _bwd_fake)


def batch_norm_act_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                        running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                        momentum: float, act: bool):
    """``batch_norm_act_kernel`` through ``mpa::batch_norm_act``: rows ``x
    [R, C]`` and ``[C]`` parameters and statistics, float32 -> ``(y [R, C],
    mean [C], rstd [C])``; the running statistics are updated in place."""
    library.check_device("batch_norm_act_kernel", x, weight, bias, running_mean, running_var)
    return batch_norm_act_op(x, weight, bias, running_mean, running_var, eps, momentum, act)


class _BatchNormAct(torch.autograd.Function):
    """``batch_norm_act_kernel`` forward, ``batch_norm_act_bwd_kernel``
    backward. Saves the input rows and the per-channel mean and rstd."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps, momentum, act):
        y, mean, rstd = batch_norm_act_cuda(x, weight, bias, running_mean, running_var, eps,
                                            momentum, act)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.act = act
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dweight, dbias = batch_norm_act_bwd_op(dy.contiguous(), x, weight, bias, mean, rstd,
                                                   ctx.act)
        return dx, dweight, dbias, None, None, None, None, None


def batch_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   running_mean: torch.Tensor, running_var: torch.Tensor, eps: float,
                   momentum: float, act: bool) -> torch.Tensor:
    """Train-mode BatchNorm of ``x [..., C]`` over every axis but the last,
    with the running statistics updated in place, then LeakyReLU(0.2) where
    ``act`` (differentiable in ``x``, ``weight`` and ``bias``). On a CUDA
    tensor the fused kernels (float32 only), on a CPU tensor
    :func:`batch_norm_act_plain`."""
    if not on_cuda(x, "x"):
        return batch_norm_act_plain(x, weight, bias, running_mean, running_var, eps, momentum,
                                    act)
    profiling.COUNTS["batch_norm_act.fused"] += 1
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    if library.needs_grad(rows, weight, bias):
        y = _BatchNormAct.apply(rows, weight, bias, running_mean, running_var, eps, momentum, act)
    else:
        y = batch_norm_act_cuda(rows, weight, bias, running_mean, running_var, eps, momentum,
                                act)[0]
    return y.reshape(x.shape)
