"""Fused multi-branch transition attention, forward and backward.

Counterpart of ``mpa_tpu/ops/pallas/attention_pallas.py::transition_attention``
and its custom VJP. On a CUDA tensor it is a ``torch.autograd.Function``
whose forward launches ``transition_attention_fwd_kernel``
(``kernels/csrc/attention.cu``) and whose backward launches
``transition_attention_bwd_kernel`` (``kernels/csrc/attention_bwd.cu``); both
gather the neighbour rows themselves, so the only residuals are ``packed``,
``idx`` and ``shifts``. On a CPU tensor it takes :func:`attention_plain`,
which autograd differentiates; :func:`attention_bwd_plain` is the backward
kernel's plain version.

bf16 ``packed``, ``shifts`` and incoming gradient (the mixed precision
models') stay bf16 on both devices: the arithmetic is the float32 one, and
the context, ``dpacked`` and ``dshift`` are rounded to bf16 once
(``attention_pallas.py:602-623``, ``:665,675``). On the CPU a
``torch.autograd.Function`` gives the bf16 forward :func:`attention_bwd_plain`
as its backward, whose scatter-add sums in float32 (autograd's own would add
the gathered rows' gradients in bf16).

The kernels' entries are the custom ops ``mpa::attention`` and
``mpa::attention_bwd`` (``ops/library.py``), which :func:`attention_cuda`
and :func:`attention_bwd_cuda` call; :func:`transition_attention` calls
the forward directly where no gradient is needed.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from torch.autograd.function import once_differentiable

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.ops import library
from mpa_tpu_torch.ops.gather import KERNEL_DTYPES, scatter_add_plain, stored
from mpa_tpu_torch.utils.device import on_cuda

# Guard for an all-underflowed exp-sum denominator; above the f32 subnormal
# range so it does not flush to 0 (attention_pallas.py _EPS).
_EPS = 1e-20
MAX_K = 64


def _sum_over_neighbours(E: torch.Tensor) -> torch.Tensor:
    """``sum_k E[:, :, k]`` accumulated in neighbour order, ``[B, S, K, c]`` ->
    ``[B, S, 1, c]``. The kernels add in this order; ``torch.sum`` picks its
    own, and a denominator that differs in its last bit moves ``w`` by a last
    bit too, which is enough to hand the maximum over K, and with it the
    whole gradient of that query and channel, to another neighbour."""
    acc = E[:, :, 0]
    for k in range(1, E.shape[2]):
        acc = acc + E[:, :, k]
    return acc.unsqueeze(2)


def attention_plain(
    packed: torch.Tensor,
    idx: torch.Tensor,
    shifts: Optional[torch.Tensor],
    n_branches: int,
    c: int,
) -> torch.Tensor:
    """Plain version, line for line ``attention_pallas.py::_xla_reference``."""
    B, S, K = idx.shape
    flat = idx.reshape(B, S * K).long()
    G = torch.gather(packed, 1, flat[..., None].expand(-1, -1, packed.shape[-1]))
    G = G.reshape(B, S, K, packed.shape[-1]).float()
    if shifts is not None:
        shifts = shifts.float()
    outs = []
    for r in range(n_branches):
        E = G[..., 2 * r * c : (2 * r + 1) * c]
        V = G[..., (2 * r + 1) * c : (2 * r + 2) * c]
        if shifts is not None:
            V = V + shifts[:, :, None, r * c : (r + 1) * c]
        denom = _sum_over_neighbours(E)
        attn = E / torch.clamp_min(denom, _EPS) - 1.0
        outs.append(torch.amax(attn * V, dim=2))
    return torch.cat(outs, dim=-1).to(packed.dtype)


def attention_bwd_plain(
    packed: torch.Tensor,
    idx: torch.Tensor,
    shifts: Optional[torch.Tensor],
    gctx: torch.Tensor,
    n_branches: int,
    c: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain version of the backward: ``attention_pallas.py::_attn_math``
    with ``g`` line for line (the eps floor gates the denominator's gradient,
    the max-over-K gradient splits equally among ties, ``dshift`` sums dV
    over K), then an ``index_add_`` of ``[dE || dV]`` into ``dpacked``.

    Returns ``(dpacked [B, N, W] float32, dshift [B, S, n_branches*C] or
    None)``; for bf16 ``packed``, dpacked is bf16 (the float32 sums rounded
    once), and dshift has ``shifts``' type.
    """
    B, S, K = idx.shape
    N, W = packed.shape[1], packed.shape[2]
    flat = idx.reshape(B, S * K).long()
    G = torch.gather(packed, 1, flat[..., None].expand(-1, -1, W))
    G = G.reshape(B, S, K, W).float()
    g = gctx.float()
    douts, dshifts = [], []
    for r in range(n_branches):
        E = G[..., 2 * r * c : (2 * r + 1) * c]
        V = G[..., (2 * r + 1) * c : (2 * r + 2) * c]
        if shifts is not None:
            V = V + shifts[:, :, None, r * c : (r + 1) * c].float()
        denom = _sum_over_neighbours(E)
        denom_f = torch.clamp_min(denom, _EPS)
        attn = E / denom_f - 1.0
        w = attn * V
        m = torch.amax(w, dim=2, keepdim=True)
        eq = (w == m).float()
        cnt = torch.sum(eq, dim=2, keepdim=True)
        dw = eq / cnt * g[:, :, None, r * c : (r + 1) * c]
        dV = dw * attn
        dattn = dw * V
        t = torch.sum(dattn * E, dim=2, keepdim=True)
        corr = torch.where(denom >= _EPS, t / (denom_f * denom_f), torch.zeros_like(t))
        dE = dattn / denom_f - corr
        douts += [dE, dV]
        if shifts is not None:
            dshifts.append(torch.sum(dV, dim=2))
    dG = torch.cat(douts, dim=-1).reshape(B, S * K, W)
    dpacked = stored(scatter_add_plain(dG, idx.reshape(B, S * K), N), packed)
    dshift = torch.cat(dshifts, dim=-1).to(shifts.dtype) if shifts is not None else None
    return dpacked, dshift


def check_args(packed, idx, shifts, n_branches, c) -> None:
    if packed.dim() != 3 or idx.dim() != 3 or packed.shape[0] != idx.shape[0]:
        raise ValueError(
            f"transition_attention: packed [B,N,W] and idx [B,S,K] expected, got "
            f"{tuple(packed.shape)}, {tuple(idx.shape)}"
        )
    if packed.shape[-1] != 2 * n_branches * c:
        raise ValueError(
            f"transition_attention: packed width {packed.shape[-1]} != 2*{n_branches}*{c}"
        )
    if shifts is not None and tuple(shifts.shape) != (idx.shape[0], idx.shape[1], n_branches * c):
        raise ValueError(f"transition_attention: shifts shape {tuple(shifts.shape)}")


def check_cuda_args(name, packed, idx, shifts, n_branches, c, gctx,
                    dtypes=(torch.float32,)) -> None:
    """The kernels' arguments: ``packed`` of one of ``dtypes``, and
    ``shifts`` and ``gctx`` of its type, contiguous on one CUDA device."""
    check_args(packed, idx, shifts, n_branches, c)
    K = idx.shape[2]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{name} supports 1 <= K <= {MAX_K}, got {K}")
    if packed.dtype not in dtypes:
        raise ValueError(f"{name}: packed must be {' or '.join(map(str, dtypes))}, "
                         f"got {packed.dtype}")
    named = [("packed", packed, packed.dtype), ("idx", idx, torch.int32)]
    if shifts is not None:
        named.append(("shifts", shifts, packed.dtype))
    if gctx is not None:
        if tuple(gctx.shape) != (idx.shape[0], idx.shape[1], n_branches * c):
            raise ValueError(f"{name}: gctx shape {tuple(gctx.shape)}")
        named.append(("gctx", gctx, packed.dtype))
    for arg, t, dt in named:
        if t.device != packed.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {dt} tensor on {packed.device}")
    if not library.kernel_device(packed):
        raise ValueError(f"{name}: tensors must lie on a CUDA device")


def attention_fwd_form(packed: torch.Tensor, shifts: Optional[torch.Tensor], K: int,
                       c: int) -> int:
    """``transition_attention_fwd_kernel``'s channels a thread: where ``K <=
    16`` (the rows a thread keeps in registers), the most of 16 bytes' worth
    (float32: 4, float4 loads of E, V and the shift and a float4 store; bf16:
    8, one 16-byte load of eight) and 4 (bf16: 8-byte loads) that divides
    ``c`` with ``packed`` and ``shifts`` starting on a boundary of that many
    values (their rows and branch offsets then do too); 1 for every other
    call. The kernel's entry refuses any other form."""
    es = packed.element_size()

    def aligned(vec: int) -> bool:
        return all(t is None or t.data_ptr() % (vec * es) == 0 for t in (packed, shifts))

    if K > 16:
        return 1
    return next((v for v in (16 // es, 4) if c % v == 0 and aligned(v)), 1)


def _attention_impl(packed: torch.Tensor, idx: torch.Tensor, shifts: Optional[torch.Tensor],
                    n_branches: int, c: int) -> torch.Tensor:
    """``mpa::attention`` on the card: launch ``transition_attention_fwd_kernel``
    with :func:`attention_fwd_form`'s channels a thread."""
    check_cuda_args("transition_attention_fwd_kernel", packed, idx, shifts, n_branches, c,
                    gctx=None, dtypes=KERNEL_DTYPES)
    B, N, _ = packed.shape
    S, K = idx.shape[1], idx.shape[2]
    vec = attention_fwd_form(packed, shifts, K, c)
    bf16 = packed.dtype == torch.bfloat16
    out = torch.empty((B, S, n_branches * c), dtype=packed.dtype, device=packed.device)
    lib = build.load()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_transition_attention_fwd(
                packed.data_ptr(), idx.data_ptr(),
                None if shifts is None else shifts.data_ptr(), out.data_ptr(),
                B, N, S, K, n_branches, c, vec, int(bf16), stream,
            ),
            f"transition_attention_fwd_kernel (K={K}, c={c}, {vec} channels a thread)",
        )
    kernels.launched(
        "transition_attention_fwd_kernel",
        {"packed": packed, "idx": idx, "shifts": shifts, "n_branches": n_branches, "c": c},
        bf16=bf16,
    )
    return out


def attention_fake(name: str, packed, idx, shifts, n_branches: int, c: int) -> torch.Tensor:
    """The forward ops' fake: the context ``[B, S, n_branches * c]`` in
    ``packed``'s type."""
    check_cuda_args(name, packed, idx, shifts, n_branches, c, gctx=None, dtypes=KERNEL_DTYPES)
    return packed.new_empty((packed.shape[0], idx.shape[1], n_branches * c))


attention_op = library.define(
    "attention(Tensor packed, Tensor idx, Tensor? shifts, int n_branches, int c) -> Tensor",
    _attention_impl, functools.partial(attention_fake, "transition_attention_fwd_kernel"))


def attention_cuda(
    packed: torch.Tensor,
    idx: torch.Tensor,
    shifts: Optional[torch.Tensor],
    n_branches: int,
    c: int,
) -> torch.Tensor:
    """``transition_attention_fwd_kernel`` on CUDA tensors (float32, or bf16
    ``packed`` and ``shifts`` for a bf16 context), through ``mpa::attention``."""
    library.check_device("transition_attention_fwd_kernel", packed, idx, shifts)
    return attention_op(packed, idx, shifts, n_branches, c)


def _attention_bwd_impl(packed, idx, shifts, gctx, n_branches: int, c: int):
    """``mpa::attention_bwd`` on the card: launch
    ``transition_attention_bwd_kernel``. For bf16 ``packed``, ``shifts`` and
    ``gctx`` the kernel adds into a float32 ``dpacked`` and rounds it into the
    bf16 one it returns."""
    check_cuda_args("transition_attention_bwd_kernel", packed, idx, shifts, n_branches, c, gctx,
                    dtypes=KERNEL_DTYPES)
    B, N, W = packed.shape
    S, K = idx.shape[1], idx.shape[2]
    bf16 = packed.dtype == torch.bfloat16
    acc = torch.empty((B, N, W), dtype=torch.float32, device=packed.device)
    dpacked = torch.empty_like(packed) if bf16 else acc
    dshift = None if shifts is None else torch.empty_like(shifts)
    lib = build.load()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_transition_attention_bwd(
                packed.data_ptr(), idx.data_ptr(),
                None if shifts is None else shifts.data_ptr(), gctx.data_ptr(),
                acc.data_ptr(), dpacked.data_ptr() if bf16 else None,
                None if dshift is None else dshift.data_ptr(),
                B, N, S, K, n_branches, c, int(bf16), stream,
            ),
            "transition_attention_bwd_kernel",
        )
    kernels.launched(
        "transition_attention_bwd_kernel",
        {"packed": packed, "idx": idx, "shifts": shifts, "gctx": gctx,
         "n_branches": n_branches, "c": c},
        bf16=bf16,
    )
    return dpacked, dshift


def attention_bwd_fake(name: str, packed, idx, shifts, gctx, n_branches: int, c: int):
    """The backward ops' fake: ``dpacked`` of ``packed``'s shape and type,
    ``dshift`` of ``shifts``' or None."""
    check_cuda_args(name, packed, idx, shifts, n_branches, c, gctx, dtypes=KERNEL_DTYPES)
    return torch.empty_like(packed), None if shifts is None else torch.empty_like(shifts)


attention_bwd_op = library.define(
    "attention_bwd(Tensor packed, Tensor idx, Tensor? shifts, Tensor gctx, int n_branches, "
    "int c) -> (Tensor, Tensor?)",
    _attention_bwd_impl, functools.partial(attention_bwd_fake, "transition_attention_bwd_kernel"))


def attention_bwd_cuda(
    packed: torch.Tensor,
    idx: torch.Tensor,
    shifts: Optional[torch.Tensor],
    gctx: torch.Tensor,
    n_branches: int,
    c: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``transition_attention_bwd_kernel`` on CUDA tensors, through
    ``mpa::attention_bwd``; returns ``(dpacked, dshift or None)`` as
    :func:`attention_bwd_plain`."""
    library.check_device("transition_attention_bwd_kernel", packed, idx, shifts, gctx)
    return attention_bwd_op(packed, idx, shifts, gctx, n_branches, c)


class _TransitionAttention(torch.autograd.Function):
    """``transition_attention_fwd_kernel`` forward,
    ``transition_attention_bwd_kernel`` backward (``attention_pallas.py``
    ``_attention_fwd`` / ``_attention_bwd``). Saves the node tensors, not
    the gathered edge rows."""

    @staticmethod
    def forward(ctx, packed, idx, shifts, n_branches: int, c: int):
        ctx.save_for_backward(packed, idx, shifts)
        ctx.n_branches, ctx.c = n_branches, c
        return attention_cuda(packed, idx, shifts, n_branches, c)

    @staticmethod
    @once_differentiable
    def backward(ctx, gctx):
        packed, idx, shifts = ctx.saved_tensors
        dpacked, dshift = attention_bwd_cuda(packed, idx, shifts,
                                             gctx.to(packed.dtype).contiguous(),
                                             ctx.n_branches, ctx.c)
        return dpacked, None, dshift, None, None


class _AttentionPlainBf16(torch.autograd.Function):
    """:func:`attention_plain` on bf16 CPU tensors, its backward
    :func:`attention_bwd_plain` (float32 sums, each output rounded once)."""

    @staticmethod
    def forward(ctx, packed, idx, shifts, n_branches: int, c: int):
        ctx.save_for_backward(packed, idx, shifts)
        ctx.n_branches, ctx.c = n_branches, c
        return attention_plain(packed, idx, shifts, n_branches, c)

    @staticmethod
    @once_differentiable
    def backward(ctx, gctx):
        packed, idx, shifts = ctx.saved_tensors
        dpacked, dshift = attention_bwd_plain(packed, idx, shifts, gctx, ctx.n_branches, ctx.c)
        return dpacked, None, dshift, None, None


def transition_attention(
    packed: torch.Tensor,
    idx: torch.Tensor,
    shifts: Optional[torch.Tensor],
    n_branches: int,
    c: int,
) -> torch.Tensor:
    """Fused multi-branch transition attention.

    Args:
      packed: ``[B, N, n_branches*2C]`` node tensors, branch r occupying
        channels ``[2rC, 2(r+1)C)`` as ``[E_r || V_r]``; E is positive.
      idx: ``[B, S, K]`` shared neighbour indices into the N axis.
      shifts: ``[B, S, n_branches*C]`` per-query additive value shifts, or
        None.
      n_branches / c: branch count and per-branch channel width.

    Returns ``[B, S, n_branches*C]`` contexts (branch-concatenated).
    """
    bf16 = packed.dtype == torch.bfloat16
    if bf16 and shifts is not None and shifts.dtype != packed.dtype:
        raise ValueError(f"transition_attention: bf16 packed needs bf16 shifts, got {shifts.dtype}")
    if on_cuda(packed, "packed"):
        store = torch.bfloat16 if bf16 else torch.float32
        args = (packed.to(store).contiguous(), idx.to(torch.int32).contiguous(),
                None if shifts is None else shifts.to(store).contiguous(), n_branches, c)
        if library.needs_grad(args[0], args[2]):
            return _TransitionAttention.apply(*args).to(packed.dtype)
        return attention_cuda(*args).to(packed.dtype)
    check_args(packed, idx, shifts, n_branches, c)
    if bf16:
        return _AttentionPlainBf16.apply(packed, idx, shifts, n_branches, c)
    return attention_plain(packed, idx, shifts, n_branches, c)
