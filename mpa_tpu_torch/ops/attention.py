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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from torch.autograd.function import once_differentiable

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.ops.gather import scatter_add_plain
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
    None)``.
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
    dpacked = scatter_add_plain(dG, idx.reshape(B, S * K), N)
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


def check_cuda_args(name, packed, idx, shifts, n_branches, c, gctx) -> None:
    check_args(packed, idx, shifts, n_branches, c)
    K = idx.shape[2]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"{name} supports 1 <= K <= {MAX_K}, got {K}")
    named = [("packed", packed, torch.float32), ("idx", idx, torch.int32)]
    if shifts is not None:
        named.append(("shifts", shifts, torch.float32))
    if gctx is not None:
        if tuple(gctx.shape) != (idx.shape[0], idx.shape[1], n_branches * c):
            raise ValueError(f"{name}: gctx shape {tuple(gctx.shape)}")
        named.append(("gctx", gctx, torch.float32))
    for arg, t, dt in named:
        if t.device != packed.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be a contiguous {dt} tensor on {packed.device}")
    if packed.device.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on a CUDA device")


def attention_fwd_form(packed: torch.Tensor, shifts: Optional[torch.Tensor], K: int,
                       c: int) -> int:
    """``transition_attention_fwd_kernel``'s channels a thread: 4 (float4
    loads of E, V and the shift, a float4 store) where ``c % 4 == 0``, ``K <=
    16`` (the K float4 pairs a thread keeps in registers) and ``packed`` and
    ``shifts`` start on a 16-byte boundary (their rows and branch offsets
    then do too); 1 for every other call. The kernel's entry refuses 4
    where it does not hold."""
    aligned = packed.data_ptr() % 16 == 0 and (shifts is None or shifts.data_ptr() % 16 == 0)
    return 4 if c % 4 == 0 and K <= 16 and aligned else 1


def attention_cuda(
    packed: torch.Tensor,
    idx: torch.Tensor,
    shifts: Optional[torch.Tensor],
    n_branches: int,
    c: int,
) -> torch.Tensor:
    """Launch ``transition_attention_fwd_kernel`` on CUDA tensors, with
    :func:`attention_fwd_form`'s channels a thread."""
    check_cuda_args("transition_attention_fwd_kernel", packed, idx, shifts, n_branches, c,
                gctx=None)
    B, N, _ = packed.shape
    S, K = idx.shape[1], idx.shape[2]
    vec = attention_fwd_form(packed, shifts, K, c)
    out = torch.empty((B, S, n_branches * c), dtype=torch.float32, device=packed.device)
    lib = build.load()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_transition_attention_fwd(
                packed.data_ptr(), idx.data_ptr(),
                None if shifts is None else shifts.data_ptr(), out.data_ptr(),
                B, N, S, K, n_branches, c, vec, stream,
            ),
            f"transition_attention_fwd_kernel (K={K}, c={c}, {vec} channels a thread)",
        )
    kernels.launched(
        "transition_attention_fwd_kernel",
        {"packed": packed, "idx": idx, "shifts": shifts, "n_branches": n_branches, "c": c},
    )
    return out


def attention_bwd_cuda(
    packed: torch.Tensor,
    idx: torch.Tensor,
    shifts: Optional[torch.Tensor],
    gctx: torch.Tensor,
    n_branches: int,
    c: int,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch ``transition_attention_bwd_kernel`` on CUDA tensors; returns
    ``(dpacked, dshift or None)`` as :func:`attention_bwd_plain`."""
    check_cuda_args("transition_attention_bwd_kernel", packed, idx, shifts, n_branches, c, gctx)
    B, N, W = packed.shape
    S, K = idx.shape[1], idx.shape[2]
    dpacked = torch.empty((B, N, W), dtype=torch.float32, device=packed.device)
    dshift = None if shifts is None else torch.empty_like(shifts)
    lib = build.load()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_transition_attention_bwd(
                packed.data_ptr(), idx.data_ptr(),
                None if shifts is None else shifts.data_ptr(), gctx.data_ptr(),
                dpacked.data_ptr(), None if dshift is None else dshift.data_ptr(),
                B, N, S, K, n_branches, c, stream,
            ),
            "transition_attention_bwd_kernel",
        )
    kernels.launched(
        "transition_attention_bwd_kernel",
        {"packed": packed, "idx": idx, "shifts": shifts, "gctx": gctx,
         "n_branches": n_branches, "c": c},
    )
    return dpacked, dshift


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
        dpacked, dshift = attention_bwd_cuda(packed, idx, shifts, gctx.float().contiguous(),
                                             ctx.n_branches, ctx.c)
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
    if on_cuda(packed, "packed"):
        out = _TransitionAttention.apply(
            packed.float().contiguous(),
            idx.to(torch.int32).contiguous(),
            None if shifts is None else shifts.float().contiguous(),
            n_branches,
            c,
        )
        return out.to(packed.dtype)
    check_args(packed, idx, shifts, n_branches, c)
    return attention_plain(packed, idx, shifts, n_branches, c)
