"""Fused multi-branch transition attention, forward.

Counterpart of ``mpa_tpu/ops/pallas/attention_pallas.py::transition_attention``.
On a CUDA tensor it launches ``transition_attention_fwd_kernel``
(``kernels/csrc/attention.cu``), which gathers the neighbour rows itself; on
a CPU tensor it takes :func:`attention_plain`. Forward only: the backward
kernels belong to the training slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from mpa_tpu_torch import kernels
from mpa_tpu_torch.kernels import build
from mpa_tpu_torch.utils.device import on_cuda

# Guard for an all-underflowed exp-sum denominator; above the f32 subnormal
# range so it does not flush to 0 (attention_pallas.py _EPS).
_EPS = 1e-20
MAX_K = 64


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
        denom = torch.sum(E, dim=2, keepdim=True)
        attn = E / torch.clamp_min(denom, _EPS) - 1.0
        outs.append(torch.amax(attn * V, dim=2))
    return torch.cat(outs, dim=-1).to(packed.dtype)


def _check(packed, idx, shifts, n_branches, c) -> None:
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


def attention_cuda(
    packed: torch.Tensor,
    idx: torch.Tensor,
    shifts: Optional[torch.Tensor],
    n_branches: int,
    c: int,
) -> torch.Tensor:
    """Launch ``transition_attention_fwd_kernel`` on CUDA tensors."""
    _check(packed, idx, shifts, n_branches, c)
    B, N, _ = packed.shape
    S, K = idx.shape[1], idx.shape[2]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"transition_attention_fwd_kernel supports 1 <= K <= {MAX_K}, got {K}")
    named = [("packed", packed, torch.float32), ("idx", idx, torch.int32)]
    if shifts is not None:
        named.append(("shifts", shifts, torch.float32))
    for name, t, dt in named:
        if t.device != packed.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"transition_attention_fwd_kernel: {name} must be a contiguous {dt} "
                f"tensor on {packed.device}"
            )
    if packed.device.type != "cuda":
        raise ValueError("transition_attention_fwd_kernel: tensors must lie on a CUDA device")
    out = torch.empty((B, S, n_branches * c), dtype=torch.float32, device=packed.device)
    lib = build.load()
    with torch.cuda.device(packed.device):
        stream = torch.cuda.current_stream().cuda_stream
        build.check(
            lib.mpa_transition_attention_fwd(
                packed.data_ptr(), idx.data_ptr(),
                None if shifts is None else shifts.data_ptr(), out.data_ptr(),
                B, N, S, K, n_branches, c, stream,
            ),
            "transition_attention_fwd_kernel",
        )
    kernels.launched(
        "transition_attention_fwd_kernel",
        {"packed": packed, "idx": idx, "shifts": shifts, "n_branches": n_branches, "c": c},
    )
    return out


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
        out = attention_cuda(
            packed.float().contiguous(),
            idx.to(torch.int32).contiguous(),
            None if shifts is None else shifts.float().contiguous(),
            n_branches,
            c,
        )
        return out.to(packed.dtype)
    _check(packed, idx, shifts, n_branches, c)
    return attention_plain(packed, idx, shifts, n_branches, c)
