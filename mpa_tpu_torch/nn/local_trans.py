"""Difference-wise local attention, the paper's "probability transition".

Counterpart of ``mpa_tpu/nn/local_trans.py::LocalTrans``, in its folded form:
the softmax over neighbours of ``(q_i - k_j)/sqrt(C)`` depends on the
neighbour only through ``E_j = exp(-(W_k x_j)/sqrt(C) - stab)``, computed once
per source point; in xyz mode the value projection of ``x_j - x_i`` splits
into a gathered node term ``v(x_j)`` and a per-query shift ``b_v - v(x_i)``.
``node_pack`` / ``value_shift`` / ``ffn_out`` are separate so that LocalMerge
can pack branches that share one kNN index into one attention call. Given a
``window_spec`` (an index from the windowed kNN), the attention is the
windowed one (``ops/window.py``), the same function.

``use_tanh`` is ``mpa_tpu``'s edge-level path (``local_trans.py:109-125``):
``tanh(q(center) - k(neighbour)) / K`` weights the neighbours' values,
summed over K, on gathered rows (``index_points``, the row gather), with
the ``q`` projection live; in xyz mode k and v act on the centre-relative
deltas. It does not fold and takes no window spec, as in ``mpa_tpu``.

``dtype`` (``torch.bfloat16``) is ``mpa_tpu``'s mixed precision
(``local_trans.py:71-95``): q, k and v are bf16 Dense layers
(``nn/linear.py::dense``), ``node_pack`` takes the softmax numerator and its
stabiliser in float32 and packs ``[E || V]`` in bf16, the value shift and
the residual add are bf16, and the LinearUnits take the same ``dtype``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mpa_tpu_torch.nn.linear import LinearUnit, dense, dense_bias
from mpa_tpu_torch.ops.attention import transition_attention
from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.ops.window import windowed_transition_attention


class LocalTrans(nn.Module):
    """One difference-attention transition from a source set to centre points.

    Call args:
      source: ``[B, N, C_in]`` neighbour source set (xyz or features).
      center: ``[B, S, C_in]`` centre features (already gathered to the
        target scale).
      idx: ``[B, S, K]`` neighbour indices into the source set.
      xyz_mode: geometric mode (k/v act on centre-relative deltas).
    """

    def __init__(self, in_channels: int, out_channels: int, num_neighbors: int,
                 residual_proj: bool = False, use_tanh: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.use_tanh = use_tanh
        self.out_channels = out_channels
        self.num_neighbors = num_neighbors
        # q takes no part in the folded output; it exists so every checkpoint
        # leaf has a home (the tanh path reads it).
        self.q = nn.Linear(in_channels, out_channels)
        self.k = nn.Linear(in_channels, out_channels)
        self.v = nn.Linear(in_channels, out_channels)
        self.conv_res = (LinearUnit(in_channels, out_channels, dtype=dtype) if residual_proj
                         else None)
        self.ffn = LinearUnit(out_channels, out_channels, dtype=dtype)

    def node_pack(self, source: torch.Tensor) -> torch.Tensor:
        """``[B, N, 2C]`` = ``[E || v(source)]``, ``E = exp(-(W_k x)/sqrt(C) - stab)``
        with ``stab`` the (detached) max over N per batch and channel."""
        k_src = dense(self.k, source, self.dtype)
        v_src = dense(self.v, source, self.dtype)
        neg = -k_src.float() / math.sqrt(float(self.out_channels))
        stab = torch.amax(neg, dim=1, keepdim=True).detach()
        e_src = torch.exp(neg - stab).to(v_src.dtype)
        return torch.cat([e_src, v_src], dim=-1)

    def value_shift(self, center: torch.Tensor) -> torch.Tensor:
        """xyz-mode per-query value shift ``b_v - v(center)``."""
        return dense_bias(self.v, self.dtype) - dense(self.v, center, self.dtype)

    def ffn_out(self, context: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
        """Residual + FFN head on a precomputed attention context."""
        residual = center if self.conv_res is None else self.conv_res(center)
        return residual + self.ffn(context)

    def forward(self, source, center, idx, *, xyz_mode: bool = False,
                window_spec=None) -> torch.Tensor:
        if self.use_tanh:
            return self.ffn_out(self.tanh_context(source, center, idx, xyz_mode), center)
        packed = self.node_pack(source)
        shifts = self.value_shift(center) if xyz_mode else None
        if window_spec is not None:
            context = windowed_transition_attention(packed, idx, shifts, 1, self.out_channels,
                                                    window_spec)
        else:
            context = transition_attention(packed, idx, shifts, 1, self.out_channels)
        return self.ffn_out(context, center)

    def tanh_context(self, source, center, idx, xyz_mode: bool) -> torch.Tensor:
        """The edge-level context ``sum_K tanh(q(center) - key) / K * value``."""
        def k(t):
            return dense(self.k, t, self.dtype)

        def v(t):
            return dense(self.v, t, self.dtype)

        if xyz_mode:
            neigh = index_points(source, idx) - center[:, :, None, :]
            key, value = k(neigh), v(neigh)
        else:
            key, value = index_points(k(source), idx), index_points(v(source), idx)
        query = dense(self.q, center, self.dtype)
        attn = torch.tanh(query[:, :, None, :] - key) / self.num_neighbors
        return torch.sum(attn * value, dim=2)
