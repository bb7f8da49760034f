"""NetVLAD pooling (counterpart of ``mpa_tpu/extras/netvlad.py``, the
reference's orphaned experiment).

Soft-assignment VLAD: per-point cluster logits (``clusters``, then ``bn1``),
a softmax over the clusters, the assignment-weighted sum of the points less
the assignment mass times the learned cluster centres
(``cluster_weights2``, a raw ``[1, C, K]`` parameter drawn from
``normal(1 / sqrt(C))`` by :meth:`NetVLAD.reset_flax_parameters`), flattened.
``SpatialPyramidNetVLAD`` projects it (``hidden``, ``bn2``) and gates it
(``GatingContext``: a sigmoid gate over the descriptor). Plain PyTorch: the
weighted sum is a product that ``mpa_tpu`` also takes outside any kernel.
Submodule names follow the flax modules; a BatchNorm replaces the bias of
the Linear ahead of it, as there.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from mpa_tpu_torch.nn.linear import BatchNorm


class GatingContext(nn.Module):
    """``x * sigmoid(bn(gating(x)))`` over the last axis of width ``dim``."""

    def __init__(self, dim: int, add_batch_norm: bool = True):
        super().__init__()
        self.gating = nn.Linear(dim, dim, bias=not add_batch_norm)
        self.bn = BatchNorm(dim) if add_batch_norm else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gates = self.gating(x)
        if self.bn is not None:
            gates = self.bn(gates)
        return x * torch.sigmoid(gates)


class NetVLAD(nn.Module):
    """x ``[B, N, feature_size]`` -> VLAD descriptor ``[B, feature_size *
    cluster_size]``."""

    def __init__(self, feature_size: int, cluster_size: int = 64, add_batch_norm: bool = True):
        super().__init__()
        self.clusters = nn.Linear(feature_size, cluster_size, bias=not add_batch_norm)
        self.bn1 = BatchNorm(cluster_size) if add_batch_norm else None
        self.cluster_weights2 = nn.Parameter(torch.empty(1, feature_size, cluster_size))
        self.reset_flax_parameters()

    def reset_flax_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """flax's ``normal(1 / sqrt(C))`` for the cluster centres, drawn on
        the CPU."""
        with torch.no_grad():
            std = 1.0 / math.sqrt(self.cluster_weights2.shape[1])
            self.cluster_weights2.copy_(
                torch.randn(self.cluster_weights2.shape, generator=generator) * std)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, C = x.shape
        logits = self.clusters(x)
        if self.bn1 is not None:
            logits = self.bn1(logits)
        assign = torch.softmax(logits, dim=-1)  # [B, N, K]
        a = torch.sum(assign, dim=1, keepdim=True) * self.cluster_weights2  # [B, C, K]
        vlad = torch.einsum("bnk,bnc->bck", assign, x) - a
        return vlad.reshape(B, C * assign.shape[-1])


class SpatialPyramidNetVLAD(nn.Module):
    """``vlad0`` -> ``hidden`` (no bias) -> ``bn2`` [-> ``context_gating``]:
    x ``[B, N, feature_size]`` -> ``[B, output_dim]``."""

    def __init__(self, feature_size: int, output_dim: int = 256, cluster_size: int = 64,
                 gating: bool = True, add_batch_norm: bool = True):
        super().__init__()
        self.vlad0 = NetVLAD(feature_size, cluster_size, add_batch_norm)
        self.hidden = nn.Linear(feature_size * cluster_size, output_dim, bias=False)
        self.bn2 = BatchNorm(output_dim)
        self.context_gating = GatingContext(output_dim, add_batch_norm) if gating else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        v = self.bn2(self.hidden(self.vlad0(x)))
        if self.context_gating is not None:
            v = self.context_gating(v)
        return v
