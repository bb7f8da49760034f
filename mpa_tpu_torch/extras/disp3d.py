"""Displacement-kernel convolutions (counterpart of
``mpa_tpu/extras/disp3d.py``, the reference's orphaned experiment).

``Operator3D``: learned 3D displacement directions score each neighbour
offset (ReLU of the dot product), a max over the neighbours per (support,
kernel), a weighted sum over the supports. ``OperatorND``: its feature-map
form; each point's features project to (support + 1) x out channels
(``weights``, a Linear), the support channels are gathered to the
neighbours, gated by the displacement scores, maxed over the neighbours
and summed with the centre term. ``NeighborPooling``: a max over the
neighbours. ``Disp3DEncoder``: the stacked encoder, on one self-kNN of the
points (``knn``: ``knn_kernel`` on the card) and its gathers
(``gather_rows_kernel``).

The displacement directions and ``Operator3D``'s support weights are raw
parameters, kept as ``mpa_tpu`` keeps them, drawn from ``[0, 2 stdv)`` and
shifted by ``-stdv`` where they are used (``stdv = 1 / sqrt(support x
out)``); :meth:`reset_flax_parameters` draws them as ``mpa_tpu``'s
initialisers do, and ``utils/convert.py`` carries ``mpa_tpu``'s leaves
over as they are. Every max is ``torch.amax`` (a tie's gradient split
evenly, as ``jnp.max``'s).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.ops.knn import knn


def _neighbor_displacement(vertices: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return index_points(vertices, idx) - vertices[:, :, None, :]  # [B, N, K, 3]


def _uniform_(p: torch.Tensor, scale: float, generator: Optional[torch.Generator]) -> None:
    """flax's ``uniform(scale)``: U[0, scale), drawn on the CPU."""
    with torch.no_grad():
        p.copy_(torch.rand(p.shape, generator=generator) * scale)


class Operator3D(nn.Module):
    """Displacement kernels on the neighbours' offsets: idx ``[B, N, K]``,
    vertices ``[B, N, 3]`` -> ``[B, N, kernel_num]``."""

    def __init__(self, kernel_num: int, support_num: int):
        super().__init__()
        self.kernel_num, self.support_num = kernel_num, support_num
        self.stdv = 1.0 / math.sqrt(support_num * kernel_num)
        self.displacement = nn.Parameter(torch.empty(3, support_num * kernel_num))
        self.weights = nn.Parameter(torch.empty(1, 1, support_num, kernel_num))
        self.reset_flax_parameters()

    def reset_flax_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _uniform_(self.displacement, 2 * self.stdv, generator)
        _uniform_(self.weights, 2 * self.stdv, generator)

    def forward(self, neighbor_index: torch.Tensor, vertices: torch.Tensor) -> torch.Tensor:
        B, N, K = neighbor_index.shape
        disp, weights = self.displacement - self.stdv, self.weights - self.stdv
        nd = _neighbor_displacement(vertices, neighbor_index)
        theta = F.relu(nd @ disp).reshape(B, N, K, self.support_num, self.kernel_num)
        return torch.sum(torch.amax(theta, dim=2) * weights, dim=2)


class OperatorND(nn.Module):
    """Displacement-gated feature convolution: idx ``[B, N, K]``, vertices
    ``[B, N, 3]``, features ``[B, N, in_channel]`` -> ``[B, N,
    out_channel]``."""

    def __init__(self, in_channel: int, out_channel: int, support_num: int):
        super().__init__()
        self.out_channel, self.support_num = out_channel, support_num
        self.stdv = 1.0 / math.sqrt(out_channel * (support_num + 1))
        self.displacement = nn.Parameter(torch.empty(3, support_num * out_channel))
        self.weights = nn.Linear(in_channel, (support_num + 1) * out_channel)
        self.reset_flax_parameters()

    def reset_flax_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _uniform_(self.displacement, 2 * self.stdv, generator)

    def forward(self, neighbor_index: torch.Tensor, vertices: torch.Tensor,
                feature_map: torch.Tensor) -> torch.Tensor:
        B, N, K = neighbor_index.shape
        s, o = self.support_num, self.out_channel
        nd = _neighbor_displacement(vertices, neighbor_index)
        theta = F.relu(nd @ (self.displacement - self.stdv))  # [B, N, K, s*o]
        fout = self.weights(feature_map)
        centre, support = fout[..., :o], fout[..., o:]
        support = index_points(support, neighbor_index)  # [B, N, K, s*o]
        act = (theta * support).reshape(B, N, K, s, o)
        return centre + torch.sum(torch.amax(act, dim=2), dim=2)


class NeighborPooling(nn.Module):
    """A max over each point's K neighbours: idx ``[B, N, K]``, features
    ``[B, N, C]`` -> ``[B, N, C]``."""

    def forward(self, neighbor_index: torch.Tensor, feature_map: torch.Tensor) -> torch.Tensor:
        return torch.amax(index_points(feature_map, neighbor_index), dim=2)


class Disp3DEncoder(nn.Module):
    """The stacked displacement encoder: ``op0`` (``Operator3D``), then per
    later width a ReLU, ``op{i}`` (``OperatorND``) and ``pool{i}``, all on the
    self-kNN of the points (k = ``k``, the point itself among them):
    vertices ``[B, N, 3]`` -> ``[B, N, widths[-1]]``."""

    def __init__(self, widths: Sequence[int] = (32, 64, 128), support_num: int = 1, k: int = 16):
        super().__init__()
        self.k, self.depth = k, len(widths) - 1
        self.op0 = Operator3D(widths[0], support_num)
        for i, w in enumerate(widths[1:]):
            setattr(self, f"op{i + 1}", OperatorND(widths[i], w, support_num))
            setattr(self, f"pool{i + 1}", NeighborPooling())

    def forward(self, vertices: torch.Tensor) -> torch.Tensor:
        vd = vertices.detach()
        _, idx = knn(self.k, vd, vd)
        x = self.op0(idx, vertices)
        for i in range(1, self.depth + 1):
            x = getattr(self, f"op{i}")(idx, vertices, F.relu(x))
            x = getattr(self, f"pool{i}")(idx, x)
        return x
