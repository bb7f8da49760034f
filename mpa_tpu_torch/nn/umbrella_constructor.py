"""Umbrella RepSurf surface feature constructor.

Counterpart of ``mpa_tpu/nn/umbrella_constructor.py::UmbrellaSurfaceConstructor``:
umbrella triangle fans around every point, per triangle (centroid[3],
polar[3], normal[3], plane offset[1]) = 10 channels, a shared three-layer
MLP over the channel-last ``[B, N, G, C]`` tensor (``mlp0`` without a bias,
BatchNorm and ReLU after the first two layers), then a sum, max or mean over
the k - 1 triangles. BatchNorm statistics reduce over (B, N, G), as there.
Submodule names follow the flax module.

``k`` (9: the point and its 8 nearest, 8 triangles a fan), ``channels``
(the MLP's width, 10), ``aggr_type``, ``return_dist`` (the plane offset
among the triangle's channels, 10 of them; without it 9) and
``random_inv`` (the train-time inversion) are ``mpa_tpu``'s fields, with
its defaults. With ``random_inv``, in train mode each cloud's normals are
flipped by a sign that the caller gives (``flips``, ``[B]`` of +1 or -1)
or that is drawn from the caller's ``generator``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.geometry import (
    cal_center,
    cal_const,
    cal_normal,
    check_nan_umbrella,
    group_by_umbrella,
    random_flips,
    xyz2sphere,
)
from mpa_tpu_torch.nn.linear import BatchNorm


class UmbrellaSurfaceConstructor(nn.Module):
    """``mpa_tpu``'s constructor: fans of ``k - 1`` triangles, a three-layer
    MLP of width ``channels``, ``aggr_type`` over the fan."""

    def __init__(self, k: int = 9, channels: int = 10, aggr_type: str = "sum",
                 return_dist: bool = True, random_inv: bool = True):
        super().__init__()
        if aggr_type not in ("sum", "max", "avg"):
            raise ValueError(f"aggr_type={aggr_type!r} must be 'sum', 'max' or 'avg'")
        self.k, self.aggr_type = k, aggr_type
        self.return_dist, self.random_inv = return_dist, random_inv
        # centroid 3, polar 3, normal 3 (and plane offset 1)
        c_in = 10 if return_dist else 9
        self.mlp0 = nn.Linear(c_in, channels, bias=False)
        self.bn0 = BatchNorm(channels)
        self.mlp1 = nn.Linear(channels, channels)
        self.bn1 = BatchNorm(channels)
        self.mlp2 = nn.Linear(channels, channels)

    def forward(self, center: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                flips: Optional[torch.Tensor] = None) -> torch.Tensor:
        """center: ``[B, N, 3]`` -> ``[B, N, channels]`` surface features.

        In train mode with ``random_inv``, ``flips`` (``[B]`` signs) or, when
        it is None, ``generator`` (on ``center``'s device) decides each
        cloud's inversion; one of them is required there.
        """
        group_xyz = group_by_umbrella(center, center, k=self.k)  # [B, N, G, 3, 3]
        if self.training and self.random_inv:
            if flips is None:
                if generator is None:
                    raise ValueError("train-mode normal inversion needs flips or a torch.Generator")
                flips = random_flips(center.shape[0], generator, center.device)
        else:
            flips = None
        group_normal = cal_normal(group_xyz, flips=flips, is_group=True)
        group_center = cal_center(group_xyz)
        group_polar = xyz2sphere(group_center)
        if self.return_dist:
            group_pos = cal_const(group_normal, group_center)
            group_normal, group_center, group_pos = check_nan_umbrella(
                group_normal, group_center, group_pos)
            feat = torch.cat([group_center, group_polar, group_normal, group_pos], dim=-1)
        else:
            group_normal, group_center = check_nan_umbrella(group_normal, group_center)
            feat = torch.cat([group_center, group_polar, group_normal], dim=-1)

        feat = F.relu(self.bn0(self.mlp0(feat)))
        feat = F.relu(self.bn1(self.mlp1(feat)))
        feat = self.mlp2(feat)
        if self.aggr_type == "max":
            return torch.amax(feat, dim=2)
        if self.aggr_type == "avg":
            return torch.mean(feat, dim=2)
        return torch.sum(feat, dim=2)
