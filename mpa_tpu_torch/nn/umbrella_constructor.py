"""Umbrella RepSurf surface feature constructor.

Counterpart of ``mpa_tpu/nn/umbrella_constructor.py::UmbrellaSurfaceConstructor``:
umbrella triangle fans around every point, per triangle (centroid[3],
polar[3], normal[3], plane offset[1]) = 10 channels, a shared three-layer
MLP over the channel-last ``[B, N, G, C]`` tensor (``mlp0`` without a bias,
BatchNorm and ReLU after the first two layers), then a sum, max or mean over
the k - 1 triangles. BatchNorm statistics reduce over (B, N, G), as there.
Submodule names follow the flax module.

Every ``mpa_tpu`` model builds it with k = 9 and the train-time inversion
on, so both are fixed here: in train mode each cloud's normals are flipped
by a sign that the caller gives (``flips``, ``[B]`` of +1 or -1) or that is
drawn from the caller's ``generator``.
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


UMBRELLA_CHANNELS = 10  # centroid 3, polar 3, normal 3, plane offset 1
UMBRELLA_K = 9  # the point and its 8 nearest: 8 triangles a fan


class UmbrellaSurfaceConstructor(nn.Module):
    """``mpa_tpu``'s constructor with ``return_dist=True`` and 10 channels
    in and out, the form every ``mpa_tpu`` model builds."""

    def __init__(self, aggr_type: str = "sum"):
        super().__init__()
        if aggr_type not in ("sum", "max", "avg"):
            raise ValueError(f"aggr_type={aggr_type!r} must be 'sum', 'max' or 'avg'")
        self.aggr_type = aggr_type
        c = UMBRELLA_CHANNELS
        self.mlp0 = nn.Linear(c, c, bias=False)
        self.bn0 = BatchNorm(c)
        self.mlp1 = nn.Linear(c, c)
        self.bn1 = BatchNorm(c)
        self.mlp2 = nn.Linear(c, c)

    def forward(self, center: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                flips: Optional[torch.Tensor] = None) -> torch.Tensor:
        """center: ``[B, N, 3]`` -> ``[B, N, 10]`` surface features.

        In train mode ``flips`` (``[B]`` signs) or, when it is None,
        ``generator`` (on ``center``'s device) decides each cloud's
        inversion; one of them is required there.
        """
        group_xyz = group_by_umbrella(center, center, k=UMBRELLA_K)  # [B, N, G, 3, 3]
        if self.training:
            if flips is None:
                if generator is None:
                    raise ValueError("train-mode normal inversion needs flips or a torch.Generator")
                flips = random_flips(center.shape[0], generator, center.device)
        else:
            flips = None
        group_normal = cal_normal(group_xyz, flips=flips, is_group=True)
        group_center = cal_center(group_xyz)
        group_polar = xyz2sphere(group_center)
        group_pos = cal_const(group_normal, group_center)
        group_normal, group_center, group_pos = check_nan_umbrella(
            group_normal, group_center, group_pos)
        feat = torch.cat([group_center, group_polar, group_normal, group_pos], dim=-1)

        feat = F.relu(self.bn0(self.mlp0(feat)))
        feat = F.relu(self.bn1(self.mlp1(feat)))
        feat = self.mlp2(feat)
        if self.aggr_type == "max":
            return torch.amax(feat, dim=2)
        if self.aggr_type == "avg":
            return torch.mean(feat, dim=2)
        return torch.sum(feat, dim=2)
