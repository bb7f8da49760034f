"""PointNet++-style set abstraction of the RepSurf-SSG-2x path.

Counterpart of ``sample_and_group``, ``sample_and_group_all``,
``_ConvBnStack`` and ``SurfaceAbstractionCD`` in
``mpa_tpu/nn/surface_abstraction.py``. The 1x1 convolutions are Linear
layers over the channel-last ``[B, S, K, C]`` groups; BatchNorm reduces over
(B, S, K). The grouped first layer runs one Linear over the position
channels (offsets, and their polar form) and one over the rest (normals and
features), each with its own BatchNorm, sums them, then ReLU; the shared
stack follows and a max over the K neighbours ends the stage
(``torch.amax``, whose gradient, like ``jnp.max``'s, is split evenly among
tied maxima: a backfilled ball repeats a point, and every copy ties).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.geometry import xyz2sphere
from mpa_tpu_torch.nn.linear import BatchNorm
from mpa_tpu_torch.ops.ball_query import ball_query
from mpa_tpu_torch.ops.fps import farthest_point_sample
from mpa_tpu_torch.ops.gather import index_points

POS_CHANNELS = 6  # a group's offsets to its centre and their (rho, theta, phi)


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    center: torch.Tensor,
    normal: torch.Tensor,
    feature: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FPS, the centres' and normals' gather, ball-query groups, and the
    grouped channels concatenated: the offsets to the centre and their polar
    form (6), the normals, the features.

    center ``[B, N, 3]``, normal ``[B, N, Cn]``, feature ``[B, N, Cf]`` or
    None -> (new_center ``[B, S, 3]``, new_normal ``[B, S, Cn]``, grouped
    ``[B, S, K, 6 + Cn (+ Cf)]``).
    """
    fps_idx = farthest_point_sample(center, npoint)
    new_center = index_points(center, fps_idx)
    new_normal = index_points(normal, fps_idx)

    idx = ball_query(radius, nsample, center, new_center)
    group_normal = index_points(normal, idx)
    group_center = index_points(center, idx) - new_center[:, :, None, :]
    parts = [group_center, xyz2sphere(group_center), group_normal]
    if feature is not None:
        parts.append(index_points(feature, idx))
    return new_center, new_normal, torch.cat(parts, dim=-1)


def sample_and_group_all(
    center: torch.Tensor, normal: torch.Tensor, feature: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole cloud as one group about the origin, channels as
    :func:`sample_and_group`'s."""
    B = center.shape[0]
    new_center = torch.zeros((B, 1, 3), dtype=center.dtype, device=center.device)
    group_center = center[:, None, :, :]
    parts = [group_center, xyz2sphere(group_center), normal[:, None, :, :]]
    if feature is not None:
        parts.append(feature[:, None, :, :])
    return new_center, new_center, torch.cat(parts, dim=-1)


class _ConvBnStack(nn.Module):
    """Linear -> BatchNorm -> ReLU per width (submodules ``conv{i}``,
    ``bn{i}``)."""

    def __init__(self, in_channels: int, mlp: Sequence[int]):
        super().__init__()
        self.depth = len(mlp)
        for i, c in enumerate(mlp):
            setattr(self, f"conv{i}", nn.Linear(in_channels, c))
            setattr(self, f"bn{i}", BatchNorm(c))
            in_channels = c

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.depth):
            x = F.relu(getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x)))
        return x


class SurfaceAbstractionCD(nn.Module):
    """Centre/dual-input set abstraction, with the polar position channels
    and the normals (``mpa_tpu``'s ``return_polar=True``,
    ``return_normal=True``, the only form ``repsurf_ssg_2x`` runs).

    Args:
      npoint, radius, nsample: the FPS size and the ball (unused with
        ``group_all``).
      in_channel: the non-position channels of a group (normals and
        features).
      mlp: the widths; the first is the two first-layer Linears'.
    """

    def __init__(self, npoint: int, radius: float, nsample: int, in_channel: int,
                 mlp: Sequence[int], group_all: bool = False):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all = group_all
        self.mlp_l0 = nn.Linear(POS_CHANNELS, mlp[0])
        self.bn_l0 = BatchNorm(mlp[0])
        self.mlp_f0 = nn.Linear(in_channel, mlp[0])
        self.bn_f0 = BatchNorm(mlp[0])
        self.mlps = _ConvBnStack(mlp[0], tuple(mlp[1:]))

    def forward(self, center: torch.Tensor, normal: torch.Tensor,
                feature: Optional[torch.Tensor]):
        """-> (new_center ``[B, S, 3]``, new_normal, features ``[B, S, mlp[-1]]``)."""
        if self.group_all:
            new_center, new_normal, grouped = sample_and_group_all(center, normal, feature)
        else:
            new_center, new_normal, grouped = sample_and_group(
                self.npoint, self.radius, self.nsample, center, normal, feature)
        pos, feat = grouped[..., :POS_CHANNELS], grouped[..., POS_CHANNELS:]
        x = F.relu(self.bn_l0(self.mlp_l0(pos)) + self.bn_f0(self.mlp_f0(feat)))
        x = self.mlps(x)
        return new_center, new_normal, torch.amax(x, dim=2)
