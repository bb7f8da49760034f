"""PointNet++-style set abstraction of the RepSurf-SSG-2x path, and the
plain one.

Counterpart of ``mpa_tpu/nn/surface_abstraction.py`` (``sample_and_group``,
``sample_and_group_all``, ``_ConvBnStack``, ``SurfaceAbstraction`` and
``SurfaceAbstractionCD``). The 1x1 convolutions are Linear layers over the
channel-last ``[B, S, K, C]`` groups; BatchNorm reduces over (B, S, K). The
grouped first layer of ``SurfaceAbstractionCD`` runs one Linear over the
position channels (offsets, and their polar form) and one over the rest
(normals and features), each with its own BatchNorm, sums them, then ReLU;
the shared stack follows and a max over the K neighbours ends the stage
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


def sample_and_group(
    npoint: int,
    radius: float,
    nsample: int,
    center: torch.Tensor,
    normal: torch.Tensor,
    feature: Optional[torch.Tensor],
    *,
    return_normal: bool = True,
    return_polar: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FPS, the centres' and normals' gather, ball-query groups, and the
    grouped channels concatenated: the offsets to the centre (and, with
    ``return_polar``, their polar form: 6 in all), the normals (with
    ``return_normal``, and always where there are no features, as in
    ``mpa_tpu``), the features.

    center ``[B, N, 3]``, normal ``[B, N, Cn]``, feature ``[B, N, Cf]`` or
    None -> (new_center ``[B, S, 3]``, new_normal ``[B, S, Cn]``, grouped
    ``[B, S, K, C]``).
    """
    fps_idx = farthest_point_sample(center, npoint)
    new_center = index_points(center, fps_idx)
    new_normal = index_points(normal, fps_idx)

    idx = ball_query(radius, nsample, center, new_center)
    group_normal = index_points(normal, idx)
    group_center = index_points(center, idx) - new_center[:, :, None, :]
    parts = [group_center] + ([xyz2sphere(group_center)] if return_polar else [])
    if feature is None or return_normal:
        parts.append(group_normal)
    if feature is not None:
        parts.append(index_points(feature, idx))
    return new_center, new_normal, torch.cat(parts, dim=-1)


def sample_and_group_all(
    center: torch.Tensor, normal: torch.Tensor, feature: Optional[torch.Tensor], *,
    return_normal: bool = True, return_polar: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The whole cloud as one group about the origin: the coordinates (and
    their polar form), the normals where ``return_normal`` (here, as in
    ``mpa_tpu``, not also where there are no features), the features."""
    B = center.shape[0]
    new_center = torch.zeros((B, 1, 3), dtype=center.dtype, device=center.device)
    group_center = center[:, None, :, :]
    parts = [group_center] + ([xyz2sphere(group_center)] if return_polar else [])
    if return_normal:
        parts.append(normal[:, None, :, :])
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


class _Grouping(nn.Module):
    """The grouping both set abstractions share, and its channel count."""

    def __init__(self, npoint: int, radius: float, nsample: int, group_all: bool,
                 return_polar: bool, return_normal: bool):
        super().__init__()
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.group_all, self.return_polar, self.return_normal = (
            group_all, return_polar, return_normal)
        self.pos_width = 6 if return_polar else 3

    def group(self, center: torch.Tensor, normal: torch.Tensor,
              feature: Optional[torch.Tensor]):
        kw = dict(return_normal=self.return_normal, return_polar=self.return_polar)
        if self.group_all:
            return sample_and_group_all(center, normal, feature, **kw)
        return sample_and_group(self.npoint, self.radius, self.nsample, center, normal,
                                feature, **kw)


class SurfaceAbstraction(_Grouping):
    """The plain PointNet++ set abstraction (``mpa_tpu``'s
    ``SurfaceAbstraction``, which no model builds): the groups, the shared
    stack ``mlps`` over all their channels, a max over the K neighbours.

    Args:
      npoint, radius, nsample: the FPS size and the ball (unused with
        ``group_all``).
      in_channel: a group's channels after the position ones (the normals,
        where grouped, and the features).
      mlp: the stack's widths.
      return_polar, return_normal: ``mpa_tpu``'s grouping fields.
    """

    def __init__(self, npoint: int, radius: float, nsample: int, in_channel: int,
                 mlp: Sequence[int], group_all: bool = False, return_polar: bool = True,
                 return_normal: bool = True):
        super().__init__(npoint, radius, nsample, group_all, return_polar, return_normal)
        self.mlps = _ConvBnStack(self.pos_width + in_channel, tuple(mlp))

    def forward(self, center: torch.Tensor, normal: torch.Tensor,
                feature: Optional[torch.Tensor]):
        """-> (new_center ``[B, S, 3]``, new_normal, features ``[B, S, mlp[-1]]``)."""
        new_center, new_normal, grouped = self.group(center, normal, feature)
        return new_center, new_normal, torch.amax(self.mlps(grouped), dim=2)


class SurfaceAbstractionCD(_Grouping):
    """Centre/dual-input set abstraction: the first layer's Linear over the
    first ``pos_channel`` grouped channels and another over the rest, each
    with its BatchNorm, summed, then ReLU, the shared stack and the max over
    the K neighbours.

    Args:
      npoint, radius, nsample: the FPS size and the ball (unused with
        ``group_all``).
      in_channel: a group's channels after the position ones (the normals,
        where grouped, and the features).
      mlp: the widths; the first is the two first-layer Linears'.
      pos_channel: where the grouped channels split, by default the position
        channels (6 with ``return_polar``, else 3); ``mpa_tpu``'s field.
      return_polar, return_normal: ``mpa_tpu``'s grouping fields; the
        defaults are the form ``repsurf_ssg_2x`` runs (``mpa_tpu``'s
        module defaults ``return_polar`` to False).
    """

    def __init__(self, npoint: int, radius: float, nsample: int, in_channel: int,
                 mlp: Sequence[int], group_all: bool = False, pos_channel: Optional[int] = None,
                 return_polar: bool = True, return_normal: bool = True):
        super().__init__(npoint, radius, nsample, group_all, return_polar, return_normal)
        self.pos_channel = self.pos_width if pos_channel is None else pos_channel
        width = self.pos_width + in_channel
        self.mlp_l0 = nn.Linear(self.pos_channel, mlp[0])
        self.bn_l0 = BatchNorm(mlp[0])
        self.mlp_f0 = nn.Linear(width - self.pos_channel, mlp[0])
        self.bn_f0 = BatchNorm(mlp[0])
        self.mlps = _ConvBnStack(mlp[0], tuple(mlp[1:]))

    def forward(self, center: torch.Tensor, normal: torch.Tensor,
                feature: Optional[torch.Tensor]):
        """-> (new_center ``[B, S, 3]``, new_normal, features ``[B, S, mlp[-1]]``)."""
        new_center, new_normal, grouped = self.group(center, normal, feature)
        pos, feat = grouped[..., :self.pos_channel], grouped[..., self.pos_channel:]
        x = F.relu(self.bn_l0(self.mlp_l0(pos)) + self.bn_f0(self.mlp_f0(feat)))
        x = self.mlps(x)
        return new_center, new_normal, torch.amax(x, dim=2)
