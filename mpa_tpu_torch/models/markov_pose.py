"""Pose regression over the Markov classification encoder.

Counterpart of ``mpa_tpu/models/markov_pose.py``: the KeepHighResolution
encoder's global feature, then ``fc1`` -> ``bn1`` -> LeakyReLU(0.2) ->
dropout -> ``fc_rot``, a continuous 6D rotation that Gram-Schmidt turns
into a rotation matrix (``rotation_6d_to_matrix``); trained on the mean
geodesic angle (``rotation_geodesic_loss``). Dropout acts in train mode only
and draws its mask from the caller's generator.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.models.registry import register_model
from mpa_tpu_torch.nn.keephigh import KeepHighResolutionEncoder
from mpa_tpu_torch.nn.linear import BatchNorm, seeded_dropout


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` over the last axis, each component one rounded product
    minus another."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def rotation_6d_to_matrix(x6: torch.Tensor) -> torch.Tensor:
    """``[..., 6]`` -> ``[..., 3, 3]``: Gram-Schmidt of the two 3-vectors
    (norms floored at 1e-8), their cross product the third row."""
    a1, a2 = x6[..., :3], x6[..., 3:]
    b1 = a1 / torch.clamp_min(torch.linalg.vector_norm(a1, dim=-1, keepdim=True), 1e-8)
    a2p = a2 - torch.sum(b1 * a2, dim=-1, keepdim=True) * b1
    b2 = a2p / torch.clamp_min(torch.linalg.vector_norm(a2p, dim=-1, keepdim=True), 1e-8)
    return torch.stack([b1, b2, _cross(b1, b2)], dim=-2)


def rotation_geodesic_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean geodesic angle between rotation matrices ``[..., 3, 3]``: the
    arccos of ``(trace(pred target^T) - 1) / 2``, clipped to ``[-1 + 1e-7,
    1 - 1e-7]`` (no gradient flows through the clip's flat parts)."""
    rel = torch.einsum("...ij,...kj->...ik", pred, target)
    trace = rel[..., 0, 0] + rel[..., 1, 1] + rel[..., 2, 2]
    cos = torch.clamp((trace - 1.0) / 2.0, -1.0 + 1e-7, 1.0 - 1e-7)
    return torch.mean(torch.arccos(cos))


class MarkovPose(nn.Module):
    def __init__(
        self,
        npoints: Sequence[int] = (512, 256, 128, 64, 32),
        channels: Sequence[int] = (64, 64, 64, 128, 256, 512),
        residuals: Sequence[bool] = (True, False, False, True, True, True),
        num_neighbors: int = 8,
        encoder_features: int = 1024,
        dropout: float = 0.1,
    ):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout={dropout} must be in [0, 1)")
        self.dropout = dropout
        self.keep_high = KeepHighResolutionEncoder(
            npoints=npoints, channels=channels, residuals=residuals,
            num_neighbors=num_neighbors, out_features=encoder_features,
        )
        self.fc1 = nn.Linear(encoder_features, 512)
        self.bn1 = BatchNorm(512)
        self.fc_rot = nn.Linear(512, 6)

    def forward(self, points: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None,
                fps_starts: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """points ``[B, N, 3]`` -> rotation matrices ``[B, 3, 3]``; the FPS
        keywords pass to the encoder, whose keyed starts are off, as
        ``mpa_tpu``'s pass ``rng`` (``markov_pose.py:64``)."""
        g = self.keep_high(points[..., :3], fps_generator=fps_generator, fps_starts=fps_starts)
        x = F.leaky_relu(self.bn1(self.fc1(g)), negative_slope=0.2)
        x = seeded_dropout(x, self.dropout, self.training, generator)
        return rotation_6d_to_matrix(self.fc_rot(x))


@register_model("markov_pose")
def _markov_pose(**kw) -> MarkovPose:
    return MarkovPose(**kw)
