"""KeepHighResolution encoder, the classification-side Markov state ladder.

Counterpart of ``mpa_tpu/nn/keephigh.py::KeepHighResolutionEncoder``: a
full-resolution first state, then one LocalMerge per ladder entry with FPS
between them, ``conv3`` / ``conv4``, the max || mean pool over points, and
``final_class`` + ``final_bn`` + LeakyReLU(0.2).

``fps_random_start`` (``mpa_tpu``'s keyed FPS starts, the reference's
``torch.randint``): in train mode every FPS scale starts each cloud at its
own index, ``fps_starts[i]`` (``[B]``) where the caller gives them, else
drawn from ``fps_generator`` (``ops/fps.py::keyed_start``, one ``[B]`` draw
a scale in ladder order). In eval mode, or without the switch, FPS starts at
index 0, as in ``mpa_tpu``.

``dtype`` (``torch.bfloat16``, ``mpa_tpu/nn/keephigh.py:36,72-82``): the
states and ``conv3`` / ``conv4`` compute in bf16; the max and the mean over
points of their bf16 output are bf16 (the mean accumulated in float32), and
``final_class`` (a Dense without a dtype, whose float32 kernel promotes its
input), ``final_bn`` and what follows run in float32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.nn.linear import BatchNorm, LinearUnit
from mpa_tpu_torch.nn.local_merge import LocalMerge
from mpa_tpu_torch.ops.fps import farthest_point_sample, keyed_start
from mpa_tpu_torch.ops.gather import index_points


def mean_over_points(x: torch.Tensor) -> torch.Tensor:
    """``jnp.mean(x, axis=1)``: a bf16 ``x`` summed in float32, the mean
    rounded back to bf16."""
    if x.dtype == torch.bfloat16:
        return torch.mean(x.float(), dim=1).to(x.dtype)
    return torch.mean(x, dim=1)


class KeepHighResolutionEncoder(nn.Module):
    def __init__(
        self,
        npoints: Sequence[int] = (512, 256, 128, 64, 32),
        channels: Sequence[int] = (64, 64, 64, 128, 256, 512),
        residuals: Sequence[bool] = (True, False, False, True, True, True),
        num_neighbors: int = 8,
        out_features: int = 1024,
        fps_random_start: bool = False,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        if len(channels) != len(npoints) + 1 or len(residuals) != len(channels):
            raise ValueError("channels and residuals need one entry more than npoints")
        self.fps_random_start = fps_random_start
        self.npoints = tuple(npoints)
        self.la0 = LocalMerge(None, channels[0], num_neighbors, residuals[0], dtype=dtype)
        for i in range(len(self.npoints)):
            setattr(self, f"la{i + 1}",
                    LocalMerge(channels[i], channels[i + 1], num_neighbors, residuals[i + 1],
                               dtype=dtype))
        self.conv3 = LinearUnit(channels[-1], channels[-1], dtype=dtype)
        self.conv4 = LinearUnit(channels[-1], out_features, dtype=dtype)
        self.final_class = nn.Linear(2 * out_features, out_features)
        self.final_bn = BatchNorm(out_features)

    def forward(self, xyz: torch.Tensor, *, fps_generator: Optional[torch.Generator] = None,
                fps_starts: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """xyz: ``[B, N, 3]`` -> global feature ``[B, out_features]``; the
        keyword arguments give the keyed FPS starts (module doc)."""
        keyed = self.fps_random_start and self.training
        if keyed and fps_starts is None and fps_generator is None:
            raise ValueError("fps_random_start in train mode needs fps_generator or fps_starts")
        feats, _, _ = self.la0(xyz, xyz)
        cur_xyz = xyz
        for i, npoint in enumerate(self.npoints):
            start = keyed_start(keyed, i, fps_generator, fps_starts, cur_xyz.shape[0],
                                cur_xyz.shape[1])
            fps_idx = farthest_point_sample(cur_xyz, npoint, start_idx=start)
            new_xyz = index_points(cur_xyz, fps_idx)
            feats, _, _ = getattr(self, f"la{i + 1}")(
                new_xyz, cur_xyz, feature=feats, fps_idx=fps_idx
            )
            cur_xyz = new_xyz
        x = self.conv4(self.conv3(feats))
        fused = torch.cat([torch.amax(x, dim=1), mean_over_points(x)], dim=-1)
        # final_class has no compute dtype: its weight's type promotes the input.
        fused = fused.to(torch.promote_types(fused.dtype, self.final_class.weight.dtype))
        fused = self.final_bn(self.final_class(fused))
        return F.leaky_relu(fused, negative_slope=0.2)
