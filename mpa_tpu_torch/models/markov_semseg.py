"""Markov semantic segmentation (S3DIS: 13 classes, blocks of 4096 points).

Counterpart of ``mpa_tpu/models/markov_semseg.py::MarkovSemSeg``: the
part-seg KeepHighResolution encoder-decoder without the category branch,
with the per-point input features (rgb and room-normalised xyz) fused into
the first state:

- ``la0``: the geometric first state over the cloud's self-kNN, then
  ``feat_in`` over its output and the ``feature_channels`` extra inputs;
- ``la1`` .. ``la4``: three-branch LocalMerge states with FPS between them;
- decoder: ``mlp`` and ``fuse_top`` toward the coarsest scale, then for each
  finer scale s the scatter-mean upsample over the encoder's stored index
  (hoisted behind ``up_conv{s+1}``'s Dense), a self-attention LocalMerge
  ``la{s+1}_up`` (scale 0 reuses ``la0``'s search) and ``fuse{k}``;
- head: ``conv5`` of the finest decoder features beside the global max of
  every scale's, ``head1`` (512) -> dropout -> ``head2`` (256) -> ``head3``
  (Dense to the classes) and ``log_softmax``.

``neighbor_mode`` selects the Morton-window modes (``nn/window_mode.py``):
the block is Morton-sorted first and the log-probs are put back in the input
order. Dropout acts in train mode only and draws its mask from the
``torch.Generator`` the caller passes. In train mode the encoder's FPS takes
keyed starts when ``fps_generator`` or ``fps_starts`` is given
(``WindowModes.fps_scale``), as ``mpa_tpu``'s takes them from ``rng``.

Each block call is a span named ``block.<attribute>``, as in part-seg
(``nn/keephigh_partseg.py``): ``block.la0`` (with ``feat_in``),
``block.fps1`` .. ``block.fps4`` (FPS and its gather), ``block.la1`` ..
``block.la4``, ``block.mlp``, ``block.fuse_top``, ``block.up_conv1`` ..
``block.up_conv4``, ``block.la1_up`` .. ``block.la4_up``, ``block.fuse1`` ..
``block.fuse4`` and ``block.head`` (``conv5`` to the log-probs).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.models.registry import register_model
from mpa_tpu_torch.nn.fuse import Fuse
from mpa_tpu_torch.nn.linear import LinearUnit, seeded_dropout
from mpa_tpu_torch.nn.local_merge import LocalMerge
from mpa_tpu_torch.nn.window_mode import (
    NEIGHBOR_MODES,
    WindowModes,
    check_mode,
    morton_sort,
    morton_unsort,
    scatter_mean_op,
    spec_or_none,
)
from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.utils.profiling import span


class MarkovSemSeg(WindowModes, nn.Module):
    """points ``[B, N, 3+F]`` (xyz and F extra channels) -> log-probs
    ``[B, N, num_classes]``."""

    def __init__(
        self,
        num_classes: int = 13,
        feature_channels: int = 6,  # rgb + room-normalised xyz (S3DIS block format)
        npoints: Sequence[int] = (2048, 1024, 512, 256),  # scales below the 4096 input
        channels: Sequence[int] = (64, 64, 64, 128, 256),
        residuals: Sequence[bool] = (True, False, False, True, True),
        num_neighbors: int = 8,
        dropout: float = 0.5,
        neighbor_mode: str = "exact",
        fps_min_band: int = 512,
        fps_min_samples: int = 64,
    ):
        super().__init__()
        if len(channels) != len(npoints) + 1 or len(residuals) != len(channels):
            raise ValueError("channels and residuals need one entry more than npoints")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout={dropout} must be in [0, 1)")
        self.neighbor_mode = check_mode("neighbor_mode", neighbor_mode, NEIGHBOR_MODES)
        self.fps_min_band, self.fps_min_samples = fps_min_band, fps_min_samples
        self.feature_channels = feature_channels
        self.dropout = dropout
        self.npoints = tuple(npoints)
        ch = self.channels = tuple(channels)
        K = num_neighbors
        top = len(self.npoints)  # the coarsest scale
        modes = dict(include_xyz_branch=True, knn_mode=self.spatial_mode,
                     feature_knn_mode=self.feature_mode)
        self.la0 = LocalMerge(None, ch[0], K, residuals[0], **modes)
        self.feat_in = LinearUnit(ch[0] + feature_channels, ch[0]) if feature_channels else None
        for i in range(top):
            setattr(self, f"la{i + 1}", LocalMerge(ch[i], ch[i + 1], K, residuals[i + 1], **modes))
        self.mlp = LinearUnit(ch[top], ch[top])
        self.fuse_top = Fuse(ch, top, K, knn_mode=self.spatial_mode)
        for step, s in enumerate(range(top - 1, -1, -1)):
            setattr(self, f"up_conv{s + 1}", LinearUnit(ch[s + 1], ch[s]))
            setattr(self, f"la{s + 1}_up", LocalMerge(ch[s], ch[s], K, False, **modes))
            setattr(self, f"fuse{step + 1}", Fuse(ch, s, K, knn_mode=self.spatial_mode))
        self.conv5 = LinearUnit(ch[0], 256)
        self.head1 = LinearUnit(256 + sum(ch), 512)
        self.head2 = LinearUnit(512, 256)
        self.head3 = nn.Linear(256, num_classes)

    def forward(self, points: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                fps_generator: Optional[torch.Generator] = None,
                fps_starts: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``generator`` (on the points' device) draws the dropout mask; train
        mode with ``dropout > 0`` requires it."""
        B, N, _ = points.shape
        inv_perm = None
        if self.windowed:
            points, inv_perm = morton_sort(points)
        xyz = points[..., :3]
        extra = points[..., 3:3 + self.feature_channels]
        top = len(self.npoints)

        # ---- encoder ladder ------------------------------------------------
        with span("block.la0"):
            f0, idx0, d0 = self.la0(xyz, xyz)  # self-kNN of the full block
            if self.feat_in is not None:
                f0 = self.feat_in(torch.cat([f0, extra], dim=-1))
        feats: List[Optional[torch.Tensor]] = [f0] + [None] * top
        positions: List[Optional[torch.Tensor]] = [xyz] + [None] * top
        fps_list: List[torch.Tensor] = []
        knn_list: List[Optional[torch.Tensor]] = [idx0] + [None] * top  # scale s into s-1
        cur_xyz = xyz
        for i, npoint in enumerate(self.npoints):
            with span(f"block.fps{i + 1}"):
                fps_idx = self.fps_scale(cur_xyz, npoint, i, fps_generator, fps_starts)
                new_xyz = index_points(cur_xyz, fps_idx)
            with span(f"block.la{i + 1}"):
                feats[i + 1], knn_list[i + 1], _ = getattr(self, f"la{i + 1}")(
                    new_xyz, cur_xyz, feature=feats[i], fps_idx=fps_idx)
            positions[i + 1] = new_xyz
            fps_list.append(fps_idx)
            cur_xyz = new_xyz

        # ---- decoder: up-states interleaved with cross-scale Fuse ----------
        up_feats: List[Optional[torch.Tensor]] = [None] * (top + 1)
        with span("block.mlp"):
            coarsest = self.mlp(feats[top])
        with span("block.fuse_top"):
            up_feats[top] = self.fuse_top(feats[:top] + [coarsest], fps_list, knn_list,
                                          positions)
        for step, s in enumerate(range(top - 1, -1, -1)):
            num_fine = positions[s].shape[1]
            # Windowed, the stored encoder index is window-constrained exactly
            # when the pair admits a spec (LocalMerge's admission).
            wspec = spec_or_none(positions[s + 1].shape[1], num_fine) if self.windowed else None
            with span(f"block.up_conv{s + 1}"):
                up = getattr(self, f"up_conv{s + 1}")(
                    up_feats[s + 1], mid_op=scatter_mean_op(knn_list[s + 1], num_fine, wspec))
            # Scale 0's self-kNN was searched by la0 on the same positions.
            with span(f"block.la{s + 1}_up"):
                f_s, _, _ = getattr(self, f"la{s + 1}_up")(
                    positions[s], positions[s], feature=up,
                    spatial_knn=(d0, idx0) if s == 0 else None)
            mixed = feats[:s] + [f_s] + feats[s + 1:]
            with span(f"block.fuse{step + 1}"):
                up_feats[s] = getattr(self, f"fuse{step + 1}")(mixed, fps_list, knn_list,
                                                               positions)

        # ---- per-point head ------------------------------------------------
        with span("block.head"):
            global_rep = torch.cat([torch.amax(f, dim=1) for f in up_feats], dim=-1)
            x = torch.cat([self.conv5(up_feats[0]), global_rep[:, None, :].expand(B, N, -1)],
                          dim=-1)
            x = seeded_dropout(self.head1(x), self.dropout, self.training, generator)
            x = F.log_softmax(self.head3(self.head2(x)), dim=-1)
        return morton_unsort(x, inv_perm)


@register_model("markov_semseg")
def _markov_semseg(**kw) -> MarkovSemSeg:
    return MarkovSemSeg(**kw)
