"""The plain reference of ``markov_semseg``: the semantic-segmentation network
of "Revisiting 3D point cloud analysis with Markov process" (Pattern
Recognition 2024; ``ssr0512/Markov-Process-Analysis-on-Point-Cloud``,
``KeepHighResolutionModuleSemiSeg``), in the form ``mpa_tpu`` defines it,
written out step by step in plain float32 PyTorch, in its three neighbour
modes.

It is the part-segmentation network of ``markov_partseg.py`` (whose
transitions, states, fuses and units it takes) without the category branch:

- the first state ``la0`` over the block's coordinates, then ``feat_in``
  over its output beside the block's other input channels (rgb and the
  room-normalised xyz);
- the encoder ``la1`` .. ``la4`` with FPS halving the block four times;
- the decoder: ``mlp`` and ``fuse_top`` at the coarsest scale, then for each
  finer scale ``up_conv`` (the coarser output scatter-mean upsampled over
  the encoder's spatial index), the state ``la{s+1}_up`` and ``fuse{step}``;
- the head: ``conv5`` of the finest decoder output beside every scale's
  global max, ``head1`` (dropout after it in train mode), ``head2``,
  ``head3`` and a log-softmax.

The neighbour modes (``window_ops.py``): ``exact`` searches every row;
``window`` sorts the block by Morton code first, searches each spatial kNN
inside its rows' windows wherever the scale pair admits a spec, takes the
FPS indices sorted, and puts the log-probs back in the input order;
``window_all`` bands the feature-space kNN and the FPS as well. The
attention and the upsample over a windowed index are the exact ones (the
window constrains only which rows the index names).

Departures from a literal reading: none beyond ``markov_partseg.py``'s (the
folded transition, the upsample's order of projection and mean); the
decoder's scale-0 state takes ``la0``'s spatial index, the same search on
the same positions.
"""

from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from portbench.reference import ops
from portbench.reference import window_ops as w
from portbench.reference.layers import Linear, LinearUnit
from portbench.reference.markov_partseg import (Fuse, KeepHighResolutionPartSeg, LocalMerge,
                                                 fps_chain)

MODES = ("exact", "window", "window_all")


class WindowLocalMerge(LocalMerge):
    """``LocalMerge`` whose spatial and feature-space searches are windowed
    where ``spatial`` and ``feature`` say so and the pair admits a spec."""

    def __init__(self, feature_channels, out_channels, num_neighbors, residual, spatial: bool,
                 feature: bool):
        super().__init__(feature_channels, out_channels, num_neighbors, residual)
        self.spatial, self.feature_windowed = spatial, feature

    def forward(self, xyz, base_xyz, feature=None, fps_idx=None, spatial_idx=None):
        idx = spatial_idx
        if idx is None:
            idx = w.search(self.k, base_xyz, xyz, self.spatial)
        xyz_f = self.xyz_trans(base_xyz, xyz, idx, True)
        if self.first:
            return xyz_f, idx
        center = feature if fps_idx is None else ops.gather(feature, fps_idx)
        idx_feat = w.search(self.k, feature, center, self.feature_windowed)
        m1 = self.feature_trans(feature, center, idx, False)
        m2 = self.feature_trans2(feature, center, idx_feat, False)
        return self.fc2(torch.cat([xyz_f, m1, m2], dim=-1)), idx


class WindowFuse(Fuse):
    """``Fuse`` whose fresh searches (a coarser source two scales or more
    away) are windowed where ``spatial`` says so and the pair admits a
    spec."""

    def __init__(self, channels, target: int, num_neighbors: int, spatial: bool):
        super().__init__(channels, target, num_neighbors)
        self.spatial = spatial

    def forward(self, features, fps, knn_idx, xyz) -> torch.Tensor:
        t = self.target
        total = features[t]
        for s, f in enumerate(features):
            if s == t:
                continue
            unit = getattr(self, f"conv{s}{t}")
            if s < t:
                moved = ops.gather(f, fps_chain(fps, s, t))
                total = total + unit(moved)
            else:
                idx = knn_idx[s] if s == t + 1 else w.search(self.k, xyz[t], xyz[s],
                                                            self.spatial)
                total = total + unit.upsampled(f, idx, features[t].shape[1])
        return getattr(self, f"conv{t}")(total) + features[t]


class MarkovSemSeg(nn.Module):
    def __init__(self, num_classes: int, feature_channels: int, npoints, channels, residuals,
                 num_neighbors: int, point_channels: int, head, dropout: float,
                 neighbor_mode: str, fps_min_band: int, fps_min_samples: int):
        super().__init__()
        if neighbor_mode not in MODES:
            raise ValueError(f"neighbor_mode {neighbor_mode!r} is not one of {MODES}")
        self.windowed = neighbor_mode != "exact"
        self.banded = neighbor_mode == "window_all"
        self.fps_floors = (fps_min_band, fps_min_samples)
        self.dropout = dropout
        self.npoints = tuple(npoints)
        self.feature_channels = feature_channels
        ch, K, top = tuple(channels), num_neighbors, len(npoints)
        modes = (self.windowed, self.banded)
        self.la0 = WindowLocalMerge(None, ch[0], K, residuals[0], *modes)
        self.feat_in = LinearUnit(ch[0] + feature_channels, ch[0])
        for i in range(top):
            setattr(self, f"la{i + 1}",
                    WindowLocalMerge(ch[i], ch[i + 1], K, residuals[i + 1], *modes))
        self.mlp = LinearUnit(ch[top], ch[top])
        self.fuse_top = WindowFuse(ch, top, K, self.windowed)
        for step, s in enumerate(range(top - 1, -1, -1)):
            setattr(self, f"up_conv{s + 1}", LinearUnit(ch[s + 1], ch[s]))
            setattr(self, f"la{s + 1}_up", WindowLocalMerge(ch[s], ch[s], K, False, *modes))
            setattr(self, f"fuse{step + 1}", WindowFuse(ch, s, K, self.windowed))
        self.conv5 = LinearUnit(ch[0], point_channels)
        self.head1 = LinearUnit(point_channels + sum(ch), head[0])
        self.head2 = LinearUnit(head[0], head[1])
        self.head3 = Linear(head[1], num_classes)

    def _fps(self, xyz: torch.Tensor, npoint: int) -> torch.Tensor:
        if not self.windowed:
            return ops.farthest_point_sample(xyz, npoint)
        bands = w.fps_bands(xyz.shape[1], npoint, *self.fps_floors) if self.banded else 1
        return w.banded_fps(xyz, npoint, bands)

    def forward(self, points: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """points ``[B, N, 3 + F]`` -> log-probs ``[B, N, num_classes]`` in the
        input's order; train mode draws the dropout mask from ``generator``."""
        B, N, _ = points.shape
        if self.windowed:
            order = w.morton_order(points[..., :3])
            points = ops.gather(points, order)
        xyz, extra = points[..., :3], points[..., 3:3 + self.feature_channels]
        top = len(self.npoints)
        stage = KeepHighResolutionPartSeg._stage
        f, idx0 = stage(self.la0, xyz, xyz)
        feats = [self.feat_in(torch.cat([f, extra], dim=-1))]
        positions, fps, knn_idx = [xyz], [], [idx0]
        for i, npoint in enumerate(self.npoints):
            sel = self._fps(positions[i], npoint)
            new_xyz = ops.gather(positions[i], sel)
            f, idx = stage(getattr(self, f"la{i + 1}"), new_xyz, positions[i], feats[i], sel)
            feats.append(f)
            positions.append(new_xyz)
            fps.append(sel)
            knn_idx.append(idx)
        up: List[Optional[torch.Tensor]] = [None] * (top + 1)
        up[top] = stage(self.fuse_top, feats[:top] + [self.mlp(feats[top])], fps, knn_idx,
                        positions)
        for step, s in enumerate(range(top - 1, -1, -1)):
            fine = getattr(self, f"up_conv{s + 1}").upsampled(up[s + 1], knn_idx[s + 1],
                                                              positions[s].shape[1])
            f_s, _ = stage(getattr(self, f"la{s + 1}_up"), positions[s], positions[s], fine,
                           spatial_idx=knn_idx[0] if s == 0 else None)
            mixed = feats[:s] + [f_s] + feats[s + 1:]
            up[s] = stage(getattr(self, f"fuse{step + 1}"), mixed, fps, knn_idx, positions)
        global_rep = torch.cat([torch.amax(u, dim=1) for u in up], dim=-1)
        x = torch.cat([self.conv5(up[0]), global_rep[:, None, :].expand(B, N, -1)], dim=-1)
        x = self.head1(x)
        if self.training:
            x = ops.dropout(x, self.dropout, generator)
        out = torch.log_softmax(self.head3(self.head2(x)), dim=-1)
        if not self.windowed:
            return out
        back = torch.empty_like(out)
        back.scatter_(1, order[..., None].expand(-1, -1, out.shape[-1]), out)
        return back


def build(sizes: dict) -> MarkovSemSeg:
    return MarkovSemSeg(sizes["num_classes"], sizes["feature_channels"], sizes["npoints"],
                        sizes["channels"], sizes["residuals"], sizes["num_neighbors"],
                        sizes["point_channels"], sizes["head"], sizes["dropout"],
                        sizes["neighbor_mode"], sizes["fps_min_band"], sizes["fps_min_samples"])
