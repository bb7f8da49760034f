"""The plain reference of ``markov_partseg``: the part-segmentation model of
"Revisiting 3D point cloud analysis with Markov process" (Pattern
Recognition 2024; ``ssr0512/Markov-Process-Analysis-on-Point-Cloud``,
``tool/train_partseg.py``), in the form ``mpa_tpu`` defines it, written out
step by step in plain float32 PyTorch.

- A transition (``LocalTrans``) from a source set to centre points over each
  centre's K neighbours: per channel, ``p = softmax_K((q(centre) -
  key_j) / sqrt(C))`` with ``key_j = k(x_j - centre)`` and ``value_j = v(x_j
  - centre)`` on coordinates, ``k(x_j)`` and ``v(x_j)`` on features; the
  context is ``max_K((p - 1) * value)``, the output ``residual +
  ffn(context)``, the residual the centre itself or its projection.
- A state (``LocalMerge``): three transitions, over the spatial kNN on
  coordinates, over the spatial kNN on features, and over the kNN in
  feature space, concatenated and fused by ``fc2``; the first state has the
  coordinate transition alone.
- The encoder: five states, FPS halving the cloud four times.
- The decoder: at the coarsest scale ``mlp`` and ``fuse1``; then for each
  finer scale the coarser output scatter-mean upsampled over the encoder's
  kNN index and projected (``up_conv``), a state on that scale, and a
  ``Fuse``: every other scale brought to it (finer ones gathered along the
  FPS chain, coarser ones scatter-mean upsampled over a kNN index, then
  projected), summed with it, projected, plus the scale itself.
- The head: the finest decoder output (``conv5``), every scale's global
  max, the category's one-hot (``conv7``), then ``conv8`` .. ``conv10``,
  dropout after ``conv8`` in train mode, ``conv11`` and a log-softmax.

The transition is written as ``mpa_tpu`` writes it, in the form that is
equal in real arithmetic to the softmax above and that the program keeps
too: a softmax over K ignores a per-centre constant, so the query drops
out and each source row gives ``E_j = exp(-k(x_j) / sqrt(C) - m)`` (``m``
the largest exponent over the rows, a constant of each channel), the
weights are ``E_j / sum_K E - 1`` (the sum taken in neighbour order), and a
coordinate value is ``v(x_j) + (b_v - v(centre))``. An upsample feeds its
projection as ``mpa_tpu`` orders it: the coarse rows projected, the mean of
``x W`` over a fine row's claimants taken, the bias added. Both keep the
reference's roundings where the program's are, so that a neighbour
selected in feature space is the same on both sides unless an answer
really differs. Parameter names are the published ones (``q`` is among
them, though the folded form never reads it), so one table of weights
loads into both.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from portbench.reference import ops
from portbench.reference.layers import Linear, LinearUnit


class LocalTrans(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, residual_proj: bool):
        super().__init__()
        self.out_channels = out_channels
        self.q = Linear(in_channels, out_channels)
        self.k = Linear(in_channels, out_channels)
        self.v = Linear(in_channels, out_channels)
        self.conv_res = LinearUnit(in_channels, out_channels) if residual_proj else None
        self.ffn = LinearUnit(out_channels, out_channels)

    def forward(self, source, center, idx, xyz_mode: bool) -> torch.Tensor:
        neg = -self.k(source) / math.sqrt(float(self.out_channels))
        e = torch.exp(neg - torch.amax(neg, dim=1, keepdim=True).detach())
        e, value = ops.gather(e, idx), ops.gather(self.v(source), idx)  # [B, S, K, C]
        if xyz_mode:
            value = value + (self.v.bias - self.v(center))[:, :, None, :]
        denom = e[:, :, 0]
        for j in range(1, e.shape[2]):
            denom = denom + e[:, :, j]
        weight = e / torch.clamp_min(denom[:, :, None, :], 1e-20) - 1.0
        context = torch.amax(weight * value, dim=2)
        residual = center if self.conv_res is None else self.conv_res(center)
        return residual + self.ffn(context)


class LocalMerge(nn.Module):
    def __init__(self, feature_channels: Optional[int], out_channels: int, num_neighbors: int,
                 residual: bool):
        super().__init__()
        self.k = num_neighbors
        self.first = feature_channels is None
        self.xyz_trans = LocalTrans(3, out_channels, True)
        if not self.first:
            self.feature_trans = LocalTrans(feature_channels, out_channels, residual)
            self.feature_trans2 = LocalTrans(feature_channels, out_channels, residual)
            self.fc2 = LinearUnit(3 * out_channels, out_channels)

    def forward(self, xyz, base_xyz, feature=None, fps_idx=None, spatial_idx=None):
        """Returns ``(features [B, S, out], spatial kNN index [B, S, K])``."""
        idx = ops.knn(self.k, base_xyz, xyz) if spatial_idx is None else spatial_idx
        xyz_f = self.xyz_trans(base_xyz, xyz, idx, True)
        if self.first:
            return xyz_f, idx
        center = feature if fps_idx is None else ops.gather(feature, fps_idx)
        idx_feat = ops.knn(self.k, feature, center)
        m1 = self.feature_trans(feature, center, idx, False)
        m2 = self.feature_trans2(feature, center, idx_feat, False)
        return self.fc2(torch.cat([xyz_f, m1, m2], dim=-1)), idx


def fps_chain(fps: Sequence[torch.Tensor], src: int, dst: int) -> torch.Tensor:
    """Indices of scale ``dst``'s points inside scale ``src`` (``src <
    dst``); ``fps[j]`` indexes scale ``j + 1``'s points in scale ``j``."""
    idx = fps[dst - 1]
    for j in range(dst - 2, src - 1, -1):
        idx = torch.gather(fps[j], 1, idx)
    return idx


class Fuse(nn.Module):
    def __init__(self, channels: Sequence[int], target: int, num_neighbors: int):
        super().__init__()
        self.k = num_neighbors
        self.target = target
        for s, cs in enumerate(channels):
            if s != target:
                setattr(self, f"conv{s}{target}", LinearUnit(cs, channels[target]))
        setattr(self, f"conv{target}", LinearUnit(channels[target], channels[target]))

    def forward(self, features, fps, knn_idx, xyz) -> torch.Tensor:
        t = self.target
        total = features[t]
        for s, f in enumerate(features):
            if s == t:
                continue
            if s < t:
                moved = ops.gather(f, fps_chain(fps, s, t))
                total = total + getattr(self, f"conv{s}{t}")(moved)
            else:
                idx = knn_idx[s] if s == t + 1 else ops.knn(self.k, xyz[t], xyz[s])
                unit = getattr(self, f"conv{s}{t}")
                total = total + unit.upsampled(f, idx, features[t].shape[1])
        return getattr(self, f"conv{t}")(total) + features[t]


class KeepHighResolutionPartSeg(nn.Module):
    def __init__(self, npoints, channels, residuals, num_neighbors, num_categories,
                 label_channels, point_channels):
        super().__init__()
        self.npoints = tuple(npoints)
        ch, K, top = tuple(channels), num_neighbors, len(npoints)
        self.la0 = LocalMerge(None, ch[0], K, residuals[0])
        for i in range(top):
            setattr(self, f"la{i + 1}", LocalMerge(ch[i], ch[i + 1], K, residuals[i + 1]))
        self.mlp = LinearUnit(ch[top], ch[top])
        self.fuse1 = Fuse(ch, top, K)
        for step, s in enumerate(range(top - 1, -1, -1)):
            setattr(self, f"up_conv{s + 1}", LinearUnit(ch[s + 1], ch[s]))
            setattr(self, f"la{s + 1}_up", LocalMerge(ch[s], ch[s], K, False))
            setattr(self, f"fuse{step + 2}", Fuse(ch, s, K))
        self.conv7 = LinearUnit(num_categories, label_channels)
        self.conv5 = LinearUnit(ch[0], point_channels)

    @staticmethod
    def _stage(module: nn.Module, *args, **kwargs):
        """``module(*args, **kwargs)``; under autograd its activations are
        recomputed in the backward instead of kept (the checked steps run at
        the timed batch, and a stage holds no random draw)."""
        if not torch.is_grad_enabled():
            return module(*args, **kwargs)
        return checkpoint(module, *args, use_reentrant=False, **kwargs)

    def forward(self, xyz: torch.Tensor, onehot: torch.Tensor) -> torch.Tensor:
        B, N, _ = xyz.shape
        top = len(self.npoints)
        stage = self._stage
        feats: List[torch.Tensor] = []
        positions, fps, knn_idx = [xyz], [], [None]
        f, idx0 = stage(self.la0, xyz, xyz)
        feats.append(f)
        knn_idx[0] = idx0
        for i, npoint in enumerate(self.npoints):
            sel = ops.farthest_point_sample(positions[i], npoint)
            new_xyz = ops.gather(positions[i], sel)
            f, idx = stage(getattr(self, f"la{i + 1}"), new_xyz, positions[i], feats[i], sel)
            feats.append(f)
            positions.append(new_xyz)
            fps.append(sel)
            knn_idx.append(idx)
        up: List[Optional[torch.Tensor]] = [None] * (top + 1)
        up[top] = stage(self.fuse1, feats[:top] + [self.mlp(feats[top])], fps, knn_idx, positions)
        for step, s in enumerate(range(top - 1, -1, -1)):
            fine = getattr(self, f"up_conv{s + 1}").upsampled(up[s + 1], knn_idx[s + 1],
                                                              positions[s].shape[1])
            f_s, _ = stage(getattr(self, f"la{s + 1}_up"), positions[s], positions[s], fine,
                           spatial_idx=knn_idx[0] if s == 0 else None)
            mixed = feats[:s] + [f_s] + feats[s + 1:]
            up[s] = stage(getattr(self, f"fuse{step + 2}"), mixed, fps, knn_idx, positions)
        global_rep = torch.cat([torch.amax(u, dim=1) for u in up], dim=-1)
        label = self.conv7(onehot[:, None, :])
        return torch.cat([self.conv5(up[0]), global_rep[:, None, :].expand(B, N, -1),
                          label.expand(B, N, -1)], dim=-1)


class MarkovPartSeg(nn.Module):
    def __init__(self, num_parts: int, num_categories: int, npoints, channels, residuals,
                 num_neighbors: int, label_channels: int, point_channels: int, head,
                 dropout: float):
        super().__init__()
        self.dropout = dropout
        self.num_categories = num_categories
        self.keep_high = KeepHighResolutionPartSeg(npoints, channels, residuals, num_neighbors,
                                                   num_categories, label_channels,
                                                   point_channels)
        width = point_channels + sum(channels) + label_channels
        self.conv8 = LinearUnit(width, head[0])
        self.conv9 = LinearUnit(head[0], head[1])
        self.conv10 = LinearUnit(head[1], head[2])
        self.conv11 = Linear(head[2], num_parts)

    def forward(self, points: torch.Tensor, category: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """points ``[B, N, 3]``, category ``[B]`` -> log-probs ``[B, N,
        num_parts]``; train mode draws the dropout mask from ``generator``."""
        onehot = torch.nn.functional.one_hot(category, self.num_categories).float()
        x = self.conv8(self.keep_high(points[..., :3], onehot))
        if self.training:
            x = ops.dropout(x, self.dropout, generator)
        x = self.conv10(self.conv9(x))
        return torch.log_softmax(self.conv11(x), dim=-1)


def build(sizes: dict) -> MarkovPartSeg:
    return MarkovPartSeg(sizes["num_parts"], sizes["num_categories"], sizes["npoints"],
                         sizes["channels"], sizes["residuals"], sizes["num_neighbors"],
                         sizes["label_channels"], sizes["point_channels"], sizes["head"],
                         sizes["dropout"])
