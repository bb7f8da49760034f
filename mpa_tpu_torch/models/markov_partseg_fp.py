"""The alternative part-segmentation model: a feature-propagation decoder.

Counterpart of ``mpa_tpu/models/markov_partseg_fp.py::MarkovPartSegFP``:

- encoder: ``la0`` (the geometric first state over the cloud's self-kNN),
  then per ladder entry FPS on the previous scale's FEATURES (a feature
  cloud, ``fps_kernel``'s sliced form on the card) and a single-branch
  ``LocalMerge`` ``la{i+1}`` (one feature LocalTrans over the spatial kNN);
- decoder, from the coarsest scale down: a self-attention single-branch
  ``LocalMerge`` ``upla{s+1}`` at scale s+1, the 3-NN interpolation onto
  scale s with its unit (``up{s+2}_{s+1}``), and the encoder's features of
  scale s added;
- head: the global max of ``conv6`` over the points and ``conv7`` of the
  category one-hot beside the per-point features, ``head1`` (512) ->
  dropout -> ``head2`` (256) -> ``head3`` (128) -> ``head4`` (Dense to the
  parts) and ``log_softmax``.

The ladder has ``len(npoints)`` levels and uses ``channels[:len(npoints) +
1]``: the training CLI passes 4 levels (``configs.model_kwargs``), the
model's default is 5, and no module of an unused level is built. Dropout
acts in train mode only and draws its mask from the caller's generator.
Only ``neighbor_mode='exact'`` exists, as in ``mpa_tpu``. FPS starts at
index 0: ``mpa_tpu``'s train step passes no ``rng`` to the model, and the
forward here takes none, so a keyed start cannot be asked for.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.models.registry import register_model
from mpa_tpu_torch.nn.feature_propagation import PointNetFeaturePropagation
from mpa_tpu_torch.nn.linear import LinearUnit, seeded_dropout
from mpa_tpu_torch.nn.local_merge import LocalMerge
from mpa_tpu_torch.ops.fps import farthest_point_sample
from mpa_tpu_torch.ops.gather import index_points


class MarkovPartSegFP(nn.Module):
    def __init__(
        self,
        num_parts: int = 50,
        num_categories: int = 16,
        npoints: Sequence[int] = (1024, 512, 256, 128, 64),
        channels: Sequence[int] = (64, 64, 64, 128, 256, 512),
        residuals: Sequence[bool] = (False, False, False, True, True, True),
        num_neighbors: int = 8,
        dropout: float = 0.5,
    ):
        super().__init__()
        levels = len(npoints)
        if len(channels) <= levels or len(residuals) <= levels:
            raise ValueError("channels and residuals need an entry for every scale")
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout={dropout} must be in [0, 1)")
        self.npoints = tuple(npoints)
        self.num_categories = num_categories
        self.dropout = dropout
        ch, K = tuple(channels), num_neighbors
        self.la0 = LocalMerge(None, ch[0], K, residuals[0])
        for i in range(levels):
            setattr(self, f"la{i + 1}",
                    LocalMerge(ch[i], ch[i + 1], K, residuals[i + 1], single_branch=True))
        for s in range(levels - 1, -1, -1):
            setattr(self, f"upla{s + 1}",
                    LocalMerge(ch[s + 1], ch[s + 1], K, False, single_branch=True))
            setattr(self, f"up{s + 2}_{s + 1}", PointNetFeaturePropagation(ch[s + 1], ch[s]))
        self.conv6 = LinearUnit(ch[0], 256)
        self.conv7 = LinearUnit(num_categories, 64)
        self.head1 = LinearUnit(320 + ch[0], 512)
        self.head2 = LinearUnit(512, 256)
        self.head3 = LinearUnit(256, 128)
        self.head4 = nn.Linear(128, num_parts)

    def forward(
        self,
        inputs: Tuple[torch.Tensor, torch.Tensor],
        *,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        """inputs = (points ``[B, N, 3]``, label_onehot ``[B, num_categories]``)
        -> per-point log-probs ``[B, N, num_parts]``. ``generator`` (on the
        points' device) draws the dropout mask; train mode with ``dropout >
        0`` requires it."""
        points, label_onehot = inputs
        xyz = points[..., :3]
        B, N, _ = xyz.shape
        levels = len(self.npoints)

        feats: List[torch.Tensor] = [self.la0(xyz, xyz)[0]]
        positions: List[torch.Tensor] = [xyz]
        cur_xyz = xyz
        for i, npoint in enumerate(self.npoints):
            fps_idx = farthest_point_sample(feats[i], npoint)  # in feature space
            new_xyz = index_points(cur_xyz, fps_idx)
            f, _, _ = getattr(self, f"la{i + 1}")(new_xyz, cur_xyz, feature=feats[i],
                                                  fps_idx=fps_idx)
            feats.append(f)
            positions.append(new_xyz)
            cur_xyz = new_xyz

        up = feats[-1]
        for s in range(levels - 1, -1, -1):
            pos = positions[s + 1]
            up, _, _ = getattr(self, f"upla{s + 1}")(pos, pos, feature=up)
            up = feats[s] + getattr(self, f"up{s + 2}_{s + 1}")(positions[s], pos, up)

        g = torch.amax(self.conv6(up), dim=1, keepdim=True)  # [B, 1, 256]
        label = self.conv7(label_onehot[:, None, :])  # [B, 1, 64]
        head = torch.cat([g, label], dim=-1).expand(B, N, 320)
        x = self.head1(torch.cat([head, up], dim=-1))
        x = seeded_dropout(x, self.dropout, self.training, generator)
        x = self.head3(self.head2(x))
        return F.log_softmax(self.head4(x), dim=-1)


@register_model("markov_partseg_fp")
def _markov_partseg_fp(neighbor_mode="exact", fps_min_band=None, fps_min_samples=None,
                       **kw) -> MarkovPartSegFP:
    # The training CLI passes the window-mode knobs to every part-seg model;
    # this one has only the exact search (the FPS floors act on banded FPS
    # alone, so ignoring them in exact mode changes nothing).
    if neighbor_mode != "exact":
        raise ValueError("markov_partseg_fp supports only neighbor_mode='exact'; use "
                         "markov_partseg for the Morton-window modes")
    return MarkovPartSegFP(**kw)
