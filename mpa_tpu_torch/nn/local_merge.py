"""LocalMerge, one Markov "state transition" between point-set scales.

Counterpart of ``mpa_tpu/nn/local_merge.py::LocalMerge`` in its two
classification forms:

- the first state (no features yet): one geometric LocalTrans on the
  coordinates over their self-kNN;
- later states: two LocalTrans, one over the spatial kNN of the coarse
  points in the fine set and one over the feature-space kNN, whose outputs
  are concatenated and fused by ``fc2``.

The part-seg forms (``single_branch``, ``include_xyz_branch``), a
precomputed ``spatial_knn`` and the Morton-window modes are not ported yet
and raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mpa_tpu_torch.nn.linear import LinearUnit
from mpa_tpu_torch.nn.local_trans import LocalTrans
from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.ops.knn import knn


class LocalMerge(nn.Module):
    """Args:
      feature_channels: width of the incoming fine features, or None for the
        first state, which sees coordinates only.
      out_channels / num_neighbors: as in ``mpa_tpu``.
      residual: residual projection inside the two feature LocalTrans.
    """

    def __init__(self, feature_channels: Optional[int], out_channels: int,
                 num_neighbors: int = 8, residual: bool = False, *,
                 use_tanh: bool = False, include_xyz_branch: bool = False,
                 single_branch: bool = False, knn_mode: str = "exact",
                 feature_knn_mode: str = "exact"):
        super().__init__()
        for name, on in (("use_tanh", use_tanh), ("include_xyz_branch", include_xyz_branch),
                         ("single_branch", single_branch),
                         ("knn_mode='window'", knn_mode != "exact"),
                         ("feature_knn_mode='window'", feature_knn_mode != "exact")):
            if on:
                raise NotImplementedError(f"LocalMerge {name} is not ported yet")
        self.num_neighbors = num_neighbors
        self.first = feature_channels is None
        if self.first:
            self.xyz_trans = LocalTrans(3, out_channels, num_neighbors, residual_proj=True)
        else:
            self.feature_trans = LocalTrans(feature_channels, out_channels, num_neighbors,
                                            residual_proj=residual)
            self.feature_trans2 = LocalTrans(feature_channels, out_channels, num_neighbors,
                                             residual_proj=residual)
            self.fc2 = LinearUnit(2 * out_channels, out_channels)

    def forward(
        self,
        xyz: torch.Tensor,
        base_xyz: torch.Tensor,
        feature: Optional[torch.Tensor] = None,
        fps_idx: Optional[torch.Tensor] = None,
        *,
        spatial_knn=None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """xyz: ``[B, S, 3]`` coarse centres; base_xyz: ``[B, N, 3]`` fine set;
        feature: ``[B, N, C]`` fine features (None on the first state);
        fps_idx: ``[B, S]`` indices realising ``xyz = base_xyz[fps_idx]``.
        Returns ``(features [B, S, out], idx [B, S, K], dist [B, S, K])``."""
        if spatial_knn is not None:
            raise NotImplementedError("LocalMerge spatial_knn reuse is not ported yet")
        if (feature is None) != self.first:
            raise ValueError("LocalMerge: feature must be None exactly on the first state")
        dist, idx = knn(self.num_neighbors, base_xyz, xyz)
        if self.first:
            out = self.xyz_trans(base_xyz, xyz, idx, xyz_mode=True)
            return out, idx, dist
        center_feat = index_points(feature, fps_idx) if fps_idx is not None else feature
        _, idx_feat = knn(self.num_neighbors, feature, center_feat)
        m2 = self.feature_trans2(feature, center_feat, idx_feat)
        m1 = self.feature_trans(feature, center_feat, idx)
        out = self.fc2(torch.cat([m1, m2], dim=-1))
        return out, idx, dist
