"""LocalMerge, one Markov "state transition" between point-set scales.

Counterpart of ``mpa_tpu/nn/local_merge.py::LocalMerge``:

- the first state (no features yet): one geometric LocalTrans on the
  coordinates over their self-kNN, whatever the other switches say;
- the classification form: two LocalTrans, one over the spatial kNN of the
  coarse points in the fine set and one over the feature-space kNN, whose
  outputs are concatenated and fused by ``fc2``;
- ``include_xyz_branch`` (the part-seg encoder and decoder): a geometric
  LocalTrans beside those two. It shares the spatial kNN index with the
  spatial feature branch, so both branches' node tensors are packed into one
  ``[B, N, 4C]`` tensor and one ``n_branches=2`` attention call reads them;
  ``fc2`` fuses the three-way concat;
- ``single_branch``: one feature LocalTrans over the spatial kNN, no
  feature-space branch and no ``fc2``.

A precomputed ``spatial_knn`` (the decoder's full-resolution self-kNN, which
the encoder's first state already searched on the same positions) is taken as
is.

``knn_mode='window'`` restricts the spatial search to the Morton window
(``ops/window.py``; the inputs must be Morton-ordered), and the attention
over its index is the windowed one; ``feature_knn_mode='window'`` (only
together with it) bands the feature-space search too. A scale pair that
admits no window takes the exact search, as in ``mpa_tpu``: that is the
modes' semantics, not a device fallback. ``use_tanh`` gives every
LocalTrans the edge-level tanh path; with ``include_xyz_branch`` the three
branches then run unpacked (``mpa_tpu/nn/local_merge.py:178-200``).

``dtype`` (``torch.bfloat16``) gives every LocalTrans and ``fc2`` bf16
compute (``mpa_tpu/nn/local_merge.py:47``): ``center_feat`` is a bf16
gather, the feature-space kNN, exact or windowed, upcasts its bf16
features to float32 before any distance (``ops/knn.py``,
``ops/window.py``), the spatial kNN stays on the float32 coordinates, and
the attention, exact or windowed, takes the bf16 ``[E || V]`` rows.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from mpa_tpu_torch.nn.linear import LinearUnit
from mpa_tpu_torch.nn.local_trans import LocalTrans
from mpa_tpu_torch.ops.attention import transition_attention
from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.ops.knn import knn
from mpa_tpu_torch.ops.window import windowed_knn_with_spec, windowed_transition_attention
from mpa_tpu_torch.nn.window_mode import check_mode, spec_or_none


class LocalMerge(nn.Module):
    """Args:
      feature_channels: width of the incoming fine features, or None for the
        first state, which sees coordinates only.
      out_channels / num_neighbors: as in ``mpa_tpu``.
      residual: residual projection inside the feature LocalTrans.
      include_xyz_branch / single_branch: the part-seg forms above.
    """

    def __init__(self, feature_channels: Optional[int], out_channels: int,
                 num_neighbors: int = 8, residual: bool = False, *,
                 use_tanh: bool = False, include_xyz_branch: bool = False,
                 single_branch: bool = False, knn_mode: str = "exact",
                 feature_knn_mode: str = "exact", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.knn_mode = check_mode("knn_mode", knn_mode, ("exact", "window"))
        self.feature_knn_mode = check_mode("feature_knn_mode", feature_knn_mode,
                                           ("exact", "window"))
        self.out_channels = out_channels
        self.num_neighbors = num_neighbors
        self.first = feature_channels is None
        self.single_branch = single_branch and not self.first
        self.include_xyz_branch = include_xyz_branch and not self.first and not single_branch
        self.use_tanh = use_tanh
        if self.first or self.include_xyz_branch:
            self.xyz_trans = LocalTrans(3, out_channels, num_neighbors, residual_proj=True,
                                        use_tanh=use_tanh, dtype=dtype)
        if self.first:
            return
        self.feature_trans = LocalTrans(feature_channels, out_channels, num_neighbors,
                                        residual_proj=residual, use_tanh=use_tanh, dtype=dtype)
        if self.single_branch:
            return
        self.feature_trans2 = LocalTrans(feature_channels, out_channels, num_neighbors,
                                         residual_proj=residual, use_tanh=use_tanh, dtype=dtype)
        branches = 3 if self.include_xyz_branch else 2
        self.fc2 = LinearUnit(branches * out_channels, out_channels, dtype=dtype)

    def forward(
        self,
        xyz: torch.Tensor,
        base_xyz: torch.Tensor,
        feature: Optional[torch.Tensor] = None,
        fps_idx: Optional[torch.Tensor] = None,
        *,
        spatial_knn: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """xyz: ``[B, S, 3]`` coarse centres; base_xyz: ``[B, N, 3]`` fine set;
        feature: ``[B, N, C]`` fine features (None on the first state);
        fps_idx: ``[B, S]`` indices realising ``xyz = base_xyz[fps_idx]``;
        spatial_knn: ``(dist, idx)`` of this very spatial search (same base,
        query and k) made earlier in the model, or None to search here.
        Returns ``(features [B, S, out], idx [B, S, K], dist [B, S, K])``."""
        if (feature is None) != self.first:
            raise ValueError("LocalMerge: feature must be None exactly on the first state")
        dist, idx, wspec = self._knn(base_xyz, xyz, spatial_knn, self.knn_mode)
        if self.first:
            out = self.xyz_trans(base_xyz, xyz, idx, xyz_mode=True, window_spec=wspec)
            return out, idx, dist
        center_feat = index_points(feature, fps_idx) if fps_idx is not None else feature
        if self.single_branch:
            return self.feature_trans(feature, center_feat, idx, window_spec=wspec), idx, dist
        # Banding the feature search is a stronger approximation than banding
        # the spatial one, and only defined on Morton-ordered rows.
        feature_mode = self.feature_knn_mode if self.knn_mode == "window" else "exact"
        _, idx_feat, wspec_f = self._knn(feature, center_feat, None, feature_mode)
        m2 = self.feature_trans2(feature, center_feat, idx_feat, window_spec=wspec_f)
        if not self.include_xyz_branch or self.use_tanh:
            m1 = self.feature_trans(feature, center_feat, idx, window_spec=wspec)
            branches = [m1, m2]
            if self.include_xyz_branch:
                xyz_f = self.xyz_trans(base_xyz, xyz, idx, xyz_mode=True, window_spec=wspec)
                branches = [xyz_f, m1, m2]
        else:
            C = self.out_channels
            packed = torch.cat([self.xyz_trans.node_pack(base_xyz),
                                self.feature_trans.node_pack(feature)], dim=-1)  # [B, N, 4C]
            xshift = self.xyz_trans.value_shift(xyz)  # [B, S, C]
            shifts = torch.cat([xshift, torch.zeros_like(xshift)], dim=-1)
            if wspec is not None:
                ctx = windowed_transition_attention(packed, idx, shifts, 2, C, wspec)
            else:
                ctx = transition_attention(packed, idx, shifts, 2, C)  # [B, S, 2C]
            xyz_f = self.xyz_trans.ffn_out(ctx[..., :C], xyz)
            m1 = self.feature_trans.ffn_out(ctx[..., C:], center_feat)
            branches = [xyz_f, m1, m2]
        out = self.fc2(torch.cat(branches, dim=-1))
        return out, idx, dist

    def _knn(self, base, query, precomputed, mode: str):
        """``(dist, idx, window spec or None)`` of the K nearest ``base`` rows
        of each ``query`` row: windowed where ``mode`` is ``'window'`` and the
        (S, N) pair admits a spec, exact otherwise. ``precomputed`` is this
        very search made earlier in the model; its spec follows from the
        shapes alone."""
        spec = spec_or_none(query.shape[1], base.shape[1]) if mode == "window" else None
        if precomputed is not None:
            dist, idx = precomputed
            return dist, idx, spec
        if spec is not None:
            return windowed_knn_with_spec(self.num_neighbors, base, query)
        dist, idx = knn(self.num_neighbors, base, query)
        return dist, idx, None
