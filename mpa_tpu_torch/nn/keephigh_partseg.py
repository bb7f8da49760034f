"""KeepHighResolution part-segmentation encoder-decoder.

Counterpart of ``mpa_tpu/nn/keephigh_partseg.py::KeepHighResolutionPartSeg``:

- encoder: five Markov states N -> npoints[0] -> ... -> npoints[3] (``la0`` ..
  ``la4``, channels c0..c4), each a three-branch LocalMerge (xyz, spatial kNN,
  feature kNN) with FPS between them;
- decoder: at the coarsest state a LinearUnit (``mlp``) and a Fuse toward
  scale 4; then for each finer scale the scatter-mean upsample over the
  encoder's stored kNN index (hoisted behind ``up_conv``'s Dense), a
  self-attention LocalMerge (``xyz == base_xyz``) and a Fuse toward that
  scale. ``fuse2`` .. ``fuse5`` see a mix of updated and pre-decoder features,
  as in the reference;
- per-point output: ``conv5`` of the finest decoder features (256), the
  concat of the per-scale global max pools (576 at the default widths) and
  the category one-hot through ``conv7`` (64): 896 channels.

``neighbor_mode`` selects the Morton-window modes (``nn/window_mode.py``);
the caller Morton-sorts the cloud (``MarkovPartSeg`` does), and the scales
stay sorted because the FPS subsets are sorted. In train mode the encoder's
FPS scales take keyed starts when the caller gives them, as ``mpa_tpu``
does with ``rng`` (``keephigh_partseg.py:76-77``): ``fps_starts[i]``
(``[B]``, or ``[B, n_bands]`` band-local ones at a banded ``window_all``
scale), or starts drawn from ``fps_generator`` (``draw_starts``, in ladder
order).

Each block call is a span named ``block.<attribute>`` (``block.la0``,
``block.fps1`` for the FPS and gather into scale 1, ``block.up_conv4``,
...; ``utils/profiling.py``).

``dtype`` (``torch.bfloat16``: ``mpa_tpu``'s mixed precision) gives every
state, Fuse and LinearUnit bf16 compute, in every neighbour mode: the
windowed attention and scatter-mean take bf16 rows as the exact ones do,
and the windowed kNN widens bf16 features to float32 (``ops/window.py``).
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence

import torch
from torch import nn

from mpa_tpu_torch.nn.fuse import Fuse
from mpa_tpu_torch.nn.linear import LinearUnit
from mpa_tpu_torch.nn.local_merge import LocalMerge
from mpa_tpu_torch.nn.window_mode import (
    NEIGHBOR_MODES,
    WindowModes,
    check_mode,
    scatter_mean_op,
    spec_or_none,
)
from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.utils.profiling import span


class KeepHighResolutionPartSeg(WindowModes, nn.Module):
    def __init__(
        self,
        npoints: Sequence[int] = (1024, 512, 256, 128),  # scales 1..4 (scale 0 is the input)
        channels: Sequence[int] = (64, 64, 64, 128, 256),  # c0..c4
        residuals: Sequence[bool] = (True, False, False, True, True),
        num_neighbors: int = 8,
        num_categories: int = 16,
        label_channels: int = 64,
        point_channels: int = 256,
        dtype: Any = None,
        neighbor_mode: str = "exact",
        fps_min_band: int = 512,
        fps_min_samples: int = 64,
    ):
        super().__init__()
        if len(channels) != len(npoints) + 1 or len(residuals) != len(channels):
            raise ValueError("channels and residuals need one entry more than npoints")
        self.neighbor_mode = check_mode("neighbor_mode", neighbor_mode, NEIGHBOR_MODES)
        self.fps_min_band, self.fps_min_samples = fps_min_band, fps_min_samples
        self.npoints = tuple(npoints)
        ch = self.channels = tuple(channels)
        K = num_neighbors
        top = len(self.npoints)  # the coarsest scale
        modes = dict(include_xyz_branch=True, knn_mode=self.spatial_mode,
                     feature_knn_mode=self.feature_mode, dtype=dtype)
        self.la0 = LocalMerge(None, ch[0], K, residuals[0], **modes)
        for i in range(top):
            setattr(self, f"la{i + 1}", LocalMerge(ch[i], ch[i + 1], K, residuals[i + 1], **modes))
        self.mlp = LinearUnit(ch[top], ch[top], dtype=dtype)
        self.fuse1 = Fuse(ch, top, K, knn_mode=self.spatial_mode, dtype=dtype)
        for step, s in enumerate(range(top - 1, -1, -1)):
            setattr(self, f"up_conv{s + 1}", LinearUnit(ch[s + 1], ch[s], dtype=dtype))
            setattr(self, f"la{s + 1}_up", LocalMerge(ch[s], ch[s], K, False, **modes))
            setattr(self, f"fuse{step + 2}",
                    Fuse(ch, s, K, knn_mode=self.spatial_mode, dtype=dtype))
        self.conv7 = LinearUnit(num_categories, label_channels, dtype=dtype)
        self.conv5 = LinearUnit(ch[0], point_channels, dtype=dtype)
        self.out_channels = point_channels + sum(ch) + label_channels

    def forward(self, xyz: torch.Tensor, label_onehot: torch.Tensor, *,
                fps_generator: Optional[torch.Generator] = None,
                fps_starts: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """xyz ``[B, N, 3]``, label_onehot ``[B, num_categories]`` ->
        per-point features ``[B, N, out_channels]``; the keyword arguments
        give the keyed FPS starts of train mode (module doc)."""
        B, N, _ = xyz.shape
        top = len(self.npoints)

        # ---- encoder ladder ------------------------------------------------
        feats: List[Optional[torch.Tensor]] = [None] * (top + 1)
        positions: List[Optional[torch.Tensor]] = [xyz] + [None] * top
        fps_list: List[torch.Tensor] = []
        knn_list: List[Optional[torch.Tensor]] = [None] * (top + 1)  # scale s into scale s-1
        with span("block.la0"):  # self-kNN of the full cloud
            feats[0], knn_list[0], dist0 = self.la0(xyz, xyz)
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
        with span("block.fuse1"):
            up_feats[top] = self.fuse1(feats[:top] + [coarsest], fps_list, knn_list, positions)
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
                    spatial_knn=(dist0, knn_list[0]) if s == 0 else None)
            # The fuse sees the pre-decoder features at every other scale.
            mixed = feats[:s] + [f_s] + feats[s + 1:]
            with span(f"block.fuse{step + 2}"):
                up_feats[s] = getattr(self, f"fuse{step + 2}")(mixed, fps_list, knn_list,
                                                               positions)

        # ---- per-point output ----------------------------------------------
        global_rep = torch.cat([torch.amax(f, dim=1) for f in up_feats], dim=-1)  # [B, sum(ch)]
        label = self.conv7(label_onehot[:, None, :])  # [B, 1, label_channels]
        return torch.cat([self.conv5(up_feats[0]),
                          global_rep[:, None, :].expand(B, N, -1),
                          label.expand(B, N, -1)], dim=-1)
