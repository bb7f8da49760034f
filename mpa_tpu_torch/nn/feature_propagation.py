"""PointNet++ feature propagation: 3-NN inverse-distance interpolation, then
one MLP unit.

Counterpart of ``mpa_tpu/nn/feature_propagation.py::PointNetFeaturePropagation``:
coarse features interpolated onto the fine positions
(``ops/interp.py::three_nn_interpolate``; a single coarse point is broadcast
to every fine one), the optional fine-scale ``skip`` features concatenated
in front, then ``conv``, a BatchNorm ``LinearUnit`` with its LeakyReLU:
flax's ``act=True``, the one form ``markov_partseg_fp`` builds (the port's
``LinearUnit`` always acts).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from mpa_tpu_torch.nn.linear import LinearUnit
from mpa_tpu_torch.ops.interp import three_nn_interpolate


class PointNetFeaturePropagation(nn.Module):
    """Args:
      in_channels: width of the coarse features plus that of ``skip``, if
        the caller passes one.
      out_channels: width of the output.
    """

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.conv = LinearUnit(in_channels, out_channels)

    def forward(self, xyz_fine: torch.Tensor, xyz_coarse: torch.Tensor,
                feat_coarse: torch.Tensor, skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        """xyz_fine ``[B, N, 3]``, xyz_coarse ``[B, S, 3]``, feat_coarse
        ``[B, S, C]``, skip ``[B, N, C_skip]`` or None -> ``[B, N, out]``."""
        if xyz_coarse.shape[1] == 1:
            B, _, C = feat_coarse.shape
            interp = feat_coarse.expand(B, xyz_fine.shape[1], C)
        else:
            interp = three_nn_interpolate(xyz_fine, xyz_coarse, feat_coarse)
        if skip is not None:
            interp = torch.cat([skip, interp], dim=-1)
        return self.conv(interp)
