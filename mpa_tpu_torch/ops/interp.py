"""3-NN inverse-distance-weighted feature interpolation (coarse to fine).

Counterpart of ``mpa_tpu/ops/interp.py::three_nn_interpolate``: the 3
nearest coarse points of each fine point (``knn`` with k = 3, the fine
points as queries: ``knn_kernel`` on the card), weights ``1 / (d + 1e-8)``
on their squared distances, normalised over the 3, and one row gather of
the ``[B, N, 3]`` neighbours' features (``gather_rows_kernel``).
"""

from __future__ import annotations

import torch

from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.ops.knn import knn


def three_nn_interpolate(
    xyz_fine: torch.Tensor, xyz_coarse: torch.Tensor, features: torch.Tensor
) -> torch.Tensor:
    """Interpolate coarse features onto fine positions.

    Args:
      xyz_fine: ``[B, N, 3]`` target positions.
      xyz_coarse: ``[B, S, 3]`` source positions (S >= 3).
      features: ``[B, S, C]`` source features.

    Returns:
      ``[B, N, C]`` IDW-interpolated features.
    """
    d, idx = knn(3, xyz_coarse, xyz_fine)  # [B, N, 3]
    w = 1.0 / (d + 1e-8)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    neighb = index_points(features, idx)  # [B, N, 3, C]
    return torch.sum(neighb * w[..., None].to(features.dtype), dim=2)
