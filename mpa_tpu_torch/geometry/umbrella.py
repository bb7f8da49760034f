"""Umbrella surface grouping: triangle fans around each point.

Counterpart of ``mpa_tpu/geometry/umbrella.py::group_by_umbrella``: the k
nearest neighbours of each centre (``ops.knn``, so ``knn_kernel`` on the
card), the self match dropped, the neighbours taken relative to the centre
and sorted by azimuth, each paired with its rolled successor and the centre
to form k - 1 triangles. The sort is stable, as ``jnp.argsort`` is:
repeated points give equal azimuths, and the order of a tie decides which
triangle is the fan's first.
"""

from __future__ import annotations

import torch

from mpa_tpu_torch.geometry.spherical import xyz2sphere
from mpa_tpu_torch.ops.gather import index_points, resort_points
from mpa_tpu_torch.ops.knn import knn


def group_by_umbrella(xyz: torch.Tensor, new_xyz: torch.Tensor, k: int = 9) -> torch.Tensor:
    """Umbrella triangle fans.

    Args:
      xyz: ``[B, N, 3]`` base points.
      new_xyz: ``[B, N', 3]`` centres.
      k: kNN size; gives k - 1 triangles per centre.

    Returns:
      ``[B, N', k-1, 3pts, 3]`` centre-relative triangles: point 0 is the
      origin (the centre), points 1 and 2 an azimuth-adjacent neighbour pair.
    """
    _, idx = knn(k, xyz, new_xyz)
    group_xyz = index_points(xyz, idx)[:, :, 1:]  # the self match dropped: [B, N', k-1, 3]
    group_rel = group_xyz - new_xyz[:, :, None, :]
    phi = xyz2sphere(group_rel)[..., 2]
    sort_idx = torch.argsort(phi, dim=-1, stable=True)
    sorted_rel = resort_points(group_rel, sort_idx)[..., None, :]  # [B, N', k-1, 1, 3]
    rolled = torch.roll(sorted_rel, shifts=-1, dims=-3)
    return torch.cat([torch.zeros_like(sorted_rel), sorted_rel, rolled], dim=-2)
