"""Triangle surface features: unit normals, centroids, plane offsets,
areas, the repair of degenerate triangles, the plain-kNN surface
constructor and PCA.

Counterpart of ``mpa_tpu/geometry/surfaces.py``: ``cal_normal``,
``cal_center``, ``cal_const`` and ``check_nan_umbrella``, which the
umbrella constructor runs, and ``cal_area``, ``check_nan``,
``knn_surface_features`` and ``pca``, which no model runs. As there, a
degenerate triangle (repeated points) gets a ZERO normal rather than the
reference's NaN, so no NaN reaches a gradient, and the repair detects a zero
normal exactly as it detects a NaN.

The train-time random inversion draws one sign per cloud. ``mpa_tpu`` draws
it from a JAX key; here the caller passes the ``[B]`` signs (+1 or -1),
which :func:`random_flips` draws from a ``torch.Generator``, so a test can
hand both implementations the same signs.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.ops.knn import knn


def random_flips(batch: int, generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """``[batch]`` float32 signs, each -1 or +1 with probability 1/2, drawn
    from ``generator`` (on ``device``), as ``jax.random.randint(key, (B,), 0,
    2) * 2 - 1`` draws them in ``mpa_tpu``."""
    bits = torch.randint(0, 2, (batch,), generator=generator, device=device)
    return bits.to(torch.float32) * 2.0 - 1.0


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``jnp.cross``'s terms, each product rounded on its own (no fused
    multiply-add), so two equal edges give exactly zero."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def cal_normal(
    group_xyz: torch.Tensor,
    *,
    flips: Optional[torch.Tensor] = None,
    is_group: bool = False,
) -> torch.Tensor:
    """Unit triangle normals with the sign fix, and optionally flipped per
    cloud.

    Args:
      group_xyz: ``[B, N, 3pts, 3]`` or ``[B, N, G, 3pts, 3]`` triangles.
      flips: optional ``[B]`` signs (+1 or -1) multiplied into each cloud's
        normals (the train-time random inversion).
      is_group: the sign fix takes the first triangle's x component per
        (B, N) and applies it to all G.

    Returns:
      ``[B, N, 3]`` / ``[B, N, G, 3]`` unit normals, zero where the triangle
      is degenerate.
    """
    e1 = group_xyz[..., 1, :] - group_xyz[..., 0, :]
    e2 = group_xyz[..., 2, :] - group_xyz[..., 0, :]
    nor = _cross(e1, e2)
    n2 = torch.sum(nor * nor, dim=-1, keepdim=True)
    degen = n2 == 0.0
    unit = torch.where(degen, torch.zeros_like(nor),
                       nor / torch.sqrt(torch.where(degen, torch.ones_like(n2), n2)))
    first_x = unit[..., 0:1, 0] if is_group else unit[..., 0]
    pos_mask = torch.where(first_x > 0, 1.0, -1.0).to(unit.dtype)
    unit = unit * pos_mask[..., None]
    if flips is not None:
        B = group_xyz.shape[0]
        if tuple(flips.shape) != (B,):
            raise ValueError(f"flips must be [B={B}], got {tuple(flips.shape)}")
        unit = unit * flips.to(unit.dtype).reshape((B,) + (1,) * (unit.dim() - 1))
    return unit


def cal_center(group_xyz: torch.Tensor) -> torch.Tensor:
    """Triangle centroid: the mean over the points axis, ``[..., 3pts, 3] ->
    [..., 3]``."""
    return torch.mean(group_xyz, dim=-2)


def cal_const(normal: torch.Tensor, center: torch.Tensor,
              is_normalize: bool = True) -> torch.Tensor:
    """Plane offset ``<n, c>``, divided by sqrt(3) when ``is_normalize``,
    ``[..., 1]``."""
    const = torch.sum(normal * center, dim=-1, keepdim=True)
    return const / math.sqrt(3.0) if is_normalize else const


def check_nan_umbrella(
    normal: torch.Tensor,
    center: torch.Tensor,
    pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """Repair each umbrella fan's invalid rows.

    For each (B, N), the rows along G whose normal is invalid (any NaN, or
    all zero: a degenerate triangle) are replaced, in ``normal``, ``center``
    and ``pos``, by the fan's first valid row; a fan with no valid row takes
    its row 0. ``normal``/``center`` ``[B, N, G, 3]``, ``pos`` ``[B, N, G, 1]``.
    """
    bad = torch.isnan(normal).any(dim=-1) | (normal == 0.0).all(dim=-1)  # [B, N, G]
    first_ok = torch.argmax((~bad).to(torch.int32), dim=-1)  # the first maximum

    def take_first(x: torch.Tensor) -> torch.Tensor:
        index = first_ok[..., None, None].expand(*first_ok.shape, 1, x.shape[-1])
        picked = torch.gather(x, 2, index)
        return torch.where(bad[..., None], picked, x)

    if pos is not None:
        return take_first(normal), take_first(center), take_first(pos)
    return take_first(normal), take_first(center)


def cal_area(group_xyz: torch.Tensor) -> torch.Tensor:
    """Triangle area from the three projected-plane determinants,
    ``[..., 3pts, 3] -> [..., 1]`` (``mpa_tpu``'s ``cal_area``, off every
    live path)."""
    x, y, z = group_xyz[..., 0], group_xyz[..., 1], group_xyz[..., 2]

    def det3(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        # | u0 v0 1 ; u1 v1 1 ; u2 v2 1 |
        return (u[..., 0] * (v[..., 1] - v[..., 2]) - v[..., 0] * (u[..., 1] - u[..., 2])
                + (u[..., 1] * v[..., 2] - u[..., 2] * v[..., 1]))

    area = torch.sqrt(det3(x, y) ** 2 + det3(y, z) ** 2 + det3(z, x) ** 2)
    return area[..., None]


def check_nan(
    normal: torch.Tensor,
    center: torch.Tensor,
    pos: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, ...]:
    """The repair of :func:`check_nan_umbrella` over each cloud instead of
    each fan (``mpa_tpu``'s ``check_nan``): the points whose normal is
    invalid (any NaN, or all zero) take the cloud's first valid point's
    ``normal``, ``center`` and ``pos``; a cloud with none takes its point 0.
    ``[B, N, C]`` each."""
    bad = torch.isnan(normal).any(dim=-1) | (normal == 0.0).all(dim=-1)  # [B, N]
    first_ok = torch.argmax((~bad).to(torch.int32), dim=-1)  # [B], the first maximum

    def take_first(x: torch.Tensor) -> torch.Tensor:
        picked = torch.gather(x, 1, first_ok[:, None, None].expand(-1, 1, x.shape[-1]))
        return torch.where(bad[..., None], picked, x)

    if pos is not None:
        return take_first(normal), take_first(center), take_first(pos)
    return take_first(normal), take_first(center)


def knn_surface_features(
    center: torch.Tensor,
    context: torch.Tensor,
    k: int = 3,
    *,
    return_dist: bool = False,
    flips: Optional[torch.Tensor] = None,
):
    """The plain-kNN triangle surface constructor (``mpa_tpu``'s
    ``knn_surface_features``, off every live path): each centre's k nearest
    context points (``knn``: ``knn_kernel`` on the card; the indices only,
    so no gradient flows through the search) gathered (``index_points``:
    ``gather_rows_kernel``), their first three a triangle whose unit normal
    (flipped per cloud by ``flips``, ``[B]`` signs, where given: the
    train-time inversion that ``mpa_tpu`` draws from a key), centroid and,
    with ``return_dist``, plane offset are the features, repaired by
    :func:`check_nan`.

    Returns ``(normal [B, N, 3], centroid [B, N, 3][, pos [B, N, 1]])``.
    """
    _, idx = knn(k, context.detach(), center.detach())
    group_xyz = index_points(context, idx)  # [B, N, K, 3]
    normal = cal_normal(group_xyz, flips=flips)
    centroid = cal_center(group_xyz)
    if return_dist:
        return check_nan(normal, centroid, cal_const(normal, centroid))
    return check_nan(normal, centroid)


def pca(x: torch.Tensor, k: int, center: bool = True) -> dict:
    """SVD principal components of ``x [n, d]`` (``mpa_tpu``'s ``pca``, off
    every live path): ``{"X": x, "k": k, "components": [d, k], the top k
    right singular vectors as columns, "explained_variance": [k], s^2 /
    (n - 1)}``. Each column's sign is the SVD's, so it may be the opposite
    of ``mpa_tpu``'s."""
    n = x.shape[0]
    xc = x - torch.mean(x, dim=0, keepdim=True) if center else x
    _, s, vt = torch.linalg.svd(xc, full_matrices=False)
    return {"X": x, "k": k, "components": vt[:k].T,
            "explained_variance": (s[:k] ** 2) / (n - 1)}
