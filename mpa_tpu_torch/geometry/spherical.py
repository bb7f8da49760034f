"""Cartesian to spherical and cylindrical coordinates, and the per-axis
polar angles of neighbour offsets.

Counterpart of ``mpa_tpu/geometry/spherical.py`` (``xyz2sphere``,
``convert_polar``, ``xyz2cylind``). ``xyz2sphere``: (rho, theta,
phi) with theta normalised to [0, 1] by 1/pi and phi by 1/(2 pi) + 0.5; a
point at the origin gets theta = 0.

``torch.where``, like ``jnp.where``, passes the gradient of the branch it
does not take on, times zero, and zero times a NaN or an infinity is NaN.
Grouped coordinates hold exact zeros (a centre's offset to itself, and every
backfilled slot of a ball), so each guard below is a double ``where``: the
unsafe operation never sees the value that would make its gradient NaN.
"""

from __future__ import annotations

import math

import torch


def xyz2sphere(xyz: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """``[..., 3]`` cartesian -> ``[..., 3]`` (rho, theta, phi).

    theta in [0, pi] (or [0, 1] normalised), phi in [-pi, pi] (or [0, 1]).
    """
    r2 = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    zero = r2 == 0.0
    one = torch.ones_like(r2)
    rho = torch.where(zero, torch.zeros_like(r2), torch.sqrt(torch.where(zero, one, r2)))
    z = xyz[..., 2:3]
    # The divide is guarded, and the ratio kept off +-1, where acos has an
    # infinite derivative.
    ratio = torch.clamp(z / torch.where(zero, one, rho), -1.0 + 1e-7, 1.0 - 1e-7)
    theta = torch.where(zero, torch.zeros_like(r2), torch.acos(ratio))
    # atan2(0, 0) has a NaN gradient; on the z axis x = 1 stands in, which
    # leaves the value (0) as it was.
    x, y = xyz[..., 0:1], xyz[..., 1:2]
    on_axis = (x == 0.0) & (y == 0.0)
    phi = torch.atan2(y, torch.where(on_axis, torch.ones_like(x), x))
    if normalize:
        theta = theta / math.pi
        phi = phi / (2.0 * math.pi) + 0.5
    return torch.cat([rho, theta, phi], dim=-1)


def convert_polar(neighbours: torch.Tensor, center: torch.Tensor):
    """Per-axis (azimuth, elevation) angles of the neighbours' offsets from
    their centre (``mpa_tpu/geometry/spherical.py::convert_polar``, off every
    live path): about each axis, the azimuth in the plane of the other two
    and the elevation against that plane. ``r_yz`` is ``sqrt(y^2 + z^2)``,
    as ``mpa_tpu`` corrects the reference's ``sqrt(y^2 + y^2)``.

    Args:
      neighbours, center: ``[B, N, K, 3]`` (the centre broadcasts over K).

    Returns:
      ``(x_alpha, x_beta, y_alpha, y_beta, z_alpha, z_beta)``, each
      ``[B, N, K]``.
    """
    rel = neighbours - center
    rel_x, rel_y, rel_z = rel[..., 0], rel[..., 1], rel[..., 2]
    r_xy = torch.sqrt(rel_x ** 2 + rel_y ** 2)
    r_zx = torch.sqrt(rel_z ** 2 + rel_x ** 2)
    r_yz = torch.sqrt(rel_y ** 2 + rel_z ** 2)
    z_beta = torch.atan2(rel_z, r_xy)
    z_alpha = torch.atan2(rel_y, rel_x)
    y_beta = torch.atan2(rel_y, r_zx)
    y_alpha = torch.atan2(rel_x, rel_z)
    x_beta = torch.atan2(rel_x, r_yz)
    x_alpha = torch.atan2(rel_z, rel_y)
    return x_alpha, x_beta, y_alpha, y_beta, z_alpha, z_beta


def xyz2cylind(xyz: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """``[..., 3]`` cartesian -> ``[..., 3]`` (rho, phi, z)
    (``mpa_tpu/geometry/spherical.py::xyz2cylind``, off every live path):
    rho clamped to [0, 1], z to [-1, 1]; normalised, phi by 1/(2 pi) + 0.5
    and z to (z + 1) / 2."""
    rho = torch.clamp(torch.sqrt(torch.sum(xyz[..., :2] ** 2, dim=-1, keepdim=True)), 0.0, 1.0)
    phi = torch.atan2(xyz[..., 1:2], xyz[..., 0:1])
    z = torch.clamp(xyz[..., 2:3], -1.0, 1.0)
    if normalize:
        phi = phi / (2.0 * math.pi) + 0.5
        z = (z + 1.0) / 2.0
    return torch.cat([rho, phi, z], dim=-1)
