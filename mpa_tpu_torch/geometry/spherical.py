"""Cartesian to spherical coordinates.

Counterpart of ``mpa_tpu/geometry/spherical.py::xyz2sphere``: (rho, theta,
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
