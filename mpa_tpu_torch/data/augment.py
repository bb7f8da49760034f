"""Point-cloud augmentations on the device (counterpart of
``mpa_tpu/data/augment.py``), on channel-last ``[B, N, C]`` batches.

Each random augmentation is a draw and a deterministic core. The draw takes
its numbers from the caller's ``torch.Generator``, which lies on the points'
device, so a batch on the card is augmented without a host round trip. The
core takes the drawn values: ``scale_points(points, s)``,
``shift_points(points, t)``, the rotations by given angles, dropout by a
given mask and a shuffle by given permutations. Torch cannot replay JAX's
PRNG streams, so the cores are what is held against ``mpa_tpu``, on the very
values JAX drew.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def _rand(generator: torch.Generator, shape, like: torch.Tensor) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=like.device, dtype=like.dtype)


def _uniform(generator: torch.Generator, shape, like: torch.Tensor, low: float,
             high: float) -> torch.Tensor:
    return low + (high - low) * _rand(generator, shape, like)


def normalize_point_cloud(points: torch.Tensor) -> torch.Tensor:
    """Centre and scale each cloud to the unit sphere (reference pc_normalize)."""
    centred = points - points.mean(dim=-2, keepdim=True)
    scale = centred.square().sum(-1, keepdim=True).sqrt().amax(dim=-2, keepdim=True)
    return centred / scale.clamp_min(1e-12)


# -- scale and shift ---------------------------------------------------------------


def scale_points(points: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Every channel of cloud b times ``scale[b]`` (``[B, 1, 1]``)."""
    return points * scale


def shift_points(points: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Every point of cloud b plus ``shift[b]`` (``[B, 1, C]``, all channels)."""
    return points + shift


def draw_scales(generator: torch.Generator, n: int, like: torch.Tensor, low: float = 0.8,
                high: float = 1.25) -> torch.Tensor:
    """``n`` clouds' scales for :func:`scale_points` (``[n, 1, 1]``)."""
    return _uniform(generator, (n, 1, 1), like, low, high)


def draw_shifts(generator: torch.Generator, n: int, like: torch.Tensor,
                shift_range: float = 0.1) -> torch.Tensor:
    """``n`` clouds' shifts for :func:`shift_points` (``[n, 1, C]``, ``C``
    the channels of ``like``)."""
    return _uniform(generator, (n, 1, like.shape[-1]), like, -shift_range, shift_range)


def random_scale(points: torch.Tensor, generator: torch.Generator, low: float = 0.8,
                 high: float = 1.25) -> torch.Tensor:
    """Per-cloud isotropic scale in ``[low, high)`` (reference
    random_scale_point_cloud)."""
    return scale_points(points, draw_scales(generator, points.shape[0], points, low, high))


def random_shift(points: torch.Tensor, generator: torch.Generator,
                 shift_range: float = 0.1) -> torch.Tensor:
    """Per-cloud translation of every channel in ``[-shift_range,
    shift_range)`` (reference shift_point_cloud)."""
    return shift_points(points, draw_shifts(generator, points.shape[0], points, shift_range))


# -- jitter ------------------------------------------------------------------------


def jitter_points(points: torch.Tensor, normal: torch.Tensor, sigma: float = 0.01,
                  clip: float = 0.05) -> torch.Tensor:
    """``points`` plus ``sigma * normal`` clipped to ``[-clip, clip]``;
    ``normal`` is a standard normal draw of the points' shape."""
    return points + torch.clamp(sigma * normal, -clip, clip)


def random_jitter(points: torch.Tensor, generator: torch.Generator, sigma: float = 0.01,
                  clip: float = 0.05) -> torch.Tensor:
    """Clipped gaussian per-point jitter (reference jitter_point_cloud)."""
    normal = torch.randn(points.shape, generator=generator, device=points.device,
                         dtype=points.dtype)
    return jitter_points(points, normal, sigma, clip)


# -- rotations ---------------------------------------------------------------------


def _matrices(*rows) -> torch.Tensor:
    """``[B, 3, 3]`` from nine ``[B]`` entries in row order."""
    return torch.stack(rows, dim=-1).reshape(rows[0].shape + (3, 3))


def _rot_y(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return _matrices(c, zeros, s, zeros, ones, zeros, -s, zeros, c)


def _rot_z(a: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a), torch.sin(a)
    zeros, ones = torch.zeros_like(c), torch.ones_like(c)
    return _matrices(c, -s, zeros, s, c, zeros, zeros, zeros, ones)


def _rot_perturb(angles: torch.Tensor) -> torch.Tensor:
    cx, sx = torch.cos(angles[:, 0]), torch.sin(angles[:, 0])
    cy, sy = torch.cos(angles[:, 1]), torch.sin(angles[:, 1])
    cz, sz = torch.cos(angles[:, 2]), torch.sin(angles[:, 2])
    zeros, ones = torch.zeros_like(cx), torch.ones_like(cx)
    rx = _matrices(ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx)
    ry = _matrices(cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy)
    rz = _matrices(cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones)
    return rz @ ry @ rx


def rotate_points(points: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Rotate xyz (channels 0:3) and, when present, the normals (3:6) of
    cloud b by ``rot[b]`` (``[B, 3, 3]``, applied as ``p @ rot``); later
    channels pass through."""
    out = [points[..., :3] @ rot]
    if points.shape[-1] >= 6:
        out.append(points[..., 3:6] @ rot)
    if points.shape[-1] > 6:
        out.append(points[..., 6:])
    return torch.cat(out, dim=-1) if len(out) > 1 else out[0]


def rotate_by_angle(points: torch.Tensor, angle) -> torch.Tensor:
    """Up-axis (y) rotation by ``angle`` (scalar or per-cloud ``[B]``) of
    xyz and normals (reference rotate_point_cloud_by_angle[_with_normal])."""
    a = torch.as_tensor(angle, dtype=points.dtype, device=points.device)
    return rotate_points(points, _rot_y(a.expand(points.shape[0])))


def rotate_z_by_angle(points: torch.Tensor, angle) -> torch.Tensor:
    """Rotation about z by ``angle`` (scalar or ``[B]``) of xyz and normals."""
    a = torch.as_tensor(angle, dtype=points.dtype, device=points.device)
    return rotate_points(points, _rot_z(a.expand(points.shape[0])))


def rotate_perturb_by_angles(points: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotation of xyz and normals by ``rz @ ry @ rx`` of ``angles`` ``[B, 3]``
    (about x, y, z)."""
    return rotate_points(points, _rot_perturb(angles))


def draw_angles(generator: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    """``[B]`` angles uniform in ``[0, 2 pi)``."""
    return _uniform(generator, (points.shape[0],), points, 0.0, 2.0 * math.pi)


def draw_perturb_angles(generator: torch.Generator, points: torch.Tensor,
                        angle_sigma: float = 0.06, angle_clip: float = 0.18) -> torch.Tensor:
    """``[B, 3]`` angles ``sigma * N(0, 1)`` clipped to ``[-clip, clip]``."""
    normal = torch.randn((points.shape[0], 3), generator=generator, device=points.device,
                         dtype=points.dtype)
    return torch.clamp(angle_sigma * normal, -angle_clip, angle_clip)


def random_rotate_y(points: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Random rotation about the up (y) axis (reference rotate_point_cloud)."""
    return rotate_by_angle(points, draw_angles(generator, points))


def random_rotate_z(points: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Random rotation about z (reference rotate_point_cloud_z)."""
    return rotate_z_by_angle(points, draw_angles(generator, points))


def random_rotate_perturb(points: torch.Tensor, generator: torch.Generator,
                          angle_sigma: float = 0.06, angle_clip: float = 0.18) -> torch.Tensor:
    """Small rotations about all three axes (reference
    rotate_perturbation_point_cloud)."""
    return rotate_perturb_by_angles(
        points, draw_perturb_angles(generator, points, angle_sigma, angle_clip))


def random_rotate_y_with_normal(points: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """:func:`random_rotate_y` of a ``[B, N, 6]`` batch: xyz and normals
    (reference rotate_point_cloud_with_normal)."""
    return random_rotate_y(points, generator)


def random_rotate_perturb_with_normal(points: torch.Tensor, generator: torch.Generator,
                                      angle_sigma: float = 0.06,
                                      angle_clip: float = 0.18) -> torch.Tensor:
    """:func:`random_rotate_perturb` of xyz and normals (reference
    rotate_perturbation_point_cloud_with_normal)."""
    return random_rotate_perturb(points, generator, angle_sigma, angle_clip)


# -- dropout and shuffle ------------------------------------------------------------


def dropout_points(points: torch.Tensor, drop: torch.Tensor) -> torch.Tensor:
    """Replace the points where ``drop`` (``[B, N]`` bool) holds by the
    cloud's first point (shapes stay static)."""
    return torch.where(drop[..., None], points[:, :1, :], points)


def draw_dropout_mask(generator: torch.Generator, points: torch.Tensor,
                      max_dropout_ratio: float = 0.875) -> torch.Tensor:
    """``[B, N]``: each cloud draws a ratio in ``[0, 1)``, then drops each
    point with probability ``ratio * max_dropout_ratio``."""
    B, N, _ = points.shape
    ratio = _rand(generator, (B, 1), points)
    return _rand(generator, (B, N), points) <= ratio * max_dropout_ratio


def random_point_dropout(points: torch.Tensor, generator: torch.Generator,
                         max_dropout_ratio: float = 0.875) -> torch.Tensor:
    """Reference random_point_dropout, with static shapes."""
    return dropout_points(points, draw_dropout_mask(generator, points, max_dropout_ratio))


def permute_points(points: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Cloud b's points in the order ``perm[b]`` (``[B, N]``)."""
    return torch.gather(points, 1, perm[..., None].expand(-1, -1, points.shape[-1]))


def draw_permutations(generator: torch.Generator, points: torch.Tensor) -> torch.Tensor:
    """``[B, N]`` independent uniform permutations, one a cloud."""
    B, N, _ = points.shape
    return torch.argsort(_rand(generator, (B, N), points), dim=-1)


def shuffle_points(points: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Independent per-cloud point permutation (reference shuffle_points)."""
    return permute_points(points, draw_permutations(generator, points))


# -- the flag-gated train augmentation -------------------------------------------------


def get_aug_args(dataset: str) -> Dict[str, float]:
    """Per-dataset augmentation magnitudes (reference modules/ptaug_utils.py:13-24)."""
    if dataset.lower() in ("scanobjectnn", "scanobject"):
        return {"scale_factor": 0.5, "shift_factor": 0.3}
    return {"scale_factor": 0.25, "shift_factor": 0.2}


def transform_point_cloud(
    points: torch.Tensor,
    generator: torch.Generator,
    *,
    aug_scale: bool = False,
    aug_shift: bool = False,
    scale_factor: float = 0.5,
    shift_factor: float = 0.3,
) -> torch.Tensor:
    """The reference's flag-gated train augmentation
    (modules/ptaug_utils.py:27-45): a per-cloud scale in ``1 +- scale_factor``,
    then a shift in ``+-shift_factor``."""
    if aug_scale:
        points = random_scale(points, generator, 1.0 - scale_factor, 1.0 + scale_factor)
    if aug_shift:
        points = random_shift(points, generator, shift_factor)
    return points
