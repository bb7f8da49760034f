"""Geometry of the umbrella surface constructor: spherical coordinates,
triangle fans, normals, centroids, plane offsets and their repair
(counterpart of the parts of ``mpa_tpu.geometry`` that ``repsurf_ssg_2x``
runs)."""

from mpa_tpu_torch.geometry.spherical import xyz2sphere
from mpa_tpu_torch.geometry.surfaces import (
    cal_center,
    cal_const,
    cal_normal,
    check_nan_umbrella,
    random_flips,
)
from mpa_tpu_torch.geometry.umbrella import group_by_umbrella

__all__ = [
    "xyz2sphere",
    "cal_normal",
    "cal_center",
    "cal_const",
    "check_nan_umbrella",
    "random_flips",
    "group_by_umbrella",
]
