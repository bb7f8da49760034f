"""Geometry of the RepSurf surfaces: spherical and cylindrical
coordinates, polar angles, triangle fans, normals, centroids, plane offsets,
areas and their repair, the plain-kNN surface constructor and PCA
(counterpart of ``mpa_tpu.geometry``)."""

from mpa_tpu_torch.geometry.spherical import convert_polar, xyz2cylind, xyz2sphere
from mpa_tpu_torch.geometry.surfaces import (
    cal_area,
    cal_center,
    cal_const,
    cal_normal,
    check_nan,
    check_nan_umbrella,
    knn_surface_features,
    pca,
    random_flips,
)
from mpa_tpu_torch.geometry.umbrella import group_by_umbrella

__all__ = [
    "xyz2sphere",
    "xyz2cylind",
    "convert_polar",
    "cal_normal",
    "cal_center",
    "cal_const",
    "cal_area",
    "check_nan",
    "check_nan_umbrella",
    "knn_surface_features",
    "pca",
    "random_flips",
    "group_by_umbrella",
]
