"""Synthetic classification clouds (a numpy copy of
``mpa_tpu/data/synthetic.py::synthetic_clouds``, so the same seed gives the
same clouds in both packages)."""

from __future__ import annotations

from typing import Tuple

import numpy as np


def synthetic_clouds(
    num: int, num_points: int = 1024, num_classes: int = 15, seed: int = 0
) -> Tuple[np.ndarray, np.ndarray]:
    """Separable toy classification clouds: class c is a noisy ellipsoid with
    class-dependent axis ratios, learnable in a few steps. Returns
    ``(points [num, num_points, 3] float32, labels [num] int64)``."""
    r = np.random.default_rng(seed)
    labels = r.integers(0, num_classes, size=(num,))
    pts = r.normal(size=(num, num_points, 3)).astype(np.float32)
    scales = 0.5 + np.stack(
        [
            1.0 + (labels % 3),
            1.0 + ((labels // 3) % 3),
            1.0 + ((labels // 9) % 3),
        ],
        axis=-1,
    ).astype(np.float32)
    pts = pts * scales[:, None, :] * 0.2
    return pts, labels.astype(np.int64)
