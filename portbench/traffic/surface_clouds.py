"""Classification clouds on object surfaces, normalised to the unit sphere as
ScanObjectNN's scanned objects are: class c a fixed layout of three surface
primitives, each cloud drawn on it with a random z-rotation, scale and
jitter.

A frozen copy of ``mpa_tpu_torch/data/synthetic.py::realistic_clouds``
(``surface_clouds``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from portbench.traffic.primitives import class_spec, compose_cloud


def realistic_clouds(num: int, num_points: int = 1024, num_classes: int = 15, seed: int = 0
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """``(points [num, num_points, 3] float32, labels [num] int64)``."""
    specs = [class_spec(1000 + c, 3) for c in range(num_classes)]
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, num_classes, size=(num,))
    pts = np.empty((num, num_points, 3), dtype=np.float32)
    for i, c in enumerate(labels):
        pts[i] = compose_cloud(rng, specs[c], num_points)[0]
    return pts, labels.astype(np.int64)


def make(num: int, num_points: int, seed: int, cell: dict) -> Dict[str, np.ndarray]:
    """The traffic of ``num`` clouds: ``points``, ``labels`` (the cell's
    ``num_classes``)."""
    pts, labels = realistic_clouds(num, num_points, cell["num_classes"], seed)
    return {"points": pts, "labels": labels}
