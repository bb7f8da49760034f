"""Part-segmentation clouds in ShapeNetPart's layout: 16 categories, 50
global parts, each category's shape one primitive a part, every point
labelled with its part.

A frozen copy of ``mpa_tpu_torch/data/synthetic.py::realistic_partseg`` and
of the category table of ``mpa_tpu_torch/data/shapenetpart.py`` (the
reference's ``tool/train_partseg.py:21-41``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from portbench.traffic.primitives import class_spec, compose_cloud

SEG_CLASSES: Dict[str, List[int]] = {
    "Earphone": [16, 17, 18], "Motorbike": [30, 31, 32, 33, 34, 35], "Rocket": [41, 42, 43],
    "Car": [8, 9, 10, 11], "Laptop": [28, 29], "Cap": [6, 7], "Skateboard": [44, 45, 46],
    "Mug": [36, 37], "Guitar": [19, 20, 21], "Bag": [4, 5], "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49], "Airplane": [0, 1, 2, 3], "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15], "Knife": [22, 23],
}
# Alphabetical category order, the order that indexes the one-hot labels.
SEG_PARTS: List[List[int]] = [SEG_CLASSES[c] for c in sorted(SEG_CLASSES)]


def realistic_partseg(num: int, num_points: int = 2048, seed: int = 0
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``(points [num, num_points, 3] float32, category [num] int64,
    per-point part labels [num, num_points] int64)``; every part keeps at
    least 5% of its cloud's points."""
    specs = [class_spec(2000 + c, len(parts)) for c, parts in enumerate(SEG_PARTS)]
    rng = np.random.default_rng(seed)
    cats = rng.integers(0, len(SEG_PARTS), size=(num,))
    pts = np.empty((num, num_points, 3), dtype=np.float32)
    labels = np.empty((num, num_points), dtype=np.int64)
    for i in range(num):
        c = int(cats[i])
        part_ids = np.asarray(SEG_PARTS[c])
        w = rng.dirichlet(np.full(len(part_ids), 6.0))
        w = 0.05 + 0.95 * w
        w = w / w.sum()
        pts[i], pid = compose_cloud(rng, specs[c], num_points, weights=w)
        labels[i] = part_ids[pid]
    return pts, cats.astype(np.int64), labels


def make(num: int, num_points: int, seed: int, cell: dict) -> Dict[str, np.ndarray]:
    """The traffic of ``num`` clouds: ``points``, ``category``, ``labels``."""
    pts, cats, labels = realistic_partseg(num, num_points, seed)
    return {"points": pts, "category": cats, "labels": labels}
