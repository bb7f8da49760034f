"""ShapeNetPart label layout: 16 categories / 50 global part labels (a copy
of the tables of ``mpa_tpu/data/shapenetpart.py``, reference
tool/train_partseg.py:21-41). The dataset's loader is not ported yet; the
synthetic part-seg clouds and the evaluation protocol use this layout."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# Category -> global part labels.
SEG_CLASSES: Dict[str, List[int]] = {
    "Earphone": [16, 17, 18],
    "Motorbike": [30, 31, 32, 33, 34, 35],
    "Rocket": [41, 42, 43],
    "Car": [8, 9, 10, 11],
    "Laptop": [28, 29],
    "Cap": [6, 7],
    "Skateboard": [44, 45, 46],
    "Mug": [36, 37],
    "Guitar": [19, 20, 21],
    "Bag": [4, 5],
    "Lamp": [24, 25, 26, 27],
    "Table": [47, 48, 49],
    "Airplane": [0, 1, 2, 3],
    "Pistol": [38, 39, 40],
    "Chair": [12, 13, 14, 15],
    "Knife": [22, 23],
}

# Alphabetical category order, the order that indexes the one-hot labels.
CATEGORIES: List[str] = sorted(SEG_CLASSES.keys())
SEG_PARTS: List[List[int]] = [SEG_CLASSES[c] for c in CATEGORIES]
NUM_CATEGORIES = len(CATEGORIES)
NUM_PARTS = 50


def to_categorical(labels: np.ndarray, num_classes: int = NUM_CATEGORIES) -> np.ndarray:
    """One-hot encode ``[B]`` -> ``[B, num_classes]`` float32."""
    return np.eye(num_classes, dtype=np.float32)[labels]
