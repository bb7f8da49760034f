"""Per-epoch learning-rate schedules (counterparts of
``mpa_tpu/train/schedules.py``).

StepLR(step_size, gamma) for classification and CosineAnnealingLR(T_max,
eta_min) for part segmentation. The reference steps its scheduler before the
first epoch's batches, so epoch ``e`` trains at
``lr0 * gamma^floor((e + 1) / step)``; ``epoch_offset=1`` reproduces that for
strict-parity runs, ``0`` is the default.
"""

from __future__ import annotations

import math
from typing import Callable

Schedule = Callable[[int], float]


def step_decay_schedule(
    base_lr: float, step_size: int, gamma: float, *, epoch_offset: int = 0
) -> Schedule:
    def schedule(epoch: int) -> float:
        return base_lr * gamma ** math.floor((epoch + epoch_offset) / step_size)

    return schedule


def cosine_schedule(base_lr: float, total_epochs: int, eta_min: float = 0.0) -> Schedule:
    def schedule(epoch: int) -> float:
        t = min(max(epoch / total_epochs, 0.0), 1.0)
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + math.cos(math.pi * t))

    return schedule
