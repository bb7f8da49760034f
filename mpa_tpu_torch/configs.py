"""Training configuration and presets (the fields of
``mpa_tpu/utils/config.py::TrainConfig`` that the ported paths read, and
the presets of ``mpa_tpu/configs/presets.py`` that the port runs)."""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    model: str = "markov_cls"
    num_classes: int = 15
    num_points: int = 1024
    batch_size: int = 64
    # optimisation (reference cls defaults: Adam 1e-3 / wd 1e-4 / StepLR 20x0.7)
    optimizer: str = "adam-l2"  # 'adam-l2' | 'sgd'
    learning_rate: float = 1e-3
    weight_decay: float = 1e-4
    momentum: float = 0.9
    decay_step: int = 20
    decay_gamma: float = 0.7
    epochs: int = 300
    label_smoothing: float = 0.1
    seed: int = 2800

    def with_overrides(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)


PRESETS = {
    # ScanObjectNN classification (published 86.20% OA), 1024-point clouds:
    # batch 64, Adam 1e-3 / wd 1e-4, StepLR 20 x 0.7, 300 epochs, seed 2800.
    "scanobjectnn_cls": TrainConfig(
        model="markov_cls", num_classes=15, num_points=1024, batch_size=64,
        optimizer="adam-l2", learning_rate=1e-3, weight_decay=1e-4,
        decay_step=20, decay_gamma=0.7,
        epochs=300, seed=2800,
    ),
}
