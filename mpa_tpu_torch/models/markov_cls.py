"""Markov-process point-cloud classifier (flagship model).

Counterpart of ``mpa_tpu/models/markov_cls.py::MarkovClassifier``: the
KeepHighResolution encoder, then the head ``fc1 -> bn1 -> LeakyReLU ->
dropout -> fc2 -> bn2 -> LeakyReLU -> dropout -> fc3`` and ``log_softmax``.
Dropout acts in train mode only and draws its masks from the
``torch.Generator`` the caller passes (flax's ``nn.Dropout``: keep with
probability ``1 - dropout``, scale kept values by ``1 / (1 - dropout)``);
torch cannot reproduce JAX's random bits, so parity runs use ``dropout=0``.

``use_umbrella`` builds the umbrella surface constructor as
``surface_constructor``, as ``mpa_tpu`` does for parity with the reference
checkpoint: its output is unused, so it changes nothing but its BatchNorm
statistics, and it runs only in train mode (in eval mode it has no effect;
XLA drops it there too). Its normal flips come from ``flips`` or, before
the dropout masks, from the generator; ``umbrella_k`` and
``umbrella_aggr`` are its ``k`` and ``aggr_type``.

``fps_generator`` and ``fps_starts`` reach the encoder, whose FPS scales
take them in train mode when its ``fps_random_start`` is set
(``nn/keephigh.py``); ``mpa_tpu``'s classifier leaves that switch off, as
this one builds it.

``compute_dtype=torch.bfloat16`` is ``mpa_tpu``'s mixed precision: the
parameters stay float32, the encoder computes in bf16 up to its pooled
feature (``nn/keephigh.py``), and the head ``fc1`` .. ``fc3`` runs in
float32 (``mpa_tpu/models/markov_cls.py:61-77``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.models.registry import register_model
from mpa_tpu_torch.nn.keephigh import KeepHighResolutionEncoder
from mpa_tpu_torch.nn.linear import BatchNorm, check_compute_dtype, seeded_dropout
from mpa_tpu_torch.nn.umbrella_constructor import UmbrellaSurfaceConstructor


class MarkovClassifier(nn.Module):
    def __init__(
        self,
        num_classes: int = 15,
        npoints: Sequence[int] = (512, 256, 128, 64, 32),
        channels: Sequence[int] = (64, 64, 64, 128, 256, 512),
        residuals: Sequence[bool] = (True, False, False, True, True, True),
        num_neighbors: int = 8,
        encoder_features: int = 1024,
        dropout: float = 0.5,
        use_umbrella: bool = False,
        compute_dtype: Any = None,
        umbrella_k: int = 9,
        umbrella_aggr: str = "sum",
    ):
        super().__init__()
        check_compute_dtype(compute_dtype)
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout={dropout} must be in [0, 1)")
        self.dropout = dropout
        self.surface_constructor = None
        if use_umbrella:
            self.surface_constructor = UmbrellaSurfaceConstructor(k=umbrella_k,
                                                                  aggr_type=umbrella_aggr)
        self.keep_high = KeepHighResolutionEncoder(
            npoints=npoints, channels=channels, residuals=residuals,
            num_neighbors=num_neighbors, out_features=encoder_features, dtype=compute_dtype,
        )
        self.fc1 = nn.Linear(encoder_features, 512)
        self.bn1 = BatchNorm(512)
        self.fc2 = nn.Linear(512, 256)
        self.bn2 = BatchNorm(256)
        self.fc3 = nn.Linear(256, num_classes)

    def forward(
        self, points: torch.Tensor, *, generator: Optional[torch.Generator] = None,
        flips: Optional[torch.Tensor] = None,
        fps_generator: Optional[torch.Generator] = None,
        fps_starts: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """points: ``[B, N, 3]`` xyz -> ``[B, num_classes]`` log-probs.

        ``generator`` (on the points' device) draws the dropout masks; train
        mode with ``dropout > 0`` requires it. With ``use_umbrella`` in train
        mode it draws the umbrella's normal flips first, unless ``flips``
        (``[B]`` signs) gives them. ``fps_generator`` / ``fps_starts``: the
        encoder's keyed FPS starts (module doc).
        """
        xyz = points[..., :3]
        if self.surface_constructor is not None and self.training:
            self.surface_constructor(xyz, generator=generator, flips=flips)
        x = self.keep_high(xyz, fps_generator=fps_generator, fps_starts=fps_starts)
        for fc, bn in ((self.fc1, self.bn1), (self.fc2, self.bn2)):
            x = F.leaky_relu(bn(fc(x)), negative_slope=0.2)
            x = seeded_dropout(x, self.dropout, self.training, generator)
        return F.log_softmax(self.fc3(x), dim=-1)


@register_model("markov_cls")
def _markov_cls(**kw) -> MarkovClassifier:
    return MarkovClassifier(**kw)
