"""Markov part-segmentation model (ShapeNetPart: 16 categories / 50 parts).

Counterpart of ``mpa_tpu/models/markov_partseg.py::MarkovPartSeg``: the
KeepHighResolutionPartSeg encoder-decoder producing 896-channel
per-point features, then the head ``conv8`` (896 -> 512) -> dropout ->
``conv9`` (256) -> ``conv10`` (128) -> ``conv11`` (Dense to ``num_parts``) and
``log_softmax``. Dropout acts in train mode only and draws its mask from the
``torch.Generator`` the caller passes; torch cannot reproduce JAX's random
bits, so parity runs use ``dropout=0``. In the window modes
(``neighbor_mode``) the cloud is Morton-sorted first and the log-probs are
put back in the input order. In train mode the encoder's FPS takes keyed
starts when ``fps_generator`` or ``fps_starts`` is given
(``nn/keephigh_partseg.py``), as ``mpa_tpu``'s takes them from ``rng``.

``compute_dtype=torch.bfloat16`` is ``mpa_tpu``'s mixed precision, in every
neighbour mode: the parameters stay float32, the encoder-decoder and
``conv8`` .. ``conv10`` compute in bf16, and ``conv11`` takes their output
widened to float32 (``mpa_tpu/models/markov_partseg.py:64-75``). The head
(``conv8`` .. ``conv11``) is the span ``block.head``
(``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.models.registry import register_model
from mpa_tpu_torch.nn.keephigh_partseg import KeepHighResolutionPartSeg
from mpa_tpu_torch.nn.linear import LinearUnit, check_compute_dtype, seeded_dropout
from mpa_tpu_torch.nn.window_mode import morton_sort, morton_unsort
from mpa_tpu_torch.utils.profiling import span


class MarkovPartSeg(nn.Module):
    def __init__(
        self,
        num_parts: int = 50,
        num_categories: int = 16,
        npoints: Sequence[int] = (1024, 512, 256, 128),
        channels: Sequence[int] = (64, 64, 64, 128, 256),
        residuals: Sequence[bool] = (True, False, False, True, True),
        num_neighbors: int = 8,
        dropout: float = 0.5,
        compute_dtype: Any = None,
        neighbor_mode: str = "exact",
        fps_min_band: int = 512,
        fps_min_samples: int = 64,
    ):
        super().__init__()
        check_compute_dtype(compute_dtype)
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout={dropout} must be in [0, 1)")
        self.dropout = dropout
        self.num_categories = num_categories
        self.keep_high = KeepHighResolutionPartSeg(
            npoints=npoints, channels=channels, residuals=residuals,
            num_neighbors=num_neighbors, num_categories=num_categories,
            dtype=compute_dtype, neighbor_mode=neighbor_mode, fps_min_band=fps_min_band,
            fps_min_samples=fps_min_samples,
        )
        self.conv8 = LinearUnit(self.keep_high.out_channels, 512, dtype=compute_dtype)
        self.conv9 = LinearUnit(512, 256, dtype=compute_dtype)
        self.conv10 = LinearUnit(256, 128, dtype=compute_dtype)
        self.conv11 = nn.Linear(128, num_parts)

    def forward(
        self,
        inputs: Tuple[torch.Tensor, torch.Tensor],
        *,
        generator: Optional[torch.Generator] = None,
        fps_generator: Optional[torch.Generator] = None,
        fps_starts: Optional[Sequence[torch.Tensor]] = None,
    ) -> torch.Tensor:
        """inputs = (points ``[B, N, 3]``, label_onehot ``[B, num_categories]``)
        -> per-point log-probs ``[B, N, num_parts]``.

        ``generator`` (on the points' device) draws the dropout mask; train
        mode with ``dropout > 0`` requires it.
        """
        points, label_onehot = inputs
        xyz, inv_perm = points[..., :3], None
        if self.keep_high.windowed:
            xyz, inv_perm = morton_sort(xyz)
        x = self.keep_high(xyz, label_onehot, fps_generator=fps_generator,
                           fps_starts=fps_starts)
        with span("block.head"):
            x = seeded_dropout(self.conv8(x), self.dropout, self.training, generator)
            x = self.conv10(self.conv9(x))
            # conv11 has no compute dtype: its weight's type promotes the input.
            x = x.to(torch.promote_types(x.dtype, self.conv11.weight.dtype))
            return morton_unsort(F.log_softmax(self.conv11(x), dim=-1), inv_perm)


@register_model("markov_partseg")
def _markov_partseg(**kw) -> MarkovPartSeg:
    return MarkovPartSeg(**kw)
