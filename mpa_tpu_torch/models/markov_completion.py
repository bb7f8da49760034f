"""Shape completion over the Markov classification encoder.

Counterpart of ``mpa_tpu/models/markov_completion.py::MarkovCompletion``:
the encoder's global feature seeds ``num_coarse`` points through a FC
decoder (``dec1`` -> ``dec2`` -> ``dec3``); a folding refinement then gives
each coarse point ``up_ratio`` children: the point, a grid code
(``up_ratio`` values evenly spaced over [-0.05, 0.05], ``fold_grid``) and
the global feature go through ``fold1`` -> ``fold2`` -> ``fold3``, whose
output offsets the point. With ``include_input`` the observed partial cloud
is put in front of the fine output. Trained on
``train/losses.py::completion_loss``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mpa_tpu_torch.models.registry import register_model
from mpa_tpu_torch.nn.keephigh import KeepHighResolutionEncoder
from mpa_tpu_torch.nn.linear import LinearUnit


def fold_grid(r: int) -> np.ndarray:
    """The ``r`` grid codes in float32 by ``jnp.linspace``'s formula:
    ``t_i = i / (r - 1)``, ``start * (1 - t_i) + stop * t_i`` for ``i < r -
    1`` and ``stop`` itself last, each operation rounded to float32. XLA
    may contract or fold that formula in other ways by context (eager,
    jitted, fused into a product); for ``r <= 4``, the model's 4 included,
    every context gives these values."""
    start, stop = np.float32(-0.05), np.float32(0.05)
    if r == 1:
        return np.array([start], np.float32)
    t = np.arange(r - 1, dtype=np.float32) / np.float32(r - 1)
    head = start * (np.float32(1) - t) + stop * t
    return np.concatenate([head, [stop]]).astype(np.float32)


class MarkovCompletion(nn.Module):
    def __init__(
        self,
        num_coarse: int = 256,
        up_ratio: int = 4,
        npoints: Sequence[int] = (512, 256, 128, 64, 32),
        channels: Sequence[int] = (64, 64, 64, 128, 256, 512),
        residuals: Sequence[bool] = (True, False, False, True, True, True),
        num_neighbors: int = 8,
        encoder_features: int = 1024,
        include_input: bool = True,
    ):
        super().__init__()
        self.num_coarse, self.up_ratio, self.include_input = num_coarse, up_ratio, include_input
        self.keep_high = KeepHighResolutionEncoder(
            npoints=npoints, channels=channels, residuals=residuals,
            num_neighbors=num_neighbors, out_features=encoder_features,
        )
        self.dec1 = LinearUnit(encoder_features, 1024)
        self.dec2 = LinearUnit(1024, 1024)
        self.dec3 = nn.Linear(1024, num_coarse * 3)
        self.fold1 = LinearUnit(3 + 1 + encoder_features, 256)
        self.fold2 = LinearUnit(256, 128)
        self.fold3 = nn.Linear(128, 3)
        self.register_buffer("grid", torch.from_numpy(fold_grid(up_ratio)), persistent=False)

    def forward(self, points: torch.Tensor, *,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """partial cloud ``[B, N, 3]`` -> (coarse ``[B, M, 3]``, fine ``[B,
        M * up_ratio (+ N with include_input), 3]``); the model has no
        dropout, so ``generator`` is unused."""
        B = points.shape[0]
        M, r = self.num_coarse, self.up_ratio
        g = self.keep_high(points[..., :3])
        coarse = self.dec3(self.dec2(self.dec1(g))).reshape(B, M, 3)
        centre = coarse[:, :, None, :].expand(B, M, r, 3)
        grid = self.grid.to(g.dtype)[None, None, :, None].expand(B, M, r, 1)
        gfeat = g[:, None, None, :].expand(B, M, r, g.shape[-1])
        fold = self.fold2(self.fold1(torch.cat([centre, grid, gfeat], dim=-1)))
        fine = (centre + self.fold3(fold)).reshape(B, M * r, 3)
        if self.include_input:
            fine = torch.cat([points[..., :3], fine], dim=1)
        return coarse, fine


@register_model("markov_completion")
def _markov_completion(**kw) -> MarkovCompletion:
    return MarkovCompletion(**kw)
