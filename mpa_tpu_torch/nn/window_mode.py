"""Shared wiring of the Morton-window neighbour modes.

Counterpart of ``mpa_tpu/nn/window_mode.py``. The modes (``ops/window.py``)
are exposed by ``markov_semseg``, ``markov_partseg`` and ``Fuse``; their
plumbing is defined once here:

- ``'exact'`` (the default everywhere): the reference semantics;
- ``'window'``: Morton-sorted input, the SPATIAL searches, their attention
  and the decoder's scatter-mean banded; the feature-space kNN stays exact;
- ``'window_all'``: the feature-space kNN and FPS banded too, the full
  large-scene mode.

:func:`morton_sort` and :func:`morton_unsort` are the spans
``window.morton_sort`` and ``window.morton_unsort`` (``utils/profiling.py``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from mpa_tpu_torch.ops.fps import banded_farthest_point_sample, keyed_start, pick_fps_bands
from mpa_tpu_torch.ops.morton import morton_order
from mpa_tpu_torch.ops.scatter import scatter_mean_upsample
from mpa_tpu_torch.ops.window import WindowSpec, make_window_spec, windowed_scatter_mean
from mpa_tpu_torch.utils.profiling import span

NEIGHBOR_MODES = ("exact", "window", "window_all")


def check_mode(name: str, mode: str, allowed) -> str:
    if mode not in allowed:
        raise ValueError(f"{name}={mode!r} must be one of {tuple(allowed)}")
    return mode


def spec_or_none(S: int, N: int) -> Optional[WindowSpec]:
    """The window spec of an (S, N) coarse/fine scale pair, or None when the
    pair admits none. A function of the shapes alone, so it also tells
    whether a stored encoder kNN index was window-constrained (LocalMerge
    applies the same admission when it searched)."""
    try:
        return make_window_spec(S, N)
    except ValueError:
        return None


def scatter_mean_op(knn_idx: torch.Tensor, num_fine: int,
                    wspec: Optional[WindowSpec]) -> Callable[[torch.Tensor], torch.Tensor]:
    """The decoder's upsample as a ``LinearUnit`` ``mid_op``: the windowed
    scatter-mean where ``wspec`` is given, the exact one otherwise."""
    if wspec is not None:
        return lambda y: windowed_scatter_mean(y, knn_idx, num_fine, wspec)
    return lambda y: scatter_mean_upsample(y, knn_idx, num_fine)


def morton_sort(points: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort ``[B, N, 3+F]`` points along the Morton curve of their xyz;
    returns ``(sorted points, inverse permutation)``."""
    with span("window.morton_sort"):
        perm = morton_order(points[..., :3]).long()
        inv_perm = torch.argsort(perm, dim=-1)
        return torch.gather(points, 1, perm[..., None].expand(-1, -1, points.shape[-1])), inv_perm


def morton_unsort(out: torch.Tensor, inv_perm: Optional[torch.Tensor]) -> torch.Tensor:
    """Per-point outputs ``[B, N, C]`` back in the order before
    :func:`morton_sort`; the identity when ``inv_perm`` is None."""
    if inv_perm is None:
        return out
    with span("window.morton_unsort"):
        return torch.gather(out, 1, inv_perm[..., None].expand(-1, -1, out.shape[-1]))


class WindowModes:
    """Mode predicates and the encoder's FPS step for a model that holds
    ``neighbor_mode``, ``fps_min_band`` and ``fps_min_samples``."""

    neighbor_mode: str
    fps_min_band: int
    fps_min_samples: int

    @property
    def windowed(self) -> bool:
        return self.neighbor_mode in ("window", "window_all")

    @property
    def spatial_mode(self) -> str:
        return "window" if self.windowed else "exact"

    @property
    def feature_mode(self) -> str:
        return "window" if self.neighbor_mode == "window_all" else "exact"

    def fps_scale(self, cur_xyz: torch.Tensor, npoint: int, i: int,
                  generator: Optional[torch.Generator] = None, starts=None) -> torch.Tensor:
        """Encoder FPS step ``i``. In ``'window_all'`` the Morton-sorted cloud
        is cut into contiguous bands (``pick_fps_bands`` with the model's
        floors); when windowed the indices are sorted, so every scale stays
        Morton-ordered (an FPS set does not depend on its order). In train
        mode the step takes keyed starts (``ops/fps.py::keyed_start``):
        ``starts[i]`` (``[B]``, or ``[B, n_bands]`` band-local ones when
        banded) or a draw from ``generator``; index 0 otherwise."""
        bands = 1
        if self.neighbor_mode == "window_all":
            bands = pick_fps_bands(cur_xyz.shape[1], npoint, min_band=self.fps_min_band,
                                   min_samples=self.fps_min_samples)
        start = keyed_start(self.training, i, generator, starts, cur_xyz.shape[0],
                            cur_xyz.shape[1], bands)
        fps_idx = banded_farthest_point_sample(cur_xyz, npoint, bands, start_idx=start)
        if self.windowed:
            fps_idx = torch.sort(fps_idx, dim=-1)[0]
        return fps_idx
