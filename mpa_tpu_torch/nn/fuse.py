"""Fuse, the cross-state (all-pairs) feature exchange between Markov scales.

Counterpart of ``mpa_tpu/nn/fuse.py``. For a target scale t among the
states (N = 2048/1024/512/256/128, channels c0..c4), every other scale's
features are brought to it:

- finer s < t: gathered by the composed FPS index chain
  ``idx = FPS_t; for j in t-1..s+1: idx = FPS_j[idx]``;
- coarser s > t: scatter-mean upsample, hoisted behind the pair's Dense
  (``LinearUnit`` ``mid_op``); adjacent scales reuse the encoder's stored kNN
  index, the others search ``knn(K, xyz[t], xyz[s])`` afresh;
- each pair goes through its own LinearUnit ``conv{s}{t}``, the sum (plus
  the target itself) through ``conv{t}``, with a residual add of the target.

With ``knn_mode='window'`` (every scale Morton-ordered, the window-mode
models' invariant) a coarser source whose (S, N) pair admits a window takes
the windowed scatter-mean: the adjacent pair over the stored encoder index
(windowed iff the pair admits a spec, LocalMerge's admission), the others
over a fresh windowed kNN of ``xyz[s]`` in ``xyz[t]``. A pair without a
window takes the exact ops, as in ``mpa_tpu``.

A flax ``Fuse`` creates parameters only for the target it is called with; here
the target is fixed when the module is built.

``dtype`` (``torch.bfloat16``, ``mpa_tpu/nn/fuse.py:86-118``): every unit
computes in bf16, the finer sources' gathers and the coarser sources'
scatter-means move bf16 rows, and the sums are bf16.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
from torch import nn

from mpa_tpu_torch.nn.linear import LinearUnit
from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.ops.knn import knn
from mpa_tpu_torch.ops.window import windowed_knn_with_spec
from mpa_tpu_torch.nn.window_mode import check_mode, scatter_mean_op, spec_or_none


def compose_fps_chain(fps: Sequence[torch.Tensor], src: int, dst: int) -> torch.Tensor:
    """Indices of scale-``dst`` points inside scale ``src`` (``src < dst``).

    ``fps[j]`` maps scale-(j+1) indices into scale j (``fps[0]`` is the FPS
    from scale 0 to scale 1, ``[B, N1]``). Integer index arithmetic, plain in
    ``mpa_tpu`` too."""
    if not src < dst:
        raise ValueError(f"compose_fps_chain: src={src} must be finer than dst={dst}")
    idx = fps[dst - 1]  # [B, N_dst] into scale dst-1
    for j in range(dst - 2, src - 1, -1):
        idx = torch.gather(fps[j], 1, idx.long())
    return idx


class Fuse(nn.Module):
    """One fuse step toward ``target``: returns the refreshed
    ``features[target]`` (``mpa_tpu`` returns the whole list with that one
    slot replaced)."""

    def __init__(self, channels: Sequence[int], target: int, num_neighbors: int = 8,
                 knn_mode: str = "exact", dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.knn_mode = check_mode("knn_mode", knn_mode, ("exact", "window"))
        self.channels = tuple(channels)
        self.target = target
        self.num_neighbors = num_neighbors
        ct = self.channels[target]
        for s, cs in enumerate(self.channels):
            if s != target:
                setattr(self, f"conv{s}{target}", LinearUnit(cs, ct, dtype=dtype))
        setattr(self, f"conv{target}", LinearUnit(ct, ct, dtype=dtype))

    def forward(
        self,
        features: List[torch.Tensor],  # f0..f4, channel c_s at scale s
        fps: Sequence[torch.Tensor],  # fps[j]: [B, N_{j+1}] into scale j
        knn_idx: Sequence[Optional[torch.Tensor]],  # the encoder's stored kNN per scale
        xyz: Sequence[torch.Tensor],  # positions per scale
    ) -> torch.Tensor:
        t = self.target
        ft = features[t]
        num_fine = ft.shape[1]
        total = ft
        for s in range(len(features)):
            if s == t:
                continue
            unit = getattr(self, f"conv{s}{t}")
            if s < t:  # finer: gather down the FPS chain
                moved = unit(index_points(features[s], compose_fps_chain(fps, s, t)))
            else:  # coarser: scatter-mean up, at the target's width
                wspec = None
                if self.knn_mode == "window":
                    wspec = spec_or_none(features[s].shape[1], num_fine)
                if s == t + 1 and knn_idx[s] is not None:
                    up_idx = knn_idx[s]  # windowed exactly when wspec is not None
                elif wspec is not None:
                    _, up_idx, wspec = windowed_knn_with_spec(self.num_neighbors, xyz[t], xyz[s])
                else:
                    _, up_idx = knn(self.num_neighbors, xyz[t], xyz[s])
                moved = unit(features[s], mid_op=scatter_mean_op(up_idx, num_fine, wspec))
            total = total + moved
        return getattr(self, f"conv{t}")(total) + ft
