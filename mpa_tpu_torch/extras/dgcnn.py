"""DGCNN, the EdgeConv classifier (counterpart of ``mpa_tpu/extras/dgcnn.py``).

Four EdgeConv blocks, each on a kNN graph rebuilt in the feature space of
its input (``knn``: ``knn_kernel`` on the card, at k = 20 over C = 3, 64,
64 and 128 channels at the published widths), with edge features
``concat(x_j - x_i, x_i)`` (``index_points``: ``gather_rows_kernel``
forward, ``scatter_add_rows_kernel`` backward), a shared bias-free Linear,
BatchNorm and LeakyReLU(0.2), and a max over the k neighbours; then the
bias-free 1024-wide ``conv5`` over the four blocks' outputs, a global max
and mean pool, and the head ``linear1`` (no bias) -> ``bn6`` -> LeakyReLU ->
dropout -> ``linear2`` (with a bias, as flax's Dense ahead of ``bn7``) ->
``bn7`` -> LeakyReLU -> dropout -> ``linear3``. Submodule names follow the
flax module.

As in ``mpa_tpu``, the model returns logits, not log-probabilities
(``mpa_tpu/extras/dgcnn.py:80``), and the cls loss reads them as
log-probabilities: ``--model dgcnn`` trains on that objective on both
sides.

Every max over neighbours or points is ``torch.amax``, whose gradient, like
``jnp.max``'s, is split evenly among tied maxima. The kNN's distances are
dropped, so it searches detached features: no gradient flows through the
search, as none does in ``mpa_tpu``. Dropout acts in train mode only and
draws its masks from the ``torch.Generator`` the caller passes. The four
blocks and the head are the spans ``block.edge1`` .. ``block.edge4`` and
``block.head`` (``utils/profiling.py``).

Each BatchNorm and the LeakyReLU after it (``bn`` of every EdgeConv block,
``bn5``, ``bn6``, ``bn7``) are one call, ``BatchNorm(x, act=True)``: in
train mode on the card the fused kernels of ``ops/batch_norm.py`` over the
``[B, N, k, C]`` edge rows (or the pooled rows), keeping the edge tensor
and not its normalised copy for the backward; in eval mode ``F.batch_norm``
and then the LeakyReLU.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from mpa_tpu_torch.models.registry import register_model
from mpa_tpu_torch.nn.linear import BatchNorm, seeded_dropout
from mpa_tpu_torch.ops.gather import index_points
from mpa_tpu_torch.ops.knn import knn
from mpa_tpu_torch.utils.profiling import span


def get_graph_feature(x: torch.Tensor, k: int = 20) -> torch.Tensor:
    """``[B, N, C]`` -> edge features ``[B, N, k, 2C]``: (neighbour - centre,
    centre), the neighbours by feature-space kNN (the point itself first)."""
    xd = x.detach()
    _, idx = knn(k, xd, xd)
    neigh = index_points(x, idx)  # [B, N, k, C]
    centre = x[:, :, None, :].expand_as(neigh)
    return torch.cat([neigh - centre, centre], dim=-1)


class _EdgeConv(nn.Module):
    """One EdgeConv block: ``conv`` (bias-free) -> ``bn`` with its LeakyReLU
    over the edge features, then the max over the k neighbours."""

    def __init__(self, in_features: int, features: int, k: int):
        super().__init__()
        self.k = k
        self.conv = nn.Linear(2 * in_features, features, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        e = self.bn(self.conv(get_graph_feature(x, self.k)), act=True)
        return torch.amax(e, dim=2)


class DGCNN(nn.Module):
    """Args (``mpa_tpu``'s fields and defaults):
      num_classes: the logits' width.
      k: the neighbours of each EdgeConv graph.
      block_widths: the four EdgeConv blocks' widths.
      dropout: the head's dropout rate.
    """

    def __init__(self, num_classes: int = 13, k: int = 20,
                 block_widths: Sequence[int] = (64, 64, 128, 256), dropout: float = 0.5):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout={dropout} must be in [0, 1)")
        self.dropout = dropout
        self.depth = len(block_widths)
        c = 3
        for i, w in enumerate(block_widths):
            setattr(self, f"edge{i + 1}", _EdgeConv(c, w, k))
            c = w
        self.conv5 = nn.Linear(sum(block_widths), 1024, bias=False)
        self.bn5 = BatchNorm(1024)
        self.linear1 = nn.Linear(2 * 1024, 512, bias=False)
        self.bn6 = BatchNorm(512)
        self.linear2 = nn.Linear(512, 256)
        self.bn7 = BatchNorm(256)
        self.linear3 = nn.Linear(256, num_classes)

    def forward(self, points: torch.Tensor, *,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """points: ``[B, N, 3+]`` (xyz first) -> ``[B, num_classes]`` logits.
        ``generator`` (on the points' device) draws the dropout masks; train
        mode with ``dropout > 0`` requires it."""
        x = points[..., :3]
        blocks = []
        for i in range(self.depth):
            with span(f"block.edge{i + 1}"):
                x = getattr(self, f"edge{i + 1}")(x)
            blocks.append(x)
        with span("block.head"):
            x = self.bn5(self.conv5(torch.cat(blocks, dim=-1)), act=True)
            g = torch.cat([torch.amax(x, dim=1), torch.mean(x, dim=1)], dim=-1)
            g = self.bn6(self.linear1(g), act=True)
            g = seeded_dropout(g, self.dropout, self.training, generator)
            g = self.bn7(self.linear2(g), act=True)
            g = seeded_dropout(g, self.dropout, self.training, generator)
            return self.linear3(g)


@register_model("dgcnn")
def _dgcnn(**kw) -> DGCNN:
    return DGCNN(**kw)
