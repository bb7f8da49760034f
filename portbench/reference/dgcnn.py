"""The plain reference of DGCNN (Wang et al., "Dynamic Graph CNN for Learning
on Point Clouds", ACM TOG 2019, arXiv:1801.07829, section 4.1's
classification network), in plain float32 PyTorch.

Four EdgeConv blocks, each on the kNN graph of its input's feature space
(the point itself among its k neighbours), edge features ``concat(x_j -
x_i, x_i)``, a shared bias-free dense layer, BatchNorm, LeakyReLU(0.2) and
the max over the neighbours; a bias-free 1024-wide dense layer over the
four blocks' outputs with BatchNorm and LeakyReLU; the global max and mean
pools; the head 512 (bias-free, BatchNorm, LeakyReLU, dropout), 256 (with a
bias, BatchNorm, LeakyReLU, dropout) and the classes. The graph is searched
on detached features: no gradient flows through the search.

As in ``mpa_tpu``, whose form the port keeps, the model answers logits and
the training loss reads them as log-probabilities.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from portbench.reference import ops
from portbench.reference.layers import BatchNorm, Linear


class EdgeConv(nn.Module):
    def __init__(self, in_features: int, features: int, k: int):
        super().__init__()
        self.k = k
        self.conv = Linear(2 * in_features, features, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idx = ops.knn(self.k, x.detach(), x.detach())
        neigh = ops.gather(x, idx)
        centre = x[:, :, None, :].expand_as(neigh)
        edges = torch.cat([neigh - centre, centre], dim=-1)
        return torch.amax(ops.leaky_relu(self.bn(self.conv(edges))), dim=2)


class DGCNN(nn.Module):
    def __init__(self, num_classes: int, k: int, block_widths, embedding: int, head,
                 dropout: float):
        super().__init__()
        self.dropout = dropout
        self.depth = len(block_widths)
        c = 3
        for i, w in enumerate(block_widths):
            setattr(self, f"edge{i + 1}", EdgeConv(c, w, k))
            c = w
        self.conv5 = Linear(sum(block_widths), embedding, bias=False)
        self.bn5 = BatchNorm(embedding)
        self.linear1 = Linear(2 * embedding, head[0], bias=False)
        self.bn6 = BatchNorm(head[0])
        self.linear2 = Linear(head[0], head[1])
        self.bn7 = BatchNorm(head[1])
        self.linear3 = Linear(head[1], num_classes)

    def forward(self, points: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = points[..., :3]
        blocks = []
        for i in range(self.depth):
            x = getattr(self, f"edge{i + 1}")(x)
            blocks.append(x)
        x = ops.leaky_relu(self.bn5(self.conv5(torch.cat(blocks, dim=-1))))
        g = torch.cat([torch.amax(x, dim=1), torch.mean(x, dim=1)], dim=-1)
        g = ops.leaky_relu(self.bn6(self.linear1(g)))
        if self.training:
            g = ops.dropout(g, self.dropout, generator)
        g = ops.leaky_relu(self.bn7(self.linear2(g)))
        if self.training:
            g = ops.dropout(g, self.dropout, generator)
        return self.linear3(g)


def build(sizes: dict) -> DGCNN:
    return DGCNN(sizes["num_classes"], sizes["k"], sizes["block_widths"], sizes["embedding"],
                 sizes["head"], sizes["dropout"])
