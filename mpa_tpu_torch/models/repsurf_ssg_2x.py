"""RepSurf-SSG-2x classifier: the RepSurf umbrella-surface baseline at
doubled widths.

Counterpart of ``mpa_tpu/models/repsurf_ssg_2x.py::RepSurfSSG2x``: the
umbrella surface constructor (10 channels per point), three ball-query set
abstractions (512/128/32 centres, radii 0.1/0.2/0.4, 24 neighbours) and a
group-all one, widths 128-128-256 / 256-256-512 / 512-512-1024 /
1024-1024-2048, then the head ``fc1 -> bn1 -> ReLU -> dropout -> fc2 -> bn2
-> ReLU -> dropout -> fc3`` and ``log_softmax``. ``sa_npoints`` shrinks the
ladder and ``width_div`` divides every width (at least 8), for small runs;
both at their defaults give the published configuration. ``umbrella_k``,
``umbrella_aggr`` and ``return_dist`` are the umbrella's ``k``,
``aggr_type`` and ``return_dist`` (9, a sum over the fan, the plane offset
kept), ``return_polar`` the set abstractions' polar position channels
(kept), as in ``mpa_tpu``.

In train mode the caller's ``generator`` draws the umbrella's normal flips
first and then the dropout masks; ``flips`` gives the flips instead (a test
hands it the ones ``mpa_tpu`` drew).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mpa_tpu_torch.models.registry import register_model
from mpa_tpu_torch.nn.linear import BatchNorm, seeded_dropout
from mpa_tpu_torch.nn.surface_abstraction import SurfaceAbstractionCD
from mpa_tpu_torch.nn.umbrella_constructor import UmbrellaSurfaceConstructor

UMBRELLA_CHANNELS = 10  # the umbrella's width, the normals the set abstractions group


class RepSurfSSG2x(nn.Module):
    def __init__(
        self,
        num_classes: int = 15,
        dropout: float = 0.4,
        sa_npoints: Optional[Tuple[int, int, int]] = None,
        width_div: int = 1,
        umbrella_k: int = 9,
        umbrella_aggr: str = "sum",
        return_dist: bool = True,
        return_polar: bool = True,
    ):
        super().__init__()
        if not 0.0 <= dropout < 1.0:
            raise ValueError(f"dropout={dropout} must be in [0, 1)")
        self.dropout = dropout
        self.surface_constructor = UmbrellaSurfaceConstructor(
            k=umbrella_k, channels=UMBRELLA_CHANNELS, aggr_type=umbrella_aggr,
            return_dist=return_dist)
        npts = tuple(sa_npoints or (512, 128, 32))

        def w(*chs):
            return tuple(max(8, c // width_div) for c in chs)

        stages = [(npts[0], 0.1, w(128, 128, 256)), (npts[1], 0.2, w(256, 256, 512)),
                  (npts[2], 0.4, w(512, 512, 1024))]
        feat_ch = 0
        for i, (npoint, radius, mlp) in enumerate(stages):
            setattr(self, f"sa{i + 1}", SurfaceAbstractionCD(
                npoint, radius, 24, UMBRELLA_CHANNELS + feat_ch, mlp,
                return_polar=return_polar))
            feat_ch = mlp[-1]
        mlp4 = w(1024, 1024, 2048)
        self.sa4 = SurfaceAbstractionCD(0, 0.0, 0, UMBRELLA_CHANNELS + feat_ch, mlp4,
                                        group_all=True, return_polar=return_polar)
        h1, h2 = w(512, 256)
        self.fc1 = nn.Linear(mlp4[-1], h1)
        self.bn1 = BatchNorm(h1)
        self.fc2 = nn.Linear(h1, h2)
        self.bn2 = BatchNorm(h2)
        self.fc3 = nn.Linear(h2, num_classes)

    def forward(self, points: torch.Tensor, *, generator: Optional[torch.Generator] = None,
                flips: Optional[torch.Tensor] = None) -> torch.Tensor:
        """points: ``[B, N, 3]`` xyz -> ``[B, num_classes]`` log-probs.

        ``generator`` (on the points' device) draws the normal flips (unless
        ``flips``, ``[B]`` signs, gives them) and the dropout masks; train
        mode requires one of them.
        """
        center = points[..., :3]
        normal = self.surface_constructor(center, generator=generator, flips=flips)
        feature = None
        for sa in (self.sa1, self.sa2, self.sa3, self.sa4):
            center, normal, feature = sa(center, normal, feature)
        x = feature[:, 0]
        for fc, bn in ((self.fc1, self.bn1), (self.fc2, self.bn2)):
            x = seeded_dropout(F.relu(bn(fc(x))), self.dropout, self.training, generator)
        return F.log_softmax(self.fc3(x), dim=-1)


@register_model("repsurf_ssg_2x")
def _repsurf_ssg_2x(**kw) -> RepSurfSSG2x:
    return RepSurfSSG2x(**kw)
