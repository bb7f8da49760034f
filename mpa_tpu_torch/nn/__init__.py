"""Markov transition blocks and the RepSurf blocks (umbrella surface
constructor, the set abstractions), channel-last; train mode follows the module's
``training`` flag (``BatchNorm`` reads it, and the umbrella constructor's
random normal inversion)."""

from mpa_tpu_torch.nn.linear import BatchNorm, LinearUnit
from mpa_tpu_torch.nn.local_trans import LocalTrans
from mpa_tpu_torch.nn.local_merge import LocalMerge
from mpa_tpu_torch.nn.keephigh import KeepHighResolutionEncoder
from mpa_tpu_torch.nn.fuse import Fuse, compose_fps_chain
from mpa_tpu_torch.nn.feature_propagation import PointNetFeaturePropagation
from mpa_tpu_torch.nn.keephigh_partseg import KeepHighResolutionPartSeg
from mpa_tpu_torch.nn.umbrella_constructor import UmbrellaSurfaceConstructor
from mpa_tpu_torch.nn.surface_abstraction import SurfaceAbstraction, SurfaceAbstractionCD

__all__ = [
    "BatchNorm",
    "LinearUnit",
    "LocalTrans",
    "LocalMerge",
    "KeepHighResolutionEncoder",
    "Fuse",
    "compose_fps_chain",
    "PointNetFeaturePropagation",
    "KeepHighResolutionPartSeg",
    "UmbrellaSurfaceConstructor",
    "SurfaceAbstraction",
    "SurfaceAbstractionCD",
]
