"""Markov transition blocks and the RepSurf blocks (umbrella surface
constructor, set abstraction), channel-last; train mode follows the module's
``training`` flag (``BatchNorm`` reads it, and the umbrella constructor's
random normal inversion)."""

from mpa_tpu_torch.nn.linear import BatchNorm, LinearUnit
from mpa_tpu_torch.nn.local_trans import LocalTrans
from mpa_tpu_torch.nn.local_merge import LocalMerge
from mpa_tpu_torch.nn.keephigh import KeepHighResolutionEncoder
from mpa_tpu_torch.nn.fuse import Fuse, compose_fps_chain
from mpa_tpu_torch.nn.keephigh_partseg import KeepHighResolutionPartSeg
from mpa_tpu_torch.nn.umbrella_constructor import UmbrellaSurfaceConstructor
from mpa_tpu_torch.nn.surface_abstraction import SurfaceAbstractionCD

__all__ = [
    "BatchNorm",
    "LinearUnit",
    "LocalTrans",
    "LocalMerge",
    "KeepHighResolutionEncoder",
    "Fuse",
    "compose_fps_chain",
    "KeepHighResolutionPartSeg",
    "UmbrellaSurfaceConstructor",
    "SurfaceAbstractionCD",
]
