"""Markov transition blocks, channel-last; train mode follows the module's
``training`` flag (``BatchNorm`` is the only part that reads it)."""

from mpa_tpu_torch.nn.linear import BatchNorm, LinearUnit
from mpa_tpu_torch.nn.local_trans import LocalTrans
from mpa_tpu_torch.nn.local_merge import LocalMerge
from mpa_tpu_torch.nn.keephigh import KeepHighResolutionEncoder
from mpa_tpu_torch.nn.fuse import Fuse, compose_fps_chain
from mpa_tpu_torch.nn.keephigh_partseg import KeepHighResolutionPartSeg

__all__ = [
    "BatchNorm",
    "LinearUnit",
    "LocalTrans",
    "LocalMerge",
    "KeepHighResolutionEncoder",
    "Fuse",
    "compose_fps_chain",
    "KeepHighResolutionPartSeg",
]
