"""The reference's orphaned experiments that ``mpa_tpu`` rebuilt
(counterpart of ``mpa_tpu/extras``): ``DGCNN``, registered as model
``dgcnn``, the NetVLAD poolings and the displacement-kernel encoder. Only
``dgcnn`` is reachable from a preset (``--model dgcnn``); the others are
blocks for ablations."""

from mpa_tpu_torch.extras.dgcnn import DGCNN, get_graph_feature
from mpa_tpu_torch.extras.disp3d import Disp3DEncoder, NeighborPooling, Operator3D, OperatorND
from mpa_tpu_torch.extras.netvlad import GatingContext, NetVLAD, SpatialPyramidNetVLAD

__all__ = [
    "DGCNN",
    "get_graph_feature",
    "NetVLAD",
    "SpatialPyramidNetVLAD",
    "GatingContext",
    "Operator3D",
    "OperatorND",
    "NeighborPooling",
    "Disp3DEncoder",
]
