"""Task models, addressed by a string registry."""

from mpa_tpu_torch.models.registry import get_model, list_models, register_model
from mpa_tpu_torch.models.markov_cls import MarkovClassifier
from mpa_tpu_torch.models.markov_completion import MarkovCompletion
from mpa_tpu_torch.models.markov_partseg import MarkovPartSeg
from mpa_tpu_torch.models.markov_partseg_fp import MarkovPartSegFP
from mpa_tpu_torch.models.markov_pose import (
    MarkovPose,
    rotation_6d_to_matrix,
    rotation_geodesic_loss,
)
from mpa_tpu_torch.models.markov_semseg import MarkovSemSeg
from mpa_tpu_torch.models.repsurf_ssg_2x import RepSurfSSG2x

__all__ = ["register_model", "get_model", "list_models", "MarkovClassifier", "MarkovCompletion",
           "MarkovPartSeg", "MarkovPartSegFP", "MarkovPose", "MarkovSemSeg", "RepSurfSSG2x",
           "rotation_6d_to_matrix", "rotation_geodesic_loss"]
