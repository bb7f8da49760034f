"""Datasets of the port (numpy, no JAX)."""

from mpa_tpu_torch.data.shapenetpart import SEG_PARTS, to_categorical
from mpa_tpu_torch.data.s3dis import block_features, sample_blocks, semseg_iou
from mpa_tpu_torch.data.synthetic import (
    realistic_partseg,
    surface_clouds,
    synthetic_clouds,
    synthetic_partseg,
    synthetic_semseg,
)

__all__ = ["SEG_PARTS", "block_features", "realistic_partseg", "sample_blocks", "semseg_iou",
           "surface_clouds", "synthetic_clouds", "synthetic_partseg", "synthetic_semseg", "to_categorical"]
