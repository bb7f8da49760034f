"""Datasets of the port (numpy, no JAX) and the device augmentations."""

from mpa_tpu_torch.data import augment
from mpa_tpu_torch.data.modelnet import load_modelnet
from mpa_tpu_torch.data.native_io import native_available
from mpa_tpu_torch.data.scanobjectnn import load_scanobjectnn
from mpa_tpu_torch.data.shapenetpart import (
    SEG_PARTS,
    ShapeNetPartDataset,
    load_split,
    pc_normalize,
    to_categorical,
)
from mpa_tpu_torch.data.s3dis import block_features, sample_blocks, semseg_iou
from mpa_tpu_torch.data.synthetic import (
    realistic_partseg,
    surface_clouds,
    synthetic_clouds,
    synthetic_partseg,
    synthetic_semseg,
)

__all__ = ["SEG_PARTS", "ShapeNetPartDataset", "augment", "block_features", "load_modelnet",
           "load_scanobjectnn", "load_split", "native_available", "pc_normalize",
           "realistic_partseg", "sample_blocks", "semseg_iou", "surface_clouds",
           "synthetic_clouds", "synthetic_partseg", "synthetic_semseg", "to_categorical"]
