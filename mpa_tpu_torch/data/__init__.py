"""Datasets of the port (numpy, no JAX)."""

from mpa_tpu_torch.data.shapenetpart import SEG_PARTS, to_categorical
from mpa_tpu_torch.data.synthetic import realistic_partseg, synthetic_clouds, synthetic_partseg

__all__ = ["SEG_PARTS", "realistic_partseg", "synthetic_clouds", "synthetic_partseg",
           "to_categorical"]
