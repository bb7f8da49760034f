"""Datasets of the port (numpy, no JAX)."""

from mpa_tpu_torch.data.synthetic import synthetic_clouds

__all__ = ["synthetic_clouds"]
