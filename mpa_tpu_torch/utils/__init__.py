"""Device resolution and the JAX-variables converter."""

from mpa_tpu_torch.utils.device import resolve_device
from mpa_tpu_torch.utils.convert import from_jax_variables

__all__ = ["resolve_device", "from_jax_variables"]
