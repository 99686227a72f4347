"""Parameter conversion between the JAX package's numpy pytree and torch."""

from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy

__all__ = ["params_from_numpy", "params_to_numpy"]
