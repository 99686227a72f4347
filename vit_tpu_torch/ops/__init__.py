"""Op tables: the eager reference ops and the CUDA-kernel ``fused`` path."""

from vit_tpu_torch.ops.dispatch import EAGER_OPS, OpsImpl, get_ops

__all__ = ["EAGER_OPS", "OpsImpl", "get_ops"]
