"""The ``fused`` op table — counterpart of ``vit_tpu.ops.pallas.FUSED_OPS``.

  - ``encoder_block``: K1 + K2 (``ops/fused_block.py``);
  - ``layer_norm``: K3, the final LayerNorm over all (B, T, D) rows;
  - ``patch_embed``: the plain reference (one large GEMM, which the JAX
    package also leaves to XLA).
"""

from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import OpsImpl
from vit_tpu_torch.ops.fused_block import fused_encoder_block
from vit_tpu_torch.ops.kernels.layer_norm import layer_norm

FUSED_OPS = OpsImpl(
    name="fused",
    layer_norm=layer_norm,
    patch_embed=reference.patch_embed,
    encoder_block=fused_encoder_block,
)

__all__ = ["FUSED_OPS"]
