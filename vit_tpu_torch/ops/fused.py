"""The kernel op tables — counterparts of ``vit_tpu.ops.pallas.FUSED_OPS``
and ``TRAINABLE_FUSED_OPS``.

``fused`` (inference):
  - ``encoder_block``: K1 + K2 (``ops/fused_block.py``);
  - ``layer_norm``: K3, the final LayerNorm over all (B, T, D) rows;
  - ``patch_embed``: the plain reference (one large GEMM, which the JAX
    package also leaves to XLA).

``fused_train`` (training):
  - ``encoder_block``: K1 -> K4 -> K5 forward, K7 -> K6 backward
    (``ops/trainable.py``);
  - ``encoder_block_train``: the regularized block, K1 -> K10 -> K11
    forward, K12a -> K6 backward;
  - ``layer_norm``, ``attention``, ``mlp``, ``patch_embed``: the eager
    reference ops, so the final LayerNorm stays differentiable (K3 has no
    backward).
"""

from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import OpsImpl
from vit_tpu_torch.ops.fused_block import fused_encoder_block
from vit_tpu_torch.ops.kernels.layer_norm import layer_norm
from vit_tpu_torch.ops.trainable import encoder_block_train, encoder_block_trainable

FUSED_OPS = OpsImpl(
    name="fused",
    layer_norm=layer_norm,
    patch_embed=reference.patch_embed,
    encoder_block=fused_encoder_block,
)

TRAINABLE_FUSED_OPS = OpsImpl(
    name="fused_train",
    layer_norm=reference.layer_norm,
    patch_embed=reference.patch_embed,
    attention=reference.attention,
    mlp=reference.mlp,
    encoder_block=encoder_block_trainable,
    encoder_block_train=encoder_block_train,
)

__all__ = ["FUSED_OPS", "TRAINABLE_FUSED_OPS"]
