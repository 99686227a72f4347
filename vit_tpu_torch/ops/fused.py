"""The kernel op tables — counterparts of ``vit_tpu.ops.pallas.PALLAS_OPS``,
``FUSED_OPS``, ``TRAINABLE_FUSED_OPS`` and ``QUANT_OPS``.

``per_op`` (the JAX package's ``pallas`` table: one kernel per layer op, a
debugging surface with no regularizer hooks):
  - ``layer_norm``: K3 (LN1, LN2 and the final LayerNorm);
  - ``attention``: the QKV linear, K21 ``scaled_dot_product_attention`` on
    strided views of the packed QKV, the out linear
    (``ops/kernels/attention.py``); past 1,024 tokens K13;
  - ``mlp``: K22 (``ops/kernels/mlp.py``);
  - ``patch_embed``: the plain reference (one large GEMM, which the JAX
    package also leaves to XLA).

``fused`` (inference):
  - ``encoder_block``: K1 + K2 (``ops/fused_block.py``); past 1,024 tokens
    K3 + the QKV GEMM + K13 flash attention + K2;
  - ``layer_norm``: K3, the final LayerNorm over all (B, T, D) rows;
  - ``attention``, ``mlp``: K21 and K22, as on ``per_op``; only
    ``InferenceEngine.phase_report`` reads them;
  - ``patch_embed``: the plain reference.

``quant`` (W8A8 inference, on params from ``ops/quant.quantize_params``):
  - ``encoder_block``: K15 + K16 (``ops/quant_block.py``); past 1,024
    tokens the int8 QKV stage + K13 + K16;
  - ``layer_norm``, ``attention``, ``mlp`` and ``patch_embed``: as on
    ``fused``.

``fused_train`` (training):
  - ``encoder_block``: K1 -> K4 -> K5 forward, K7 -> K6 backward
    (``ops/trainable.py``); past 1,024 tokens K13 -> K4 -> K5 forward,
    K8 -> K9 -> K14 backward, LN1 and the QKV GEMM in plain torch;
  - ``encoder_block_train``: the regularized block, K1 -> K10 -> K11
    forward, K12a -> K6 backward;
  - ``layer_norm``, ``attention``, ``mlp``, ``patch_embed``: the eager
    reference ops, so the final LayerNorm stays differentiable (K3 has no
    backward).
"""

from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import OpsImpl
from vit_tpu_torch.ops.fused_block import fused_encoder_block
from vit_tpu_torch.ops.kernels.attention import attention
from vit_tpu_torch.ops.kernels.layer_norm import layer_norm
from vit_tpu_torch.ops.kernels.mlp import mlp
from vit_tpu_torch.ops.quant_block import fused_encoder_block_q8
from vit_tpu_torch.ops.trainable import encoder_block_train, encoder_block_trainable

PER_OP_OPS = OpsImpl(
    name="per_op",
    layer_norm=layer_norm,
    patch_embed=reference.patch_embed,
    attention=attention,
    mlp=mlp,
)

FUSED_OPS = OpsImpl(
    name="fused",
    layer_norm=layer_norm,
    patch_embed=reference.patch_embed,
    attention=attention,
    mlp=mlp,
    encoder_block=fused_encoder_block,
)

QUANT_OPS = OpsImpl(
    name="quant",
    layer_norm=layer_norm,
    patch_embed=reference.patch_embed,
    attention=attention,
    mlp=mlp,
    encoder_block=fused_encoder_block_q8,
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

__all__ = ["PER_OP_OPS", "FUSED_OPS", "QUANT_OPS", "TRAINABLE_FUSED_OPS"]
