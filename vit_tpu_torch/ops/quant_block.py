"""The W8A8 encoder block: two CUDA kernels over a flat (B*T, D) activation
— counterpart of ``vit_tpu.ops.pallas.quant_kernels.fused_encoder_block_q8``.

  K15 ``ln_qkv_attn_q8``          LN1 -> per-row int8 -> int8 QKV GEMM ->
                                  dequant -> attention in the working dtype
  K16 ``out_ln_mlp_residual_q8``  out_proj + residual -> LN2 -> int8 FC1 ->
                                  GELU -> per-row int8 -> int8 FC2 -> residual

``blk`` carries int8 ``wqkv``/``w1``/``w2`` with fp32 ``*_scale`` companions
(``ops/quant.quantize_params``); ``wo`` stays in the working dtype and
rides K16's first stage.

Past ``fused_block.VMEM_ATTENTION_MAX_T`` tokens the block is
``_long_seq_block_q8``: K15's stages 1-2 alone (``ln_qkv_q8``: the same LN +
row quantizer + int8 GEMM + dequant, so both blocks share one definition of
the QKV grouping), K13 blockwise flash attention on the packed QKV, then
K16.  Attention stays in the working dtype on the quant path.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops import fused_block
from vit_tpu_torch.ops.kernels.ln_qkv_attn_q8 import ln_qkv_attn_q8, ln_qkv_q8
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual_q8 import out_ln_mlp_residual_q8


def _mlp_q8(ctx, x2d, blk, eps: float, gelu_variant: str):
    return out_ln_mlp_residual_q8(
        ctx, x2d, blk["wo"], blk["bo"], blk["ln2_scale"], blk["ln2_bias"],
        blk["w1"], blk["w1_scale"], blk["b1"], blk["w2"], blk["w2_scale"],
        blk["b2"], eps, gelu_variant,
    )


def _long_seq_block_q8(x2d, blk, num_heads: int, seq_len: int, eps: float, gelu_variant: str):
    """The W8A8 block past ``VMEM_ATTENTION_MAX_T``
    (``quant_kernels.py:_long_seq_block_q8``): the int8 QKV stage, K13, K16."""
    from vit_tpu_torch.ops.flash_attention import flash_context_from_packed_qkv

    qkv = ln_qkv_q8(
        x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["wqkv_scale"],
        blk["bqkv"], eps,
    )
    ctx = flash_context_from_packed_qkv(qkv, x2d.shape[0] // seq_len, seq_len, num_heads)
    return _mlp_q8(ctx, x2d, blk, eps, gelu_variant)


def fused_encoder_block_q8(
    x2d: torch.Tensor,
    blk,
    num_heads: int,
    seq_len: int,
    eps: float,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """One pre-LN encoder block with int8 QKV and MLP GEMMs on a flat
    (B*T, D) activation: K15 then K16, or the long-sequence block past
    ``VMEM_ATTENTION_MAX_T`` (read at call time, as ``fused_encoder_block``
    does)."""
    if seq_len > fused_block.VMEM_ATTENTION_MAX_T:
        return _long_seq_block_q8(x2d, blk, num_heads, seq_len, eps, gelu_variant)
    ctx = ln_qkv_attn_q8(
        x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["wqkv_scale"],
        blk["bqkv"], num_heads, seq_len, eps,
    )
    return _mlp_q8(ctx, x2d, blk, eps, gelu_variant)
