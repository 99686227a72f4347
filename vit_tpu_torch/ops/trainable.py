"""Differentiable fused encoder block — the ``fused_train`` table's block.

Counterpart of ``vit_tpu.ops.pallas.trainable``: the forward runs K1
``ln_qkv_attn`` -> K4 ``out_residual`` -> K5 ``ln_mlp_residual`` and saves
only (x, ctx, x1) per layer; the backward runs K7 and K6
(``ops.backward.fused_encoder_block_bwd``), which recompute LN, QKV, the
probs and FC1 from those.  ``torch.autograd.Function`` takes the place of
``jax.custom_vjp``.

The training forward differs from the inference block (K1 + K2): x1 is
rounded to the working dtype between K4 and K5, because the backward reads
it.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import VMEM_ATTENTION_MAX_T

# the block params in the order FusedEncoderBlockFn takes them
BLOCK_KEYS = (
    "ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
    "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2",
)


def _reference_block_2d(x2d, blk, num_heads, seq_len, eps, gelu_variant="exact"):
    """The same block composed from the eager reference ops — the gradient
    oracle for the fused block (pre-LN: LN1 -> MHA -> residual; LN2 -> MLP
    -> residual)."""
    from vit_tpu_torch.ops import reference as R

    rows, d = x2d.shape
    x = x2d.reshape(rows // seq_len, seq_len, d)
    h = R.layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], eps)
    x = x + R.attention(h, blk["wqkv"], blk["bqkv"], blk["wo"], blk["bo"], num_heads)
    h = R.layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], eps)
    x = x + R.mlp(h, blk["w1"], blk["b1"], blk["w2"], blk["b2"], gelu_variant)
    return x.reshape(rows, d)


class FusedEncoderBlockFn(torch.autograd.Function):
    """(x2d, num_heads, seq_len, eps, gelu_variant, *block params in
    BLOCK_KEYS order) -> x2d, with the kernel backward."""

    @staticmethod
    def forward(ctx, x2d, num_heads, seq_len, eps, gelu_variant, *leaves):
        from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual
        from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn
        from vit_tpu_torch.ops.kernels.out_residual import out_residual

        blk = dict(zip(BLOCK_KEYS, leaves))
        attn = ln_qkv_attn(
            x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["bqkv"],
            num_heads, seq_len, eps,
        )
        x1 = out_residual(attn, x2d, blk["wo"], blk["bo"])
        out = ln_mlp_residual(
            x1, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["b1"],
            blk["w2"], blk["b2"], eps, gelu_variant,
        )
        ctx.save_for_backward(x2d, attn, x1, *leaves)
        ctx.block_args = (num_heads, seq_len, eps, gelu_variant)
        return out

    @staticmethod
    def backward(ctx, g):
        from vit_tpu_torch.ops.backward import fused_encoder_block_bwd

        x2d, attn, x1, *leaves = ctx.saved_tensors
        blk = dict(zip(BLOCK_KEYS, leaves))
        dx, dblk = fused_encoder_block_bwd(
            x2d, blk, attn, x1, g.contiguous(), *ctx.block_args
        )
        return (dx, None, None, None, None, *(dblk[k] for k in BLOCK_KEYS))


def encoder_block_trainable(
    x2d, blk, num_heads: int, seq_len: int, eps: float, gelu_variant: str = "exact"
):
    """The ``fused_train`` table's encoder block on a flat (B*T, D)
    activation.  Past ``VMEM_ATTENTION_MAX_T`` the JAX package trains
    through the blockwise flash-attention VJP, which is not ported."""
    if seq_len > VMEM_ATTENTION_MAX_T:
        raise NotImplementedError(
            f"seq_len {seq_len} > {VMEM_ATTENTION_MAX_T}: the JAX package "
            "trains this through blockwise flash attention (K13/K14) and the "
            "split backward (K8/K9), which are not ported yet (ROADMAP.md)"
        )
    return FusedEncoderBlockFn.apply(
        x2d, num_heads, seq_len, eps, gelu_variant, *(blk[k] for k in BLOCK_KEYS)
    )
