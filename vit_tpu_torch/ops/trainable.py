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

The regularized block (``encoder_block_train``) runs K1 -> K10 -> K11
forward and K12a -> K6 backward: dropout at torchvision's three in-block
sites and stochastic depth, with the masks regenerated in each kernel from
one seed per layer.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import (
    DROP_SITE_ATTN_OUT,
    DROP_SITE_DP_ATTN,
    DROP_SITE_DP_MLP,
    DROP_SITE_MLP_INNER,
    DROP_SITE_MLP_OUT,
    VMEM_ATTENTION_MAX_T,
    drop_path_scale_rows,
    dropout_mask,
)

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


# -- the regularized block: dropout + stochastic depth inside the kernels ----


class FusedEncoderBlockTrainFn(torch.autograd.Function):
    """(x2d, dp_attn, dp_mlp, seed, num_heads, seq_len, eps, gelu_variant,
    dropout_p, *block params in BLOCK_KEYS order) -> x2d: K1 -> K10 -> K11
    forward, K12a -> K6 backward.  Saves (x, ctx, x1, dp_attn, dp_mlp) and
    the seed; the backward regenerates the masks, so none is saved."""

    @staticmethod
    def forward(ctx, x2d, dp_attn, dp_mlp, seed, num_heads, seq_len, eps, gelu_variant,
                dropout_p, *leaves):
        from vit_tpu_torch.ops.kernels.ln_mlp_residual_train import ln_mlp_residual_train
        from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn
        from vit_tpu_torch.ops.kernels.out_residual_train import out_residual_train

        blk = dict(zip(BLOCK_KEYS, leaves))
        attn = ln_qkv_attn(
            x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["bqkv"],
            num_heads, seq_len, eps,
        )
        x1 = out_residual_train(attn, x2d, blk["wo"], blk["bo"], dp_attn, seed, dropout_p)
        out = ln_mlp_residual_train(
            x1, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["b1"], blk["w2"], blk["b2"],
            dp_mlp, seed, dropout_p, eps, gelu_variant,
        )
        ctx.save_for_backward(x2d, attn, x1, dp_attn, dp_mlp, *leaves)
        ctx.block_args = (seed, dropout_p, num_heads, seq_len, eps, gelu_variant)
        return out

    @staticmethod
    def backward(ctx, g):
        from vit_tpu_torch.ops.backward import fused_encoder_block_bwd_train

        x2d, attn, x1, dp_attn, dp_mlp, *leaves = ctx.saved_tensors
        blk = dict(zip(BLOCK_KEYS, leaves))
        dx, dblk = fused_encoder_block_bwd_train(
            x2d, blk, attn, x1, g.contiguous(), dp_attn, dp_mlp, *ctx.block_args
        )
        return (dx, *(None,) * 8, *(dblk[k] for k in BLOCK_KEYS))


def _drop_path_rows(x2d, seq_len: int, seed: int, drop_path_rate: float):
    """(dp_attn, dp_mlp): the two (rows,) fp32 stochastic-depth scales of a
    block, computed in plain torch on the activation's device."""
    b = x2d.shape[0] // seq_len
    return tuple(
        drop_path_scale_rows(seed, site, b, seq_len, drop_path_rate, device=x2d.device)
        for site in (DROP_SITE_DP_ATTN, DROP_SITE_DP_MLP)
    )


def encoder_block_train(
    x2d, blk, num_heads: int, seq_len: int, eps: float, gelu_variant: str,
    seed: int, dropout_p: float, drop_path_rate: float,
):
    """The ``fused_train`` table's regularized encoder block
    (``vit_tpu/ops/pallas/trainable.py:encoder_block_train``): ``seed`` is
    the layer's uint32 seed (a Python int, a kernel launch argument),
    ``dropout_p`` the config's rate and ``drop_path_rate`` the layer's
    stochastic-depth rate.  The dropout masks are regenerated in the kernels
    from the seed."""
    if seq_len > VMEM_ATTENTION_MAX_T:
        raise ValueError(
            f"dropout/drop-path through the fused kernels supports seq_len <= "
            f"{VMEM_ATTENTION_MAX_T} (got {seq_len}); train very long sequences "
            "with --ops eager"
        )
    dp_attn, dp_mlp = _drop_path_rows(x2d, seq_len, seed, drop_path_rate)
    return FusedEncoderBlockTrainFn.apply(
        x2d, dp_attn, dp_mlp, int(seed), num_heads, seq_len, eps, gelu_variant,
        float(dropout_p), *(blk[k] for k in BLOCK_KEYS),
    )


def train_block_reference_2d(
    x2d, blk, num_heads, seq_len, eps, gelu_variant, seed, dropout_p, drop_path_rate,
):
    """The regularized block composed from the eager reference ops with the
    kernels' masks, bit for bit — its plain twin and the gradient oracle
    (``vit_tpu/ops/pallas/trainable.py:train_block_reference_2d``)."""
    from vit_tpu_torch.ops import reference as R

    rows, d = x2d.shape
    b = rows // seq_len
    dp_attn, dp_mlp = _drop_path_rows(x2d, seq_len, seed, drop_path_rate)

    def drop(x, site, ncols):
        if dropout_p <= 0:
            return x
        return x * dropout_mask(seed, site, 0, (rows, ncols), dropout_p, x.device).to(x.dtype)

    x = x2d.reshape(b, seq_len, d)
    h = R.layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], eps)
    h = R.attention(h, blk["wqkv"], blk["bqkv"], blk["wo"], blk["bo"], num_heads).reshape(rows, d)
    x1 = x2d + drop(h, DROP_SITE_ATTN_OUT, d) * dp_attn.to(h.dtype)[:, None]
    h = R.layer_norm(x1.reshape(b, seq_len, d), blk["ln2_scale"], blk["ln2_bias"], eps)
    u = R.linear(h.reshape(rows, d), blk["w1"], blk["b1"])
    g = R.gelu_exact(u) if gelu_variant == "exact" else R.gelu_tanh(u)
    y = R.linear(drop(g, DROP_SITE_MLP_INNER, blk["w1"].shape[-1]), blk["w2"], blk["b2"])
    return x1 + drop(y, DROP_SITE_MLP_OUT, d) * dp_mlp.to(y.dtype)[:, None]
