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

Token merging's training (``models/tome.forward_train``) runs the block as
split pieces around the merge GEMM: ``TomeLnQkvAttnFn`` (K1 with its hooks
forward, K6 with ``log_size`` and no residual join backward), then
``OutResidualFn``/``LnMlpResidualFn`` or, with dropout, their regularized
forms ``OutResidualTrainFn`` (K10 forward, K12c backward) and
``LnMlpResidualTrainFn`` (K11 forward, K12b backward).

Past ``fused_block.VMEM_ATTENTION_MAX_T`` tokens the block is
``_long_seq_block_trainable``: LN1 and the QKV product in plain
differentiable torch, flash attention (K13 forward, K14 backward), then
``OutResidualFn`` (K4 forward, K9 backward) and ``LnMlpResidualFn`` (K5
forward, K8 backward) — the counterparts of the JAX module's
``_out_residual_diff`` and ``_ln_mlp_residual_diff``.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops import fused_block
from vit_tpu_torch.ops.fused_block import (
    DROP_SITE_ATTN_OUT,
    DROP_SITE_DP_ATTN,
    DROP_SITE_DP_MLP,
    DROP_SITE_MLP_INNER,
    DROP_SITE_MLP_OUT,
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


class OutResidualFn(torch.autograd.Function):
    """(ctx, res, wo, bo) -> res + ctx @ wo + bo, rounded: K4 forward, K9
    backward.  The residual's gradient is the upstream gradient itself."""

    @staticmethod
    def forward(ctx, attn, res, wo, bo):
        from vit_tpu_torch.ops.kernels.out_residual import out_residual

        ctx.save_for_backward(attn, wo, bo)
        return out_residual(attn, res, wo, bo)

    @staticmethod
    def backward(ctx, g):
        from vit_tpu_torch.ops.kernels.out_residual_bwd import out_residual_bwd

        attn, wo, bo = ctx.saved_tensors
        dctx, dwo, dbo = out_residual_bwd(g.contiguous(), attn, wo)
        return dctx, g, dwo.to(wo.dtype), dbo.to(bo.dtype)


class LnMlpResidualFn(torch.autograd.Function):
    """(x1, ln_scale, ln_bias, w1, b1, w2, b2, eps, gelu_variant) -> x1 +
    MLP(LN2(x1)): K5 forward, K8 backward; each gradient in its input's
    dtype."""

    @staticmethod
    def forward(ctx, x1, s, b, w1, b1, w2, b2, eps, gelu_variant):
        from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual

        ctx.save_for_backward(x1, s, b, w1, b1, w2, b2)
        ctx.block_args = (eps, gelu_variant)
        return ln_mlp_residual(x1, s, b, w1, b1, w2, b2, eps, gelu_variant)

    @staticmethod
    def backward(ctx, g):
        from vit_tpu_torch.ops.kernels.ln_mlp_residual_bwd import ln_mlp_residual_bwd

        x1, *params = ctx.saved_tensors
        s, b, w1, b1, w2, _ = params
        dx1, *grads = ln_mlp_residual_bwd(g.contiguous(), x1, s, b, w1, b1, w2, *ctx.block_args)
        return (dx1, *(d.to(p.dtype) for d, p in zip(grads, params)), None, None)


# -- the split pieces of token-merging training (models/tome.forward_train) --
# The merge sits between out_proj and the MLP, so the block runs as three
# differentiable pieces with the merge GEMM between the second and third.


class TomeLnQkvAttnFn(torch.autograd.Function):
    """(x2d, ln_scale, ln_bias, wqkv, bqkv, log_size, num_heads, seq_len,
    eps, return_kmean) -> ctx, or (ctx, kmean): K1 with token merging's
    hooks forward, K6 with ``log_size`` and without the residual join
    backward (``vit_tpu/ops/pallas/trainable.py:tome_ln_qkv_attn_diff``).
    The k-mean and the sizes get no gradient: the matching is treated as a
    constant, as in the ToMe paper's training."""

    @staticmethod
    def forward(ctx, x2d, ln_scale, ln_bias, wqkv, bqkv, log_size, num_heads, seq_len, eps,
                return_kmean):
        from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn

        out = ln_qkv_attn(x2d, ln_scale, ln_bias, wqkv, bqkv, num_heads, seq_len, eps,
                          log_size=log_size, return_kmean=return_kmean)
        ctx.save_for_backward(x2d, ln_scale, ln_bias, wqkv, bqkv, log_size)
        ctx.block_args = (num_heads, seq_len, eps)
        if return_kmean:
            ctx.mark_non_differentiable(out[1])
        return out

    @staticmethod
    def backward(ctx, g, *_):
        from vit_tpu_torch.ops.kernels.ln_qkv_attn_bwd import ln_qkv_attn_bwd

        x2d, s, b, w, bias, log_size = ctx.saved_tensors
        dx, ds, db, dw, dbias = ln_qkv_attn_bwd(g.contiguous(), None, x2d, s, b, w, bias,
                                                *ctx.block_args, log_size=log_size)
        return (dx, ds.to(s.dtype), db.to(b.dtype), dw.to(w.dtype), dbias.to(bias.dtype),
                None, None, None, None, None)


def tome_ln_qkv_attn(x2d, ln_scale, ln_bias, wqkv, bqkv, log_size, num_heads: int,
                     seq_len: int, eps: float, return_kmean: bool):
    """Differentiable [LN1 + QKV + attention (+ log-size bias)] -> ctx, or
    (ctx, kmean) (:class:`TomeLnQkvAttnFn`)."""
    return TomeLnQkvAttnFn.apply(x2d, ln_scale, ln_bias, wqkv, bqkv, log_size, num_heads,
                                 seq_len, eps, bool(return_kmean))


class OutResidualTrainFn(torch.autograd.Function):
    """(ctx, res, wo, bo, dp_attn, seed, dropout_p) -> res + dp_attn *
    dropout(ctx @ wo + bo): K10 forward, K12c backward.  The residual's
    gradient is the upstream gradient itself; the row scale and the seed
    get none."""

    @staticmethod
    def forward(ctx, attn, res, wo, bo, dp_attn, seed, dropout_p):
        from vit_tpu_torch.ops.kernels.out_residual_train import out_residual_train

        ctx.save_for_backward(attn, wo, bo, dp_attn)
        ctx.reg = (seed, dropout_p)
        return out_residual_train(attn, res, wo, bo, dp_attn, seed, dropout_p)

    @staticmethod
    def backward(ctx, g):
        from vit_tpu_torch.ops.kernels.out_residual_bwd_train import out_residual_bwd_train

        attn, wo, bo, dp_attn = ctx.saved_tensors
        dctx, dwo, dbo = out_residual_bwd_train(g.contiguous(), attn, wo, dp_attn, *ctx.reg)
        return dctx, g, dwo.to(wo.dtype), dbo.to(bo.dtype), None, None, None


class LnMlpResidualTrainFn(torch.autograd.Function):
    """(x1, ln_scale, ln_bias, w1, b1, w2, b2, dp_mlp, seed, dropout_p, eps,
    gelu_variant) -> x1 + dp_mlp * dropout(MLP(LN2(x1))) with the inner
    dropout: K11 forward, K12b backward; each gradient in its input's
    dtype."""

    @staticmethod
    def forward(ctx, x1, s, b, w1, b1, w2, b2, dp_mlp, seed, dropout_p, eps, gelu_variant):
        from vit_tpu_torch.ops.kernels.ln_mlp_residual_train import ln_mlp_residual_train

        ctx.save_for_backward(x1, s, b, w1, b1, w2, b2, dp_mlp)
        ctx.block_args = (seed, dropout_p, eps, gelu_variant)
        return ln_mlp_residual_train(x1, s, b, w1, b1, w2, b2, dp_mlp, seed, dropout_p, eps,
                                     gelu_variant)

    @staticmethod
    def backward(ctx, g):
        from vit_tpu_torch.ops.kernels.ln_mlp_residual_bwd_train import (
            ln_mlp_residual_bwd_train,
        )

        x1, *params, dp_mlp = ctx.saved_tensors
        s, b, w1, b1, w2, _ = params
        dx1, *grads = ln_mlp_residual_bwd_train(g.contiguous(), x1, s, b, w1, b1, w2, dp_mlp,
                                                *ctx.block_args)
        return (dx1, *(d.to(p.dtype) for d, p in zip(grads, params)), None, None, None, None,
                None)


def _long_seq_block_trainable(x2d, blk, num_heads: int, seq_len: int, eps: float,
                              gelu_variant: str = "exact"):
    """The differentiable block past ``VMEM_ATTENTION_MAX_T``
    (``vit_tpu/ops/pallas/trainable.py:_long_seq_block_trainable``): plain
    LN1 + QKV, flash attention (K13/K14), then K4/K9 and K5/K8."""
    from vit_tpu_torch.ops import reference as R
    from vit_tpu_torch.ops.flash_attention import flash_context_from_packed_qkv

    rows, d = x2d.shape
    b = rows // seq_len
    h = R.layer_norm(x2d.reshape(b, seq_len, d), blk["ln1_scale"], blk["ln1_bias"], eps)
    qkv = R.linear(h, blk["wqkv"], blk["bqkv"])  # columns (H, 3, Dh)
    ctx2 = flash_context_from_packed_qkv(qkv, b, seq_len, num_heads)
    x1 = OutResidualFn.apply(ctx2, x2d, blk["wo"], blk["bo"])
    return LnMlpResidualFn.apply(
        x1, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["b1"], blk["w2"], blk["b2"],
        eps, gelu_variant,
    )


def encoder_block_trainable(
    x2d, blk, num_heads: int, seq_len: int, eps: float, gelu_variant: str = "exact"
):
    """The ``fused_train`` table's encoder block on a flat (B*T, D)
    activation; past ``fused_block.VMEM_ATTENTION_MAX_T`` (read at call
    time), the long-sequence block."""
    if seq_len > fused_block.VMEM_ATTENTION_MAX_T:
        return _long_seq_block_trainable(x2d, blk, num_heads, seq_len, eps, gelu_variant)
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
    max_t = fused_block.VMEM_ATTENTION_MAX_T
    if seq_len > max_t:
        raise ValueError(
            f"dropout/drop-path through the fused kernels supports seq_len <= "
            f"{max_t} (got {seq_len}); train very long sequences "
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
