"""Backward of the fused encoder block: two CUDA kernels from the saved
(x, ctx, x1).

Counterpart of ``vit_tpu.ops.pallas.backward``:

  K7 ``ln_mlp_out_residual_bwd``  d[LN2 + MLP + residual] chained into
                                  d[out_proj + residual]
  K12a ``ln_mlp_out_residual_bwd_train``  K7 through the regularized
                                  block's dropout and drop-path gates
  K6 ``ln_qkv_attn_bwd``          d[LN1 + QKV + attention] joined with the
                                  first residual's gradient

The plain twins' shared numerics live here, as in the JAX module:
``_gelu_grad`` (exact, fast-erf and tanh forms), ``_ln_stats`` and
``_ln_bwd_dx``.  The CUDA sources compute the same formulas
(``csrc/common.cuh``).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _ERF_TANH_Q, _erf, _erf_tanh_inner

_INV_SQRT2PI = 0.3989422804014327  # 1/sqrt(2*pi)


def _gelu_grad(u: torch.Tensor, variant: str, fast_erf: bool = False) -> torch.Tensor:
    """d gelu(u) / du in fp32 for both GELU variants.

    exact:  Phi(u) + u * phi(u); ``fast_erf`` differentiates the tanh-form
            erf instead (|err| 1.7e-4, below bf16 resolution)
    tanh:   0.5(1+t) + 0.5 u (1-t^2) c (1+3*0.044715 u^2)
    """
    if variant == "exact":
        if fast_erf:
            inv_sqrt2 = 0.7071067811865476
            sc, q, t = _erf_tanh_inner(u * inv_sqrt2)
            tsq = sc * sc
            qp = torch.full_like(tsq, (len(_ERF_TANH_Q) - 1) * _ERF_TANH_Q[-1])
            for i in range(len(_ERF_TANH_Q) - 2, 0, -1):
                qp = qp * tsq + i * _ERF_TANH_Q[i]
            vp = q + 2.0 * tsq * qp  # d(s*q(s^2))/ds
            return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * vp * inv_sqrt2
        phi_cdf = 0.5 * (1.0 + _erf(u * 0.7071067811865476))
        pdf = _INV_SQRT2PI * torch.exp(-0.5 * u * u)
        return phi_cdf + u * pdf
    c = 0.7978845608028654
    t = torch.tanh(c * (u + 0.044715 * u * u * u))
    return 0.5 * (1.0 + t) + 0.5 * u * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * u * u)


def _ln_stats(x_f32: torch.Tensor, eps: float):
    """-> (xhat, 1/sigma) per row, fp32, centred variance."""
    mean = x_f32.mean(dim=-1, keepdim=True)
    c = x_f32 - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    return c * inv, inv


def _ln_bwd_dx(dh, xhat, inv, gamma):
    """Input gradient of y = xhat*gamma + beta (per-row statistics)."""
    dxhat = dh * gamma
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return inv * (dxhat - m1 - xhat * m2)


def fused_encoder_block_bwd(
    x2d, blk, ctx, x1, g, num_heads: int, seq_len: int, eps: float,
    gelu_variant: str = "exact",
):
    """Full-block backward from the saved (x, ctx, x1): K7 then K6.

    Returns (dx, dblk), dblk with the params dict's keys, each gradient
    cast to its parameter's dtype as the JAX backward does (under mixed
    precision the fp32 accumulators round to bf16 here, and the cast's own
    backward widens them to the fp32 master weights).

    Every sequence length this block takes (T <= 1024) runs the merged K7.
    The JAX package splits it into K8 + K9 when its VMEM bill passes
    ``MERGED_BWD_VMEM_BUDGET`` (vit_tpu/ops/pallas/backward.py:1014-1019),
    a limit of the TPU's VMEM; K7 keeps its accumulators and scratch in
    device memory, so that bound does not apply on the card.  K8 and K9
    run past the switch, in the long-sequence block (``ops/trainable.py``).
    """
    from vit_tpu_torch.ops.kernels.ln_mlp_out_residual_bwd import ln_mlp_out_residual_bwd
    from vit_tpu_torch.ops.kernels.ln_qkv_attn_bwd import ln_qkv_attn_bwd

    (dx1, dctx, dg2, dbt2, dw1, db1, dw2, db2, dwo, dbo) = ln_mlp_out_residual_bwd(
        g, x1, ctx, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["b1"],
        blk["w2"], blk["wo"], eps, gelu_variant,
    )
    dx, dg1, dbt1, dwqkv, dbqkv = ln_qkv_attn_bwd(
        dctx, dx1, x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
        blk["bqkv"], num_heads, seq_len, eps,
    )
    return dx, _block_grads(blk, dg1, dbt1, dwqkv, dbqkv, dwo, dbo, dg2, dbt2, dw1, db1, dw2, db2)


def _block_grads(blk, dg1, dbt1, dwqkv, dbqkv, dwo, dbo, dg2, dbt2, dw1, db1, dw2, db2):
    """The block's gradients under the params dict's keys, each cast to its
    parameter's dtype (the JAX backward's ``like``)."""
    grads = {
        "ln1_scale": dg1, "ln1_bias": dbt1, "wqkv": dwqkv, "bqkv": dbqkv,
        "wo": dwo, "bo": dbo, "ln2_scale": dg2, "ln2_bias": dbt2,
        "w1": dw1, "b1": db1, "w2": dw2, "b2": db2,
    }
    return {k: v.to(blk[k].dtype) for k, v in grads.items()}


def fused_encoder_block_bwd_train(
    x2d, blk, ctx, x1, g, dp_attn, dp_mlp, seed: int, dropout_p: float, num_heads: int,
    seq_len: int, eps: float, gelu_variant: str = "exact",
):
    """The regularized block's backward from the saved (x, ctx, x1), the
    (rows,) drop-path scales and the seed: K12a then K6 (counterpart of
    ``vit_tpu/ops/pallas/backward.py:fused_encoder_block_bwd_train``).  K12a
    regenerates the forward's dropout masks; K6 is unchanged, because the
    recipe has no attention-probability dropout.  Every T <= 1024 runs the
    merged K12a, as :func:`fused_encoder_block_bwd` runs K7 (the JAX
    package's split K12b + K12c is its VMEM route)."""
    from vit_tpu_torch.ops.kernels.ln_mlp_out_residual_bwd_train import (
        ln_mlp_out_residual_bwd_train,
    )
    from vit_tpu_torch.ops.kernels.ln_qkv_attn_bwd import ln_qkv_attn_bwd

    (dx1, dctx, dg2, dbt2, dw1, db1, dw2, db2, dwo, dbo) = ln_mlp_out_residual_bwd_train(
        g, x1, ctx, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["b1"],
        blk["w2"], blk["wo"], dp_mlp, dp_attn, seed, dropout_p, eps, gelu_variant,
    )
    dx, dg1, dbt1, dwqkv, dbqkv = ln_qkv_attn_bwd(
        dctx, dx1, x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
        blk["bqkv"], num_heads, seq_len, eps,
    )
    return dx, _block_grads(blk, dg1, dbt1, dwqkv, dbqkv, dwo, dbo, dg2, dbt2, dw1, db1, dw2, db2)
