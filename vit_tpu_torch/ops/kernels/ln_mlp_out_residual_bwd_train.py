"""K12a: merged backward of the regularized [LN2 + MLP + residual] and
[out_proj + residual], CUDA (``csrc/ln_mlp_out_residual_bwd_train.cu``).

Replaces ``vit_tpu/ops/pallas/backward.py:ln_mlp_out_residual_bwd_train``
(pallas_call at :515; body ``_ln_mlp_out_bwd_train_kernel`` :430 with
``_mlp_bwd_core`` :111).

What bounds it on the H100: operations, K7's seven GEMMs (B/16 @224 batch
64: 327 GFLOP of tensor-core work).  The design is K7's chain, with the
forward's masks regenerated from the seed at the same points (nothing
mask-shaped is stored between forward and backward):

  dy_m = (dy * dp_mlp) * m_out     FC2's backward reads round(dy_m)
  g    = round(gelu(u) * m_in)     dW2's operand
  du   = ((round(dy_m) @ W2^T) * m_in) * gelu'(u)
  dx1  = dy + LN-bwd(round(du) @ W1^T)        ungated residual path
  dz   = (dx1_f32 * dp_attn) * m_attn         out_proj's backward reads round(dz)

dz gates K7's fp32 dx1 scratch, not the rounded output; db2 sums dy_m and
db_o sums dz in fp32, and dctx = round(round(dz) W_oᵀ), dW_o = ctxᵀ
round(dz).  Each gated operand is hashed once per element where it is
summed and once where it is written rounded into K7's fp32 (rows, D)
scratches while they are free, so the GEMMs read plain tiles (hashing in
the tile loads re-hashed each element once per output tile column); no new
scratch, and the reductions stay K7's deterministic passes.  bf16, the
path's dtype, runs K7's chain on the TMA + ``wgmma`` core with the gates
compiled in (``csrc/mlp_bwd_mma.cuh``), under K7's operand rule
(``check_tile_operands``); fp32 keeps the FMA core.  The dropout gate is a
template flag, so ``dropout_p == 0`` runs K7's arithmetic exactly (bit for
bit at drop-path rates of 0).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import dropout_launch_args
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.ln_mlp_residual_bwd_train import mlp_residual_bwd_train_plain
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS
from vit_tpu_torch.ops.kernels.out_residual_bwd_train import out_residual_bwd_train_plain


def ln_mlp_out_residual_bwd_train_plain(
    dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, dp_mlp, dp_attn, seed, dropout_p, eps,
    gelu_variant: str = "exact",
):
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points and its products' order — K12b's twin, then K12c's on the
    unrounded dx1.  -> (dx1, dctx, dgamma, dbeta, dw1, db1, dw2, db2, dwo,
    dbo); dx1 and dctx in the dtype, the rest fp32."""
    dx1, dgamma, dbeta, dw1, db1, dw2, db2 = mlp_residual_bwd_train_plain(
        dy, x1, ln_scale, ln_bias, w1, b1, w2, dp_mlp, seed, dropout_p, eps, gelu_variant)
    dctx, dwo, dbo = out_residual_bwd_train_plain(dx1, ctx, wo, dp_attn, seed, dropout_p)
    return dx1.to(dy.dtype), dctx, dgamma, dbeta, dw1, db1, dw2, db2, dwo, dbo


def check_tile_operands(dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, *_, **__) -> None:
    """bf16: K7's operand rule (dy, x1, ctx, w1, w2, wo on the 16-byte
    grid, D, d_ctx and F multiples of 8 elements) on the wrapper's
    arguments; raises ``ValueError`` otherwise."""
    _build.check_tiles("ln_mlp_out_residual_bwd_train", dy=dy, x1=x1, ctx=ctx, w1=w1, w2=w2,
                       wo=wo)


def ln_mlp_out_residual_bwd_train(
    dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, dp_mlp, dp_attn, seed, dropout_p, eps,
    gelu_variant: str = "exact",
):
    """VJP of the regularized [out_proj + residual] then [LN2 + MLP +
    residual] over (B*T, D) rows, from the upstream gradient ``dy``, the
    saved x1 and ctx, the (rows,) fp32 drop-path scales and the seed.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    if dy.device.type == "cpu":
        return ln_mlp_out_residual_bwd_train_plain(
            dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, dp_mlp, dp_attn, seed, dropout_p,
            eps, gelu_variant,
        )
    name = "ln_mlp_out_residual_bwd_train"
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_operands(name, dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo)
    rows, d = dy.shape
    d_ctx = ctx.shape[-1]
    f = w1.shape[-1]
    _build.check_shape(name, "x1", x1, (rows, d))
    _build.check_shape(name, "ctx", ctx, (rows, d_ctx))
    _build.check_shape(name, "ln_scale", ln_scale, (d,))
    _build.check_shape(name, "ln_bias", ln_bias, (d,))
    _build.check_shape(name, "w1", w1, (d, f))
    _build.check_shape(name, "b1", b1, (f,))
    _build.check_shape(name, "w2", w2, (f, d))
    _build.check_shape(name, "wo", wo, (d_ctx, d))
    _build.check_row_scale(name, "dp_mlp", dp_mlp, dy)
    _build.check_row_scale(name, "dp_attn", dp_attn, dy)
    if dy.dtype == torch.bfloat16:
        check_tile_operands(dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo)
    dev, code = dy.device, _build.DTYPE_CODES[dy.dtype]
    f32 = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    outs = (
        torch.empty(rows, d, dtype=dy.dtype, device=dev),
        torch.empty(rows, d_ctx, dtype=dy.dtype, device=dev),
        f32(d), f32(d), f32(d, f), f32(f), f32(f, d), f32(d), f32(d_ctx, d), f32(d),
    )
    ws = _build.workspace("vt_ln_mlp_out_residual_bwd_train_workspace", dev, rows, d, f, d_ctx,
                          code)
    lib = _build.load_library()
    _build.check(
        lib.vt_ln_mlp_out_residual_bwd_train(
            *(t.data_ptr() for t in (dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo, dp_mlp,
                                     dp_attn)),
            *(t.data_ptr() for t in outs), ws.data_ptr(), rows, d, f, d_ctx, eps,
            GELU_VARIANTS[gelu_variant], *dropout_launch_args(seed, dropout_p), code, dev.index,
            _build.stream_of(dy),
        ),
        name,
    )
    ln_mlp_out_residual_bwd_train.launches += 1
    return outs


ln_mlp_out_residual_bwd_train.launches = 0
