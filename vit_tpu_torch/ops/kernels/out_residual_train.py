"""K10: out_proj + dropout + stochastic depth + residual, CUDA
(``csrc/out_residual_train.cu``).

Replaces ``vit_tpu/ops/pallas/fused_block.py:out_residual_train``
(pallas_call at :390; body ``_out_res_train_kernel`` :359):
``x1 = round(((ctx @ wo + bo) * m_attn) * dp[r] + res)``.

What bounds it on the H100: as K4, the bytes (B/16 batch 64 bf16: reading
ctx and the residual and writing x1, 59 MB) more than the GEMM (15 GFLOP).
The design is K4's tiled GEMM with one new epilogue: the attention-out
dropout mask is regenerated there from the hash of (seed, site, row, col)
and never stored, and the stochastic-depth scale is a (rows,) fp32 vector.
The gate is a template flag, so ``dropout_p == 0`` runs K4's arithmetic
exactly (bit for bit at a drop-path rate of 0).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import DROP_SITE_ATTN_OUT, dropout_launch_args, dropout_mask
from vit_tpu_torch.ops.kernels import _build


def out_residual_train_plain(ctx, res, wo, bo, dp_scale, seed, dropout_p) -> torch.Tensor:
    """Plain twin: fp32 compute in the TPU kernel's product order, one
    rounding to the dtype."""
    acc = ctx.float() @ wo.float() + bo.float()
    if dropout_p > 0:
        acc = acc * dropout_mask(seed, DROP_SITE_ATTN_OUT, 0, acc.shape, dropout_p, acc.device)
    return (acc * dp_scale.float()[:, None] + res.float()).to(ctx.dtype)


def out_residual_train(ctx, res, wo, bo, dp_scale, seed, dropout_p) -> torch.Tensor:
    """res + dp_scale * dropout(ctx @ wo + bo) over (B*T, D) rows, rounded.
    ``dp_scale`` (rows,) fp32; ``seed`` an int (its low 32 bits).  CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    if ctx.device.type == "cpu":
        return out_residual_train_plain(ctx, res, wo, bo, dp_scale, seed, dropout_p)
    name = "out_residual_train"
    _build.check_operands(name, ctx, res, wo, bo)
    rows, d_ctx = ctx.shape
    d = res.shape[-1]
    _build.check_shape(name, "res", res, (rows, d))
    _build.check_shape(name, "wo", wo, (d_ctx, d))
    _build.check_shape(name, "bo", bo, (d,))
    _build.check_row_scale(name, "dp_scale", dp_scale, ctx)
    out = torch.empty(rows, d, dtype=ctx.dtype, device=ctx.device)
    lib = _build.load_library()
    _build.check(
        lib.vt_out_residual_train(
            ctx.data_ptr(), res.data_ptr(), wo.data_ptr(), bo.data_ptr(), dp_scale.data_ptr(),
            out.data_ptr(), rows, d_ctx, d, *dropout_launch_args(seed, dropout_p),
            _build.DTYPE_CODES[ctx.dtype], ctx.device.index, _build.stream_of(ctx),
        ),
        name,
    )
    out_residual_train.launches += 1
    return out


out_residual_train.launches = 0
