"""K16: out_proj + residual -> LN2 -> int8 FC1 -> GELU -> int8 FC2 ->
residual, CUDA (``csrc/out_ln_mlp_residual_q8.cu``).

Replaces ``vit_tpu/ops/pallas/quant_kernels.py:out_ln_mlp_residual_q8``
(def :195, pallas_call at :207; body ``_out_ln_mlp_q8_kernel`` :166).

W_o stays in the working dtype (an int8 W_o would need one more row
quantizer pass over ctx); W1 and W2 arrive as int8 [in, out] with fp32
per-column scales.  What bounds it on the H100: the out_proj (B/16 batch
100: 23 GFLOP in the working dtype) and two int8 GEMMs (2 x 93 G integer
operations).  Five launches behind one C entry point:

  1. x1 = ctx @ W_o + b_o + res, K2's first stage unchanged: an fp32 device
     scratch, never rounded;
  2-5. the W8A8 MLP on x1 (``ln_mlp_residual_q8.py`` has the stages and
     their scratches, the fp32 ``mid`` among them: 242 MB at batch 100, the
     first fusion target).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.ln_mlp_residual_q8 import (
    check_mlp_q8_operands,
    mlp_q8_plain,
    mlp_q8_scratch,
)
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS


def out_proj_residual_plain(ctx, res, wo, bo) -> torch.Tensor:
    """Stage 1's twin: fp32 x1 = ctx @ W_o + b_o + res."""
    return ctx.float() @ wo.float() + bo.float() + res.float()


def out_ln_mlp_residual_q8_plain(
    ctx, res, wo, bo, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points."""
    x1 = out_proj_residual_plain(ctx, res, wo, bo)
    return mlp_q8_plain(x1, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps, gelu_variant,
                        ctx.dtype)["out"]


def _out_ln_mlp_residual_q8_stages(ctx, res, wo, bo, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s,
                                   b2, eps, gelu_variant="exact"):
    """-> {x1, hq, hs, mid, mq, ms, out}: the kernel's scratches and output
    on the card, the twin's on the CPU."""
    if ctx.device.type == "cpu":
        x1 = out_proj_residual_plain(ctx, res, wo, bo)
        return {"x1": x1, **mlp_q8_plain(x1, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps,
                                         gelu_variant, ctx.dtype)}
    name = "out_ln_mlp_residual_q8"
    rows, d_ctx = ctx.shape
    d = res.shape[-1]
    f = check_mlp_q8_operands(name, ctx, d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, gelu_variant,
                     like_x=(res, wo, bo))
    _build.check_shape(name, "res", res, (rows, d))
    _build.check_shape(name, "wo", wo, (d_ctx, d))
    _build.check_shape(name, "bo", bo, (d,))
    dev = ctx.device
    st = {"x1": torch.empty(rows, d, dtype=torch.float32, device=dev),
          **mlp_q8_scratch(rows, d, f, ctx.dtype, dev)}
    _build.check(
        _build.load_library().vt_out_ln_mlp_residual_q8(
            ctx.data_ptr(), res.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), w1q.data_ptr(), w1s.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
            w2s.data_ptr(), b2.data_ptr(),
            *(st[k].data_ptr() for k in ("x1", "hq", "hs", "mid", "mq", "ms", "out")),
            rows, d_ctx, d, f, eps, GELU_VARIANTS[gelu_variant], _build.DTYPE_CODES[ctx.dtype],
            dev.index, _build.stream_of(ctx),
        ),
        name,
    )
    out_ln_mlp_residual_q8.launches += 1
    return st


def out_ln_mlp_residual_q8(
    ctx, res, wo, bo, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """res + ctx@wo+bo -> LN2 -> int8 FC1 -> GELU -> int8 FC2 -> +residual
    over (B*T, D) rows.  CPU tensors take the plain twin; CUDA tensors
    launch the kernel."""
    return _out_ln_mlp_residual_q8_stages(
        ctx, res, wo, bo, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps, gelu_variant
    )["out"]


out_ln_mlp_residual_q8.launches = 0
