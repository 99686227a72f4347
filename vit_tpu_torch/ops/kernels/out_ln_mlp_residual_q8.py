"""K16: out_proj + residual -> LN2 -> int8 FC1 -> GELU -> int8 FC2 ->
residual, CUDA (``csrc/out_ln_mlp_residual_q8.cu``).

Replaces ``vit_tpu/ops/pallas/quant_kernels.py:out_ln_mlp_residual_q8``
(def :195, pallas_call at :207; body ``_out_ln_mlp_q8_kernel`` :166).

W_o stays in the working dtype (an int8 W_o would need one more row
quantizer pass over ctx); W1 and W2 arrive as int8 [in, out] with fp32
per-column scales.  What bounds it on the H100: the out_proj (B/16 batch
100: 23 GFLOP in the working dtype) and two int8 GEMMs (2 x 93 G integer
operations).  One C entry point launches the stages:

  1. x1 = ctx @ W_o + b_o + res, an fp32 device scratch, never rounded;
  2. LN2 of x1 and its per-row int8 codes hq and scales hs;
  3. mid = GELU((hq @ W1q) hs w1s + b1) in fp32 (a (rows, F) scratch, 242
     MB at batch 100: each row's largest |mid| spans all F columns);
  4. per-row codes mq and scales ms of mid;
  5. out = (mq @ W2q) ms w2s + b2 + x1, rounded to the dtype.

bf16, the main path: stage 1 on the bf16 TMA + ``wgmma`` core
(``csrc/gemm_mma.cuh``: ctx and W_o on the 16-byte grid, widths multiples
of 8), stages 3 and 5 on the int8 one (``csrc/gemm_mma_q8.cuh``), which
reads both operands K-major: the sequence first copies W1q and W2q
transposed into two int8 scratches (``kmajor_q8.py``'s kernel; the
parameters keep the JAX package's [in, out] layout), and stage 4 is K16's
own row pass that reads mid once.  Stages 2-5 are the chain the bf16 K17
runs on its own x (``csrc/gemm_mma_q8.cuh``'s ``mlp_q8_mma``).  fp32 keeps
the first design: the FMA out_proj and the WMMA int8 MLP that the fp32 K17
runs (``ln_mlp_residual_q8.py`` has its stages).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.kmajor_q8 import kmajor_q8_scratch
from vit_tpu_torch.ops.kernels.ln_mlp_residual_q8 import (
    check_mlp_q8_operands,
    mlp_q8_plain,
    mlp_q8_scratch,
)
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS
from vit_tpu_torch.ops.quant import int8_matmul_reference


def gemm_q8_mma_dequant(x_q, s_x, w_t, s_w) -> torch.Tensor:
    """The int8 TMA + ``wgmma`` core alone: fp32 ``(x_q @ w_tᵀ) s_x s_w``
    with ``w_t`` the K-major (N, K) copy of an int8 [in, out] weight, for
    its exactness test and timing (no model path calls it).  CPU tensors
    take ``quant.int8_matmul_reference``."""
    if x_q.device.type == "cpu":
        return int8_matmul_reference(x_q, s_x, w_t.t(), s_w)
    name = "gemm_q8_mma_dequant"
    for t, dtype in ((x_q, torch.int8), (w_t, torch.int8), (s_x, torch.float32),
                     (s_w, torch.float32)):
        if t.dtype != dtype or t.device != x_q.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous int8 matrices and float32 "
                             f"scales on {x_q.device}")
    m, k = x_q.shape
    n = w_t.shape[0]
    _build.check_shape(name, "w_t", w_t, (n, k))
    _build.check_q8_matrices(name, w_t)  # N and K multiples of 16
    if x_q.data_ptr() % _build.Q8_VEC:
        raise ValueError(f"{name}: x_q must be {_build.Q8_VEC}-byte aligned")
    _build.check_shape(name, "s_x", s_x, (m,))
    _build.check_shape(name, "s_w", s_w, (n,))
    out = torch.empty(m, n, dtype=torch.float32, device=x_q.device)
    _build.check(_build.load_library().vt_gemm_q8_mma_dequant(
        x_q.data_ptr(), s_x.data_ptr(), w_t.data_ptr(), s_w.data_ptr(), out.data_ptr(), m, n, k,
        x_q.device.index, _build.stream_of(x_q)), name)
    return out


def check_tile_operands(ctx, res, wo, bo, ln_scale, ln_bias, w1q, w1s, b1, w2q, *_,
                        **__) -> None:
    """bf16: what the two cores read through TMA tensor maps — ctx and W_o
    on the 16-byte grid with widths multiples of 8 (the bf16 core); W1q and
    W2q two-dimensional, 16-byte aligned, both dimensions multiples of 16
    (the int8 core, on their K-major copies, and the scratches' pitches D
    and F); the wrapper's arguments, raises ``ValueError`` otherwise."""
    name = "out_ln_mlp_residual_q8"
    _build.check_tiles(name, ctx=ctx, wo=wo)
    _build.check_q8_matrices(name, w1q, w2q)


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
    on the card, the twin's on the CPU; bf16 on the card adds {w1t, w2t},
    the K-major weight copies its int8 GEMMs read."""
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
    if ctx.dtype == torch.bfloat16:
        check_tile_operands(ctx, res, wo, bo, ln_scale, ln_bias, w1q, w1s, b1, w2q)
        st["w1t"], st["w2t"] = kmajor_q8_scratch(w1q, w2q)
    _build.check(
        _build.load_library().vt_out_ln_mlp_residual_q8(
            ctx.data_ptr(), res.data_ptr(), wo.data_ptr(), bo.data_ptr(), ln_scale.data_ptr(),
            ln_bias.data_ptr(), w1q.data_ptr(), w1s.data_ptr(), b1.data_ptr(), w2q.data_ptr(),
            w2s.data_ptr(), b2.data_ptr(), _build.ptr_or_null(st.get("w1t")),
            _build.ptr_or_null(st.get("w2t")),
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
