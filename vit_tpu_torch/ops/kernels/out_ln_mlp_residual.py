"""K2: out_proj + residual -> LN2 -> FC1 -> GELU -> FC2 -> residual, CUDA
(``csrc/out_ln_mlp_residual.cu``).

Replaces ``vit_tpu/ops/pallas/fused_block.py:out_ln_mlp_residual``
(pallas_call at :617; body ``_out_ln_mlp_kernel`` :589).

What bounds it on the H100: operations — three GEMMs (B/16 batch 100:
19,700 rows, D = 768, F = 3,072; 23 + 93 + 93 GFLOP) of tensor-core work.
The TPU kernel keeps W_o, W1 and W2 (10.6 MB bf16) resident in VMEM and
never writes x1 or the (rows, F) hidden activation; a Hopper block has
227 KB of shared memory, so the design runs three tiled GEMMs that stream
weight tiles, with the elementwise steps around them:

  1. x1 = ctx @ W_o + b_o + res, kept in an fp32 device scratch and never
     rounded (rounding it would change the second residual);
  2. LN2 of x1 (fp32 statistics and affine), rounded to the dtype;
  3. epilogue u + b1 -> GELU in fp32 -> g rounded to the dtype, into a
     (rows, F) scratch (121 MB at batch 100 bf16 — the second fusion
     target for later work);
  4. out = g @ W2 + b2 + x1, rounded to the dtype.

bf16, the main path, runs the GEMMs on the pipelined ``cp.async`` +
``wgmma`` core (``csrc/gemm_mma.cuh``), with step 2 a row pass that
writes LN2(x1) once into a bf16 (rows, D) scratch FC1 copies as is; every
operand the core copies 16 bytes at a time (ctx, W_o, W1, W2) is on the
16-byte grid with widths in multiples of 8 elements
(``check_tile_operands``).  fp32 keeps the first design: fp32 FMA GEMMs
(never TF32) with LN2 applied in FC1's A-tile load from row statistics.
GELU: the fp32 path uses the Abramowitz-Stegun erf, the bf16 path the
tanh-form erf (``fused_block._erf``/``_erf_tanh_inner``).  Ragged row
tiles load zeros.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _gelu, _ln, use_fast_erf
from vit_tpu_torch.ops.kernels import _build

GELU_VARIANTS = {"exact": 0, "tanh": 1}


def out_ln_mlp_residual_plain(
    ctx, res, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, eps,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points."""
    dtype = ctx.dtype
    x1 = ctx.float() @ wo.float() + bo.float() + res.float()
    h = _ln(x1, ln_scale, ln_bias, eps).to(dtype)
    u = h.float() @ w1.float() + b1.float()
    g = _gelu(u, gelu_variant, fast_erf=use_fast_erf(dtype)).to(dtype)
    return (g.float() @ w2.float() + b2.float() + x1).to(dtype)


def check_tile_operands(ctx, res, wo, bo, ln_scale, ln_bias, w1, b1, w2, *_, **__) -> None:
    """bf16: the operands the GEMM core copies 16 bytes at a time — ctx and
    the three weights, whose widths also set the scratches' pitches — on
    the 16-byte grid; the wrapper's arguments, raises ``ValueError``
    otherwise."""
    _build.check_tiles("out_ln_mlp_residual", ctx=ctx, wo=wo, w1=w1, w2=w2)


def out_ln_mlp_residual(
    ctx, res, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, eps,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """res + ctx@wo+bo -> LN2 -> FC1 -> GELU -> FC2 -> +residual over
    (B*T, D) rows.  CPU tensors take the plain twin; CUDA tensors launch
    the kernel."""
    if ctx.device.type == "cpu":
        return out_ln_mlp_residual_plain(
            ctx, res, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2, eps,
            gelu_variant,
        )
    name = "out_ln_mlp_residual"
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_operands(name, ctx, res, wo, bo, ln_scale, ln_bias, w1, b1, w2, b2)
    rows, d_ctx = ctx.shape
    d = res.shape[-1]
    f = w1.shape[-1]
    _build.check_shape(name, "res", res, (rows, d))
    _build.check_shape(name, "wo", wo, (d_ctx, d))
    for n, t in (("bo", bo), ("ln_scale", ln_scale), ("ln_bias", ln_bias), ("b2", b2)):
        _build.check_shape(name, n, t, (d,))
    _build.check_shape(name, "w1", w1, (d, f))
    _build.check_shape(name, "b1", b1, (f,))
    _build.check_shape(name, "w2", w2, (f, d))
    dev = ctx.device
    x1 = torch.empty(rows, d, dtype=torch.float32, device=dev)
    stats = h = None  # fp32's LN2 statistics, or bf16's LN2(x1) rows
    if ctx.dtype == torch.bfloat16:
        check_tile_operands(ctx, res, wo, bo, ln_scale, ln_bias, w1, b1, w2)
        h = torch.empty(rows, d, dtype=ctx.dtype, device=dev)
    else:
        stats = torch.empty(2 * rows, dtype=torch.float32, device=dev)
    g = torch.empty(rows, f, dtype=ctx.dtype, device=dev)
    out = torch.empty(rows, d, dtype=ctx.dtype, device=dev)
    lib = _build.load_library()
    _build.check(
        lib.vt_out_ln_mlp_residual(
            ctx.data_ptr(), res.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            ln_scale.data_ptr(), ln_bias.data_ptr(), w1.data_ptr(),
            b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), x1.data_ptr(),
            _build.ptr_or_null(stats), _build.ptr_or_null(h), g.data_ptr(),
            out.data_ptr(), rows, d_ctx, d,
            f, eps, GELU_VARIANTS[gelu_variant],
            _build.DTYPE_CODES[ctx.dtype], dev.index, _build.stream_of(ctx),
        ),
        name,
    )
    out_ln_mlp_residual.launches += 1
    return out


out_ln_mlp_residual.launches = 0
