"""K4: out_proj + residual, rounded to the working dtype, CUDA
(``csrc/out_residual.cu``).

Replaces ``vit_tpu/ops/pallas/fused_block.py:out_residual`` (pallas_call at
:333; body ``_out_res_kernel`` :320).

What bounds it on the H100: one GEMM (B/16 batch 64: 12,608 x 768 x 768,
14.9 GFLOP, 0.015 ms at 989 TFLOP/s) near the bytes of reading ctx and the
residual and writing x1 (58 MB at bf16, 0.017 ms at 3.35 TB/s).  The TPU
kernel keeps W_o resident in VMEM and streams row blocks; here bf16, the
path's dtype, runs K2's out_proj on the TMA + ``wgmma`` core
(``csrc/gemm_mma.cuh``): W_o stays in L2, the residual rows of a tile are
prefetched into L2 before its epilogue adds b_o and the residual in fp32
and rounds once.  That rounding is the difference from K2, whose x1 stays
fp32: the training forward rounds x1, and K5 and the backward read that
rounded x1.  The core's tensor maps read ctx and wo, so those must lie on
the 16-byte grid with D and d_ctx multiples of 8 elements
(``check_tile_operands``); the residual and x1 are touched only by the
epilogue, element by element, and need no grid.  fp32 keeps ``gemm.cuh``'s
FMA core, which takes any width.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build


def out_residual_plain(ctx, res, wo, bo) -> torch.Tensor:
    """Plain twin: fp32 compute, one rounding to the dtype."""
    return (ctx.float() @ wo.float() + bo.float() + res.float()).to(ctx.dtype)


def check_tile_operands(ctx, res, wo, *_, **__) -> None:
    """bf16: ctx and wo on the 16-byte grid, their widths (d_ctx, D)
    multiples of 8 elements; the wrapper's arguments, raises ``ValueError``
    otherwise.  res is read by the epilogue only, so it takes any grid."""
    _build.check_tiles("out_residual", ctx=ctx, wo=wo)


def out_residual(ctx, res, wo, bo) -> torch.Tensor:
    """res + ctx @ wo + bo over (B*T, D) rows, rounded.  CPU tensors take
    the plain twin; CUDA tensors launch the kernel."""
    if ctx.device.type == "cpu":
        return out_residual_plain(ctx, res, wo, bo)
    name = "out_residual"
    _build.check_operands(name, ctx, res, wo, bo)
    rows, d_ctx = ctx.shape
    d = res.shape[-1]
    _build.check_shape(name, "res", res, (rows, d))
    _build.check_shape(name, "wo", wo, (d_ctx, d))
    _build.check_shape(name, "bo", bo, (d,))
    if ctx.dtype == torch.bfloat16:
        check_tile_operands(ctx, res, wo)
    out = torch.empty(rows, d, dtype=ctx.dtype, device=ctx.device)
    lib = _build.load_library()
    _build.check(
        lib.vt_out_residual(
            ctx.data_ptr(), res.data_ptr(), wo.data_ptr(), bo.data_ptr(),
            out.data_ptr(), rows, d_ctx, d, _build.DTYPE_CODES[ctx.dtype],
            ctx.device.index, _build.stream_of(ctx),
        ),
        name,
    )
    out_residual.launches += 1
    return out


out_residual.launches = 0
