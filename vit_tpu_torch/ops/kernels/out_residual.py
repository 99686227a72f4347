"""K4: out_proj + residual, rounded to the working dtype, CUDA
(``csrc/out_residual.cu``).

Replaces ``vit_tpu/ops/pallas/fused_block.py:out_residual`` (pallas_call at
:333; body ``_out_res_kernel`` :320).

What bounds it on the H100: one GEMM (B/16 batch 64: 12,608 x 768 x 768,
15 GFLOP) of tensor-core work, plus reading ctx and the residual and
writing x1 (58 MB at bf16).  The TPU kernel keeps W_o resident in VMEM and
streams row blocks; here the tiled GEMM of ``csrc/gemm.cuh`` streams W_o
tiles and adds b_o and the residual in fp32 in its epilogue, then rounds
once.  That rounding is the difference from K2, whose x1 stays fp32: the
training forward rounds x1, and K5 and the backward read that rounded x1.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build


def out_residual_plain(ctx, res, wo, bo) -> torch.Tensor:
    """Plain twin: fp32 compute, one rounding to the dtype."""
    return (ctx.float() @ wo.float() + bo.float() + res.float()).to(ctx.dtype)


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
