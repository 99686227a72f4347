"""K9: split backward of [out_proj + residual], CUDA
(``csrc/out_residual_bwd.cu``).

Replaces ``vit_tpu/ops/pallas/backward.py:out_residual_bwd`` (pallas_call
at :785; body ``_out_res_bwd_kernel`` :754).

What bounds it on the H100: 4·rows·D·D_ctx operations of tensor-core work
in two GEMMs (ViT-B/16 @512 batch 16: 16,400 x 768 x 768; 38.7 GFLOP,
0.039 ms at 989 TFLOP/s), the weight gradient's depth the ragged row axis.
The TPU kernel carried dW_o and db_o in VMEM across a sequential grid;
here every reduction over rows is its own fixed-order pass, no atomics,
so two runs give the same bits.  bf16, the path's dtype, is the bf16 K7's
out_proj tail (``out_proj_bwd_mma`` in ``csrc/mlp_bwd_mma.cuh``) on the
TMA + ``wgmma`` core (``csrc/gemm_mma.cuh``): dctx = round(dx1 W_oᵀ) with
W_o read K-major, dW_o = ctxᵀ dx1 with ctx read MN-major and the rows
split over the grid by a rule of the shape alone (fp32 partials summed in
split order), db_o as 128-row column-sum partials of the bf16 dx1 summed
in order (K7 sums its fp32 dx1 instead).  The core's tensor maps need dx1,
ctx and wo on the 16-byte grid and D and d_ctx multiples of 8 elements
(``check_tile_operands``).  fp32 keeps ``gemm.cuh``'s FMA core
(``csrc/ln_mlp_out_residual_bwd.cuh``).  The residual's gradient is dx1
itself; the caller passes it on.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build


def out_residual_bwd_plain(dx1, ctx, wo):
    """Plain twin -> (dctx in the dtype, dwo fp32, dbo fp32)."""
    dx1f = dx1.float()
    return (dx1f @ wo.float().t()).to(dx1.dtype), ctx.float().t() @ dx1f, dx1f.sum(0)


def check_tile_operands(dx1, ctx, wo, *_, **__) -> None:
    """bf16: dx1, ctx and wo on the 16-byte grid, their widths (D, d_ctx)
    multiples of 8 elements; the wrapper's arguments, raises
    ``ValueError`` otherwise."""
    _build.check_tiles("out_residual_bwd", dx1=dx1, ctx=ctx, wo=wo)


def out_residual_bwd(dx1, ctx, wo):
    """VJP of ``out_residual`` (K4) over (B*T, D) rows -> (dctx, dwo, dbo).
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    if dx1.device.type == "cpu":
        return out_residual_bwd_plain(dx1, ctx, wo)
    name = "out_residual_bwd"
    _build.check_operands(name, dx1, ctx, wo)
    rows, d = dx1.shape
    d_ctx = ctx.shape[-1]
    _build.check_shape(name, "ctx", ctx, (rows, d_ctx))
    _build.check_shape(name, "wo", wo, (d_ctx, d))
    if dx1.dtype == torch.bfloat16:
        check_tile_operands(dx1, ctx, wo)
    dev, code = dx1.device, _build.DTYPE_CODES[dx1.dtype]
    outs = (torch.empty(rows, d_ctx, dtype=dx1.dtype, device=dev),
            torch.empty(d_ctx, d, dtype=torch.float32, device=dev),
            torch.empty(d, dtype=torch.float32, device=dev))
    ws = _build.workspace("vt_out_residual_bwd_workspace", dev, rows, d_ctx, d, code)
    lib = _build.load_library()
    _build.check(
        lib.vt_out_residual_bwd(
            dx1.data_ptr(), ctx.data_ptr(), wo.data_ptr(), *(t.data_ptr() for t in outs),
            ws.data_ptr(), rows, d_ctx, d, code, dev.index, _build.stream_of(dx1),
        ),
        name,
    )
    out_residual_bwd.launches += 1
    return outs


out_residual_bwd.launches = 0
