"""K8: split backward of [LN2 + MLP + residual], CUDA
(``csrc/ln_mlp_residual_bwd.cu``).

Replaces ``vit_tpu/ops/pallas/backward.py:ln_mlp_residual_bwd``
(pallas_call at :253; body ``_ln_mlp_bwd_kernel`` :182 with
``_mlp_bwd_core`` :111 and ``_mlp_grad_accum`` :159), in both its
``residual`` forms, with or without the pre-GELU stash ``u`` (K7's: one
pass widens it into the fp32 u/du scratch in place of the FC1 GEMM,
``csrc/ln_mlp_out_residual_bwd.cuh:UStash``).  ``residual=False``
is the VJP of K5's tensor-parallel partial form (the caller
``vit_tpu/parallel/tp_forward.py:_lmp_bwd``): dx1 is the LayerNorm backward
alone, without dy's identity term (the kernel body's one line at :198);
the weight gradients and db2 are as before, and the caller drops db2.  The
flag is host-side: the LN-backward row pass launches its no-join kernel
(``ln_bwd_rows_nores_kernel``, ``csrc/common.cuh``), so K7, K8 with the
residual, K12a and K12b keep their machine code.

What bounds it on the H100: 10·rows·D·F operations of tensor-core work in
five GEMMs (ViT-B/16 @512 batch 16: 16,400 rows, D = 768, F = 3,072;
387 GFLOP, 0.39 ms at 989 TFLOP/s), two of them weight gradients whose
depth is the ragged row axis.  It is K7 without the out_proj tail: a chain
of tiled GEMMs over all rows with device scratch between them, the
elementwise steps in their epilogues, and every reduction over rows as its
own fixed-order pass (split-K partials and 128-row column-sum partials
summed in order; no atomics), where the TPU kernel carried its
accumulators in VMEM across a sequential grid.  bf16, the path's dtype,
runs the chain on the TMA + ``wgmma`` core (``csrc/mlp_bwd_mma.cuh`` over
``csrc/gemm_mma.cuh``): LN2(x1) once per row into a bf16 scratch, W2ᵀ and
W1ᵀ read K-major, h2ᵀ and gᵀ read MN-major, the weight gradients split
over rows; every operand the core reads through a tensor map (dy, w1, w2)
and x1 on the 16-byte grid, D and F multiples of 8 elements
(``check_tile_operands``).  fp32 keeps K7's code
(``csrc/ln_mlp_out_residual_bwd.cuh``) on the FMA core, LN2 in the tile
loads.

Rounding points (the TPU kernel's): x-hat and 1/sigma from the rounded x1
in fp32; h2 rounded; u fp32; g = GELU(u) rounded only as dW2's operand;
du = (dy W2ᵀ) gelu'(u) fp32, rounded to du_c; dh2 = du_c W1ᵀ; dx1 = dy +
LN-bwd(dh2) (LN-bwd(dh2) without the residual) in fp32, written in the
dtype.  bf16 differentiates the
tanh-form erf, fp32 the A-S form.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.ln_mlp_out_residual_bwd import check_stash, mlp_residual_bwd_plain
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS


def ln_mlp_residual_bwd_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, eps,
                              gelu_variant: str = "exact", residual: bool = True, u=None):
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points.  -> (dx1, dgamma, dbeta, dw1, db1, dw2, db2); dx1 in the dtype,
    the rest fp32."""
    dx1, *grads = mlp_residual_bwd_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant,
                                         residual, u)
    return (dx1.to(dy.dtype), *grads)


def check_tile_operands(dy, x1, ln_scale, ln_bias, w1, b1, w2, *_, **__) -> None:
    """bf16: dy, x1 and the two weights on the 16-byte grid, their widths
    (D, and F through w1) multiples of 8 elements; the wrapper's arguments,
    raises ``ValueError`` otherwise."""
    _build.check_tiles("ln_mlp_residual_bwd", dy=dy, x1=x1, w1=w1, w2=w2)


def ln_mlp_residual_bwd(
    dy, x1, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant: str = "exact",
    u=None, residual: bool = True,
):
    """VJP of ``ln_mlp_residual`` (K5) over (B*T, D) rows, from the upstream
    gradient ``dy`` and the saved x1 -> (dx1, dgamma, dbeta, dw1, db1, dw2,
    db2).  ``residual=False`` is the tensor-parallel partial form (dx1 without
    dy's identity term); ``u`` (rows, F), the forward's pre-GELU stash,
    replaces the FC1 recompute.  CPU tensors take the plain twin; CUDA
    tensors launch the kernel."""
    name = "ln_mlp_residual_bwd"
    if dy.device.type == "cpu":
        return ln_mlp_residual_bwd_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant,
                                         residual, u)
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_operands(name, dy, x1, ln_scale, ln_bias, w1, b1, w2)
    rows, d = dy.shape
    f = w1.shape[-1]
    _build.check_shape(name, "x1", x1, (rows, d))
    _build.check_shape(name, "ln_scale", ln_scale, (d,))
    _build.check_shape(name, "ln_bias", ln_bias, (d,))
    _build.check_shape(name, "w1", w1, (d, f))
    _build.check_shape(name, "b1", b1, (f,))
    _build.check_shape(name, "w2", w2, (f, d))
    u_code = check_stash(name, u, dy, f)
    if dy.dtype == torch.bfloat16:
        check_tile_operands(dy, x1, ln_scale, ln_bias, w1, b1, w2)
    dev, code = dy.device, _build.DTYPE_CODES[dy.dtype]
    f32 = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    outs = (torch.empty(rows, d, dtype=dy.dtype, device=dev),
            f32(d), f32(d), f32(d, f), f32(f), f32(f, d), f32(d))
    ws = _build.workspace("vt_ln_mlp_residual_bwd_workspace", dev, rows, d, f, code)
    lib = _build.load_library()
    _build.check(
        lib.vt_ln_mlp_residual_bwd(
            *(t.data_ptr() for t in (dy, x1, ln_scale, ln_bias, w1, b1, w2)),
            _build.ptr_or_null(u), *(t.data_ptr() for t in outs), ws.data_ptr(), rows, d, f, eps,
            GELU_VARIANTS[gelu_variant], int(bool(residual)), u_code, code, dev.index,
            _build.stream_of(dy),
        ),
        name,
    )
    ln_mlp_residual_bwd.launches += 1
    ln_mlp_residual_bwd.stash_launches += u is not None
    return outs


ln_mlp_residual_bwd.launches = 0
ln_mlp_residual_bwd.stash_launches = 0  # the launches given u=
