"""K8: split backward of [LN2 + MLP + residual], CUDA
(``csrc/ln_mlp_residual_bwd.cu``).

Replaces ``vit_tpu/ops/pallas/backward.py:ln_mlp_residual_bwd``
(pallas_call at :253; body ``_ln_mlp_bwd_kernel`` :182 with
``_mlp_bwd_core`` :111 and ``_mlp_grad_accum`` :159), in its
``residual=True`` form without the pre-GELU stash ``u``.

What bounds it on the H100: 10·rows·D·F operations of tensor-core work in
five GEMMs (ViT-B/16 @512 batch 16: 16,400 rows, D = 768, F = 3,072;
387 GFLOP, 0.39 ms at 989 TFLOP/s), two of them weight gradients whose
depth is the ragged row axis.  It is K7 without the out_proj tail and
shares K7's code (``csrc/ln_mlp_out_residual_bwd.cuh``): a chain of tiled
GEMMs over all rows with device scratch between them, the elementwise
steps in their loads and epilogues, and every reduction over rows as its
own fixed-order pass (split-K partials and 128-row column-sum partials
summed in order; no atomics), where the TPU kernel carried its
accumulators in VMEM across a sequential grid.

Rounding points (the TPU kernel's): x-hat and 1/sigma from the rounded x1
in fp32; h2 rounded; u fp32; g = GELU(u) rounded only as dW2's operand;
du = (dy W2ᵀ) gelu'(u) fp32, rounded to du_c; dh2 = du_c W1ᵀ; dx1 = dy +
LN-bwd(dh2) in fp32, written in the dtype.  bf16 differentiates the
tanh-form erf, fp32 the A-S form.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.ln_mlp_out_residual_bwd import mlp_residual_bwd_plain
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS


def ln_mlp_residual_bwd_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, eps,
                              gelu_variant: str = "exact"):
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points.  -> (dx1, dgamma, dbeta, dw1, db1, dw2, db2); dx1 in the dtype,
    the rest fp32."""
    dx1, *grads = mlp_residual_bwd_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant)
    return (dx1.to(dy.dtype), *grads)


def ln_mlp_residual_bwd(
    dy, x1, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant: str = "exact",
    u=None, residual: bool = True,
):
    """VJP of ``ln_mlp_residual`` (K5) over (B*T, D) rows, from the upstream
    gradient ``dy`` and the saved x1 -> (dx1, dgamma, dbeta, dw1, db1, dw2,
    db2).  CPU tensors take the plain twin; CUDA tensors launch the kernel.
    ``u=`` (the pre-GELU stash) and ``residual=False`` (the tensor-parallel
    partial form) belong to later slices and raise."""
    name = "ln_mlp_residual_bwd"
    if u is not None or not residual:
        raise NotImplementedError(
            f"{name}: u= (the stash hook) and residual=False (tensor parallel) are not "
            "ported yet (ROADMAP.md)"
        )
    if dy.device.type == "cpu":
        return ln_mlp_residual_bwd_plain(dy, x1, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant)
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
    dev, code = dy.device, _build.DTYPE_CODES[dy.dtype]
    f32 = lambda *shape: torch.empty(*shape, dtype=torch.float32, device=dev)  # noqa: E731
    outs = (torch.empty(rows, d, dtype=dy.dtype, device=dev),
            f32(d), f32(d), f32(d, f), f32(f), f32(f, d), f32(d))
    ws = _build.workspace("vt_ln_mlp_residual_bwd_workspace", dev, rows, d, f, code)
    lib = _build.load_library()
    _build.check(
        lib.vt_ln_mlp_residual_bwd(
            *(t.data_ptr() for t in (dy, x1, ln_scale, ln_bias, w1, b1, w2)),
            *(t.data_ptr() for t in outs), ws.data_ptr(), rows, d, f, eps,
            GELU_VARIANTS[gelu_variant], code, dev.index, _build.stream_of(dy),
        ),
        name,
    )
    ln_mlp_residual_bwd.launches += 1
    return outs


ln_mlp_residual_bwd.launches = 0
