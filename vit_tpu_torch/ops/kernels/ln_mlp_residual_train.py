"""K11: LN2 -> FC1 -> GELU -> dropout -> FC2 -> dropout -> stochastic depth
-> residual, CUDA (``csrc/ln_mlp_residual_train.cu``).

Replaces ``vit_tpu/ops/pallas/fused_block.py:ln_mlp_residual_train``
(pallas_call at :542; body ``_ln_mlp_train_kernel`` :507):
``g = round(gelu(LN2(x) @ W1 + b1) * m_in)``,
``out = round(((g @ W2 + b2) * m_out) * dp[r] + x)``.

What bounds it on the H100: K5's two GEMMs (B/16 batch 64: 119 GFLOP of
tensor-core work).  The design is K5's chain with gated epilogues: bf16,
the main path, writes h = round(LN2(x)) once into a bf16 (rows, D)
scratch and runs h @ W1 and g @ W2 on the TMA + ``wgmma`` core
(``csrc/gemm_mma.cuh``), with a (rows, F) ``g`` scratch between them;
the inner mask multiplies GELU's fp32 output before g rounds, the outer
mask and the stochastic-depth scale multiply FC2's output before the
residual, whose rows and scales the core prefetches into L2 before that
epilogue.  x, W1 and W2 must lie on the 16-byte grid with D and F
multiples of 8 elements (``check_tile_operands``).  fp32 keeps the first
design: FMA GEMMs (never TF32) with LN2 applied in FC1's A-tile load.
Masks come from the hash of (seed, site, global row, col), never stored;
the dropout gate is a template flag, so ``dropout_p == 0`` runs K5's
arithmetic exactly (bit for bit at a drop-path rate of 0).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import (
    DROP_SITE_MLP_INNER,
    DROP_SITE_MLP_OUT,
    _gelu,
    _ln,
    dropout_launch_args,
    dropout_mask,
    use_fast_erf,
)
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS


def ln_mlp_residual_train_plain(
    x2d, ln_scale, ln_bias, w1, b1, w2, b2, dp_scale, seed, dropout_p, eps,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points, products in its order."""
    dtype, dev = x2d.dtype, x2d.device
    h = _ln(x2d, ln_scale, ln_bias, eps).to(dtype)
    u = h.float() @ w1.float() + b1.float()
    g = _gelu(u, gelu_variant, fast_erf=use_fast_erf(dtype))
    if dropout_p > 0:
        g = g * dropout_mask(seed, DROP_SITE_MLP_INNER, 0, g.shape, dropout_p, dev)
    acc = g.to(dtype).float() @ w2.float() + b2.float()
    if dropout_p > 0:
        acc = acc * dropout_mask(seed, DROP_SITE_MLP_OUT, 0, acc.shape, dropout_p, dev)
    return (acc * dp_scale.float()[:, None] + x2d.float()).to(dtype)


def check_tile_operands(x2d, ln_scale, ln_bias, w1, b1, w2, *_, **__) -> None:
    """bf16: x and the two weights, which the GEMM core reads through TMA
    tensor maps (D and F also set the scratches' pitches), on the 16-byte
    grid; the wrapper's arguments, raises ``ValueError`` otherwise."""
    _build.check_tiles("ln_mlp_residual_train", x=x2d, w1=w1, w2=w2)


def ln_mlp_residual_train(
    x2d, ln_scale, ln_bias, w1, b1, w2, b2, dp_scale, seed, dropout_p, eps,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """x + dp_scale * drop(drop(GELU(FC1(LN2(x)))) @ W2 + b2) over (B*T, D)
    rows.  CPU tensors take the plain twin; CUDA tensors launch the
    kernel."""
    if x2d.device.type == "cpu":
        return ln_mlp_residual_train_plain(
            x2d, ln_scale, ln_bias, w1, b1, w2, b2, dp_scale, seed, dropout_p, eps, gelu_variant
        )
    name = "ln_mlp_residual_train"
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_operands(name, x2d, ln_scale, ln_bias, w1, b1, w2, b2)
    rows, d = x2d.shape
    f = w1.shape[-1]
    for n, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias), ("b2", b2)):
        _build.check_shape(name, n, t, (d,))
    _build.check_shape(name, "w1", w1, (d, f))
    _build.check_shape(name, "b1", b1, (f,))
    _build.check_shape(name, "w2", w2, (f, d))
    _build.check_row_scale(name, "dp_scale", dp_scale, x2d)
    dev = x2d.device
    stats = h = None  # fp32's LN2 statistics, or bf16's LN2(x) rows
    if x2d.dtype == torch.bfloat16:
        check_tile_operands(x2d, ln_scale, ln_bias, w1, b1, w2)
        h = torch.empty(rows, d, dtype=x2d.dtype, device=dev)
    else:
        stats = torch.empty(2 * rows, dtype=torch.float32, device=dev)
    g = torch.empty(rows, f, dtype=x2d.dtype, device=dev)
    out = torch.empty(rows, d, dtype=x2d.dtype, device=dev)
    lib = _build.load_library()
    _build.check(
        lib.vt_ln_mlp_residual_train(
            *(t.data_ptr() for t in (x2d, ln_scale, ln_bias, w1, b1, w2, b2, dp_scale)),
            _build.ptr_or_null(stats), _build.ptr_or_null(h), g.data_ptr(), out.data_ptr(),
            rows, d, f, eps, GELU_VARIANTS[gelu_variant], *dropout_launch_args(seed, dropout_p),
            _build.DTYPE_CODES[x2d.dtype], dev.index, _build.stream_of(x2d),
        ),
        name,
    )
    ln_mlp_residual_train.launches += 1
    return out


ln_mlp_residual_train.launches = 0
