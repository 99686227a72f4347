"""K22: FC1 + b1 -> GELU -> FC2 + b2 over the last axis, CUDA
(``csrc/mlp.cu``) — the per-op tier's MLP.

Replaces ``vit_tpu/ops/pallas/mlp_kernel.py:mlp`` (pallas_call at :96; body
``_mlp_kernel`` :42): no LayerNorm, no residual; any leading shape
flattens to (rows, D).

What bounds it on the H100: tensor-core work (B/16 @224 batch 100: two
19,700 x 768 x 3,072 GEMMs, 186 GFLOP).  The TPU kernel keeps W1 and W2
resident in VMEM and never writes the hidden activation; a Hopper block
has 227 KB of shared memory, so the design is K5's MLP without its LN2 and
residual — two tiled GEMMs (``csrc/gemm.cuh``) over a (rows, F) scratch
``g`` in device memory (121 MB at batch 100 bf16): x @ W1 into an epilogue
that adds b1 and takes GELU in fp32 and rounds g to x's dtype, then g @ W2
into one that adds b2 and rounds.  GELU: the A-S erf in fp32, the
tanh-form erf in bf16 (``fused_block.use_fast_erf``), or the tanh variant;
fp32 GEMMs never use TF32.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _gelu, use_fast_erf
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS


def mlp_plain(x, w1, b1, w2, b2, gelu_variant: str = "exact") -> torch.Tensor:
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points."""
    dtype = x.dtype
    u = x.float() @ w1.float() + b1.float()
    g = _gelu(u, gelu_variant, fast_erf=use_fast_erf(dtype)).to(dtype)
    return (g.float() @ w2.float() + b2.float()).to(dtype)


def mlp(x, w1, b1, w2, b2, gelu_variant: str = "exact", inner_dropout=None) -> torch.Tensor:
    """GELU MLP over the last axis of ``x`` (..., D); w1 (D, F), b1 (F,),
    w2 (F, D), b2 (D,).  CPU tensors take the plain twin; CUDA tensors
    launch the kernel.  The per-op tier has no regularizer hooks: an
    ``inner_dropout`` raises."""
    name = "mlp"
    if inner_dropout is not None:
        raise ValueError(
            f"{name}: the per-op kernel tier has no regularizer hooks (no inner "
            "dropout); train with ops='fused_train' or 'eager'"
        )
    if x.device.type == "cpu":
        return mlp_plain(x, w1, b1, w2, b2, gelu_variant)
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_operands(name, x, w1, b1, w2, b2)
    d, f = w1.shape[0], w1.shape[-1]
    _build.check_shape(name, "w1", w1, (d, f))
    _build.check_shape(name, "b1", b1, (f,))
    _build.check_shape(name, "w2", w2, (f, d))
    _build.check_shape(name, "b2", b2, (d,))
    if x.shape[-1] != d:
        raise ValueError(f"{name}: x has {x.shape[-1]} features, W1 takes {d}")
    rows = x.numel() // d
    dev = x.device
    g = torch.empty(rows, f, dtype=x.dtype, device=dev)
    out = torch.empty(x.shape, dtype=x.dtype, device=dev)
    lib = _build.load_library()
    _build.check(
        lib.vt_mlp(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(),
            g.data_ptr(), out.data_ptr(), rows, d, f, GELU_VARIANTS[gelu_variant],
            _build.DTYPE_CODES[x.dtype], dev.index, _build.stream_of(x),
        ),
        name,
    )
    mlp.launches += 1
    return out


mlp.launches = 0
