"""K17: LN2 -> int8 FC1 -> GELU -> int8 FC2 -> residual, CUDA
(``csrc/ln_mlp_residual_q8.cu``); and the plain twin of the W8A8 MLP that
K16 shares (``csrc/mlp_q8.cuh``).

Replaces ``vit_tpu/ops/pallas/quant_kernels.py:ln_mlp_residual_q8`` (def
:260, pallas_call at :274; body ``_ln_mlp_q8_kernel`` :235): K16 without the
out_proj head.  Token merging's W8A8 forward (``models/tome.forward_quant``)
runs it, because the merge sits between the out_proj and the MLP.

W1 and W2 arrive as int8 [in, out] with fp32 per-column scales.  What
bounds it on the H100: two int8 GEMMs (B/16 batch 100: 19,700 rows, D =
768, F = 3,072; 2 x 93 G integer operations) at the tensor cores' int8
rate.  Four launches behind one C entry point, x1 being x itself:

  1. LN2 of x1 in fp32 from fp32 statistics (h is not rounded to the
     dtype), per-row int8 codes hq and scales hs (``csrc/quant_rows.cuh``);
  2. int8 FC1 with exact int32 sums (``csrc/gemm_q8.cuh``); epilogue
     (acc * hs) * w1s + b1 -> GELU in fp32 -> ``mid`` kept in fp32 — K2
     rounds its GELU output to the dtype, the W8A8 kernels do not;
  3. per-row int8 codes mq and scales ms of mid.  The quantizer needs each
     row's largest |mid| over all F columns, which span 24 column tiles of
     FC1's grid, so mid goes through a (rows, F) fp32 device scratch (242 MB
     at batch 100) that the TPU kernel keeps in VMEM: this kernel's first
     fusion target (per-tile partial maxima, then one pass that quantizes);
  4. int8 FC2; epilogue (acc * ms) * w2s + b2 + x1, rounded to the dtype.

GELU: the fp32 path uses the Abramowitz-Stegun erf, the bf16 path the
tanh-form erf.  Ragged row tiles load zeros.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _gelu, _ln, use_fast_erf
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS
from vit_tpu_torch.ops.quant import int8_matmul_reference, quantize_activations


def fc1_gelu_q8_plain(hq, hs, w1q, w1s, b1, gelu_variant: str, dtype) -> torch.Tensor:
    """Stage 2's twin: codes and row scales -> fp32 ``mid``; ``dtype`` (the
    working dtype) picks the erf form."""
    u = int8_matmul_reference(hq, hs, w1q, w1s.float(), b1.float())
    return _gelu(u, gelu_variant, fast_erf=use_fast_erf(dtype))


def fc2_residual_q8_plain(mq, ms, w2q, w2s, b2, x1, dtype) -> torch.Tensor:
    """Stage 4's twin: codes and row scales of mid -> the block output."""
    return (int8_matmul_reference(mq, ms, w2q, w2s.float(), b2.float()) + x1.float()).to(dtype)


def mlp_q8_plain(x1, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps, gelu_variant, dtype):
    """The W8A8 MLP's plain twin on ``x1`` (fp32 in K16, the dtype's x in
    K17) -> every stage: {hq, hs, mid, mq, ms, out}."""
    hq, hs = quantize_activations(_ln(x1, ln_scale, ln_bias, eps))
    mid = fc1_gelu_q8_plain(hq, hs, w1q, w1s, b1, gelu_variant, dtype)
    mq, ms = quantize_activations(mid)
    out = fc2_residual_q8_plain(mq, ms, w2q, w2s, b2, x1, dtype)
    return {"hq": hq, "hs": hs, "mid": mid, "mq": mq, "ms": ms, "out": out}


def ln_mlp_residual_q8_plain(
    x2d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps, gelu_variant: str = "exact",
) -> torch.Tensor:
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points."""
    return mlp_q8_plain(x2d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps, gelu_variant,
                        x2d.dtype)["out"]


def check_mlp_q8_operands(name, x, d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, gelu_variant,
                 like_x=()):
    """Raise on what the W8A8 MLP's kernels do not take; -> F."""
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_q8_operands(name, x, (*like_x, ln_scale, ln_bias, b1, b2), (w1q, w2q),
                             (w1s, w2s))
    f = w1q.shape[-1]
    for n, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias), ("b2", b2), ("w2s", w2s)):
        _build.check_shape(name, n, t, (d,))
    _build.check_shape(name, "w1q", w1q, (d, f))
    _build.check_shape(name, "w1s", w1s, (f,))
    _build.check_shape(name, "b1", b1, (f,))
    _build.check_shape(name, "w2q", w2q, (f, d))
    return f


def mlp_q8_scratch(rows: int, d: int, f: int, dtype, dev) -> dict:
    """The W8A8 MLP's device scratches and its output."""
    return {
        "hq": torch.empty(rows, d, dtype=torch.int8, device=dev),
        "hs": torch.empty(rows, dtype=torch.float32, device=dev),
        "mid": torch.empty(rows, f, dtype=torch.float32, device=dev),
        "mq": torch.empty(rows, f, dtype=torch.int8, device=dev),
        "ms": torch.empty(rows, dtype=torch.float32, device=dev),
        "out": torch.empty(rows, d, dtype=dtype, device=dev),
    }


def _ln_mlp_residual_q8_stages(x2d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps,
                               gelu_variant="exact"):
    """-> {hq, hs, mid, mq, ms, out}: the kernel's scratches and output on
    the card, the twin's on the CPU."""
    if x2d.device.type == "cpu":
        return mlp_q8_plain(x2d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps,
                            gelu_variant, x2d.dtype)
    name = "ln_mlp_residual_q8"
    rows, d = x2d.shape
    f = check_mlp_q8_operands(name, x2d, d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, gelu_variant)
    st = mlp_q8_scratch(rows, d, f, x2d.dtype, x2d.device)
    _build.check(
        _build.load_library().vt_ln_mlp_residual_q8(
            x2d.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1q.data_ptr(),
            w1s.data_ptr(), b1.data_ptr(), w2q.data_ptr(), w2s.data_ptr(), b2.data_ptr(),
            *(st[k].data_ptr() for k in ("hq", "hs", "mid", "mq", "ms", "out")),
            rows, d, f, eps, GELU_VARIANTS[gelu_variant], _build.DTYPE_CODES[x2d.dtype],
            x2d.device.index, _build.stream_of(x2d),
        ),
        name,
    )
    ln_mlp_residual_q8.launches += 1
    return st


def ln_mlp_residual_q8(
    x2d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps, gelu_variant: str = "exact",
) -> torch.Tensor:
    """LN2 -> int8 FC1 -> GELU -> int8 FC2 -> +x over (B*T, D) rows.  CPU
    tensors take the plain twin; CUDA tensors launch the kernel."""
    return _ln_mlp_residual_q8_stages(
        x2d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps, gelu_variant
    )["out"]


ln_mlp_residual_q8.launches = 0
