"""Hold the W8A8 kernels (K15-K17) to their plain twins stage by stage.

A kernel and its twin reduce LayerNorm's mean and variance in different
orders, so the fp32 h they quantize differs in its last bits, and a code
that sat on a rounding boundary moves by one.  One moved code shifts a
GEMM output by a whole quantization step (about 2^-8 of a typical value at
ViT-B/16 widths): inside the bf16 tolerance, far outside the fp32 one.  So
the kernel's output is not compared with the twin's end to end at the fp32
tolerance.  Two checks instead, on the stage scratches the wrappers
allocate anyway (their ``_*_stages`` functions):

  (a) every row quantizer, against the twin's quantizer on the same input
      stage of the kernel: each scale within ``SCALE_RTOL``, every code
      within 1, and at most ``FLIP_SHARE`` of the codes different.  Where
      the input is itself a device scratch in fp32 (``mid``) nothing is
      reduced but a maximum, which is order-independent: there the codes
      and scales must be equal bit for bit.
  (b) every other stage, the twin's stage run ON THE KERNEL'S OWN codes and
      scales (or packed QKV, or x1) against the kernel's next stage, at
      the usual tolerance of the dtype: int32 accumulation is exact, so
      this holds the GEMMs, the dequantization order, the GELU, the
      attention and the residuals tightly.

The output is also held to the whole twin's, at ``END_RTOL``, the size of
a few moved codes.

Where the bounds come from.  The kernel's rstd is ``rsqrtf`` (within 2
ulps) of a variance summed in another order than torch's, so h, and with it
the row's absmax and scale, differs by a few ulps: ``SCALE_RTOL`` is 8 ulps
(2^-20).  h / scale lies in [-127, 127]; a relative difference of 2^-20
moves it by at most 127 x 2^-20 = 1.2e-4, and a code flips only where
h / scale lay that close to a half-integer, which for a smooth density of
fractional parts happens for at most 2 x 1.2e-4 of the codes:
``FLIP_SHARE`` is 1e-3, four times that.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _ln
from vit_tpu_torch.ops.kernels.ln_mlp_residual_q8 import (
    fc1_gelu_q8_plain,
    fc2_residual_q8_plain,
)
from vit_tpu_torch.ops.kernels.ln_qkv_attn import kmean_plain, packed_attention_plain
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual_q8 import out_proj_residual_plain
from vit_tpu_torch.ops.quant import int8_matmul_reference, quantize_activations

# relative to the largest |value| of the twin's result (at least 1): fp32 —
# only summation order and FMA contraction differ; bf16 — both round at the
# same points, so they differ where accumulation order flips a rounding
STAGE_RTOL = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -6}
SCALE_RTOL = 2.0 ** -20
FLIP_SHARE = 1e-3
END_RTOL = 2.0 ** -6


def _close(report: dict, name: str, got, want, rtol: float) -> None:
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite or misshapen ({tuple(got.shape)})")
    err = (got - want).abs().max().item()
    tol = rtol * max(1.0, want.abs().max().item())
    report[name] = err
    if not err <= tol:
        raise AssertionError(f"{name}: max|d| {err:.6g} > tol {tol:.6g}")


def _codes(report: dict, name: str, q, s, want_q, want_s, exact: bool = False) -> None:
    """Check (a) for one row quantizer."""
    if q.dtype != torch.int8 or s.dtype != torch.float32 or q.shape != want_q.shape:
        raise AssertionError(f"{name}: codes {q.dtype} {tuple(q.shape)}, scales {s.dtype}")
    step = (q.int() - want_q.int()).abs()
    share = (step != 0).float().mean().item()
    srel = ((s - want_s).abs() / want_s).max().item()
    report[f"{name} flipped"] = share
    report[f"{name} scale rel"] = srel
    if q.int().abs().max().item() > 127:
        raise AssertionError(f"{name}: a code of -128")
    if exact:
        if share != 0 or srel != 0:
            raise AssertionError(f"{name}: codes or scales differ from the quantizer's on the "
                                 f"same fp32 input (share {share:.3g}, scale rel {srel:.3g})")
        return
    if step.max().item() > 1:
        raise AssertionError(f"{name}: a code differs by {step.max().item()} steps")
    if not share <= FLIP_SHARE:
        raise AssertionError(f"{name}: {share:.3g} of the codes differ (bound {FLIP_SHARE:g})")
    if not srel <= SCALE_RTOL:
        raise AssertionError(f"{name}: a row scale differs by {srel:.3g} (bound {SCALE_RTOL:.3g})")


def check_ln_qkv_attn_q8(st: dict, end, x2d, ln_scale, ln_bias, wq, w_scale, bqkv, num_heads,
                         seq_len, eps, log_size=None, return_kmean=False) -> dict:
    """K15's stages ``st`` (``_ln_qkv_attn_q8_stages``) on these operands,
    and ``end``, the whole twin's context — or the stages of
    ``_ln_qkv_q8_stages`` and the twin's packed QKV.  With token merging's
    hooks, the context is the twin's under the same ``log_size`` and the
    k-mean the twin's of the kernel's own packed QKV, bit for bit (an fp32
    sum in a fixed order).  -> {check: deviation}; raises
    ``AssertionError`` where a bound fails."""
    dtype, report = x2d.dtype, {}
    _codes(report, "hq", st["hq"], st["hs"],
           *quantize_activations(_ln(x2d, ln_scale, ln_bias, eps)))
    qkv = int8_matmul_reference(st["hq"], st["hs"], wq, w_scale, bqkv.float()).to(dtype)
    _close(report, "qkv", st["qkv"], qkv, STAGE_RTOL[dtype])
    if "ctx" in st:
        _close(report, "ctx", st["ctx"],
               packed_attention_plain(st["qkv"], num_heads, seq_len, log_size), STAGE_RTOL[dtype])
    if "kmean" in st:
        if not torch.equal(st["kmean"], kmean_plain(st["qkv"], num_heads)):
            raise AssertionError("kmean: differs from the mean key of the kernel's own QKV")
        report["kmean"] = 0.0
    _close(report, "end to end", st.get("ctx", st["qkv"]), end, END_RTOL)
    return report


def check_mlp_q8(st: dict, end, x1, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps,
                 gelu_variant, dtype) -> dict:
    """The W8A8 MLP's stages ``st`` on ``x1`` (K17: the kernel's input; K16:
    its own fp32 x1 scratch), and ``end``, the whole twin's output."""
    report = {}
    _codes(report, "hq", st["hq"], st["hs"],
           *quantize_activations(_ln(x1, ln_scale, ln_bias, eps)))
    mid = fc1_gelu_q8_plain(st["hq"], st["hs"], w1q, w1s, b1, gelu_variant, dtype)
    _close(report, "mid", st["mid"], mid, STAGE_RTOL[torch.float32])
    _codes(report, "mq", st["mq"], st["ms"], *quantize_activations(st["mid"]), exact=True)
    out = fc2_residual_q8_plain(st["mq"], st["ms"], w2q, w2s, b2, x1, dtype)
    _close(report, "out", st["out"], out, STAGE_RTOL[dtype])
    _close(report, "end to end", st["out"], end, END_RTOL)
    return report


def check_out_ln_mlp_residual_q8(st: dict, end, ctx, res, wo, bo, ln_scale, ln_bias, w1q, w1s,
                                 b1, w2q, w2s, b2, eps, gelu_variant="exact") -> dict:
    """K16's stages ``st`` (``_out_ln_mlp_residual_q8_stages``)."""
    report = {}
    _close(report, "x1", st["x1"], out_proj_residual_plain(ctx, res, wo, bo),
           STAGE_RTOL[ctx.dtype])
    report.update(check_mlp_q8(st, end, st["x1"], ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2,
                               eps, gelu_variant, ctx.dtype))
    return report


def check_ln_mlp_residual_q8(st: dict, end, x2d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2,
                             eps, gelu_variant="exact") -> dict:
    """K17's stages ``st`` (``_ln_mlp_residual_q8_stages``)."""
    return check_mlp_q8(st, end, x2d, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2, eps,
                        gelu_variant, x2d.dtype)
