"""Quantization-aware training (QAT): fake-int8 forward, straight-through
backward — counterpart of ``vit_tpu.ops.qat``.

The forward applies quantize -> dequantize ("fake quant") at the tensors
the W8A8 kernels quantize: the QKV GEMM's activations and weights and both
MLP GEMMs' activations and weights (out_proj, the attention core, the patch
embedding and the head stay in floating point, as ``ops/quant.py``'s
``quantize_params`` leaves them).  The QAT loss is then the deployed int8
math up to fp32 summation order.  The backward is the straight-through
estimator: ``round`` passes its gradient unchanged (:class:`SteRound`), the
clip to [-127, 127] zeroes it outside the representable range, and the
dynamic scales are detached.

Plain PyTorch: the JAX package's table reaches no Pallas kernel, so no CUDA
kernel stands behind this one.  The arithmetic follows the JAX package's
step for step, so that codes and gradients agree on the same input:

  - every divide is tensor by tensor (torch may turn a division by a Python
    scalar into a multiplication by its reciprocal, which loses a bit);
  - ``torch.round`` rounds half to even, as ``jnp.round`` does;
  - the clip is ``minimum(maximum(q, -127), 127)``, which, like
    ``jnp.clip``, splits the gradient evenly where q sits exactly on a
    bound (the row's absmax element always does): ``torch.clamp`` would
    pass all of it.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import OpsImpl


class SteRound(torch.autograd.Function):
    """round() whose gradient is the identity (straight-through estimator)."""

    @staticmethod
    def forward(ctx, x):
        return torch.round(x)

    @staticmethod
    def backward(ctx, g):
        return g


def ste_round(x: torch.Tensor) -> torch.Tensor:
    return SteRound.apply(x)


def _fake_quant(xf: torch.Tensor, absmax: torch.Tensor) -> torch.Tensor:
    """fp32 ``xf`` and its detached (broadcastable) absmax -> the dequantized
    int8 codes ``clip(round(xf / scale), -127, 127) * scale``."""
    scale = torch.maximum(absmax / torch.full_like(absmax, 127.0),
                          torch.full_like(absmax, 1e-12))
    bound = torch.full_like(absmax, 127.0)
    q = torch.minimum(torch.maximum(ste_round(xf / scale), -bound), bound)
    return q * scale


def fake_quant_act(x: torch.Tensor) -> torch.Tensor:
    """Dynamic symmetric per-row int8 quantize -> dequantize
    (``ops/quant.quantize_activations``' codes and scales), STE backward."""
    xf = x.float()
    absmax = xf.detach().abs().amax(dim=-1, keepdim=True)
    return _fake_quant(xf, absmax).to(x.dtype)


def fake_quant_weight(w: torch.Tensor) -> torch.Tensor:
    """Symmetric per-output-channel (last axis) int8 quantize -> dequantize
    of an [in, out] weight (``ops/quant.quantize_weight``), STE backward."""
    wf = w.float()
    absmax = wf.detach().abs().amax(dim=tuple(range(wf.dim() - 1)), keepdim=True)
    return _fake_quant(wf, absmax).to(w.dtype)


def attention_qat(x, wqkv, bqkv, wo, bo, num_heads):
    """``reference.attention`` with the QKV GEMM fake-quantized (the int8
    path's quantization point; out_proj and the attention core stay fp)."""
    return reference.attention(
        fake_quant_act(x), fake_quant_weight(wqkv), bqkv, wo, bo, num_heads
    )


def mlp_qat(x, w1, b1, w2, b2, gelu_variant: str = "exact", inner_dropout=None):
    """``reference.mlp`` with both GEMMs fake-quantized (input and post-GELU
    activations per row, w1/w2 per channel).  ``inner_dropout``: optional
    ``(generator, rate)`` between GELU and FC2, as ``reference.mlp`` takes
    it — applied before FC2's activation fake-quant, so the quantizer sees
    the activations it sees at that point in training."""
    h = reference.linear(fake_quant_act(x), fake_quant_weight(w1), b1)
    h = reference.gelu_exact(h) if gelu_variant == "exact" else reference.gelu_tanh(h)
    if inner_dropout is not None:
        gen, rate = inner_dropout
        h = reference.dropout(h, rate, gen)
    return reference.linear(fake_quant_act(h), fake_quant_weight(w2), b2)


QAT_OPS = OpsImpl(
    name="qat",
    layer_norm=reference.layer_norm,
    patch_embed=reference.patch_embed,
    attention=attention_qat,
    mlp=mlp_qat,
)
