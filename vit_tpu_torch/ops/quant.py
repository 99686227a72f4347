"""Quantization utilities: int8 weights/activations with fp32 scales —
counterpart of ``vit_tpu.ops.quant``, on torch tensors.

Scheme (W8A8):

  - Weights: static symmetric per-output-channel int8,
    ``w_q[k, n] = round(w[k, n] / s_w[n])``.
  - Activations: dynamic symmetric per-row (per-token) int8, computed on
    the fly from the row absmax.
  - GEMM: exact int32 accumulation, dequantized with the rank-1 scale outer
    product ``s_x[m] * s_w[n]``.

The kernels live in ``ops/kernels/*_q8.py`` (K15-K17); this module holds the
plain reference implementations they are tested against, and the params
quantizer.  Given the same fp32 input every function here returns the JAX
package's int8 codes and fp32 scales bit for bit: an fp32 divide, a
round-half-to-even and a clip are the same operations in both.  Every
divide here is tensor by tensor: torch may turn a division by a Python
scalar into a multiplication by its reciprocal, which loses a bit.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch


class QuantizedLinear(NamedTuple):
    """int8 weight [in, out] + fp32 per-output-channel scale [out]."""

    w_q: Any  # int8 (K, N)
    scale: Any  # fp32 (N,)


def _symmetric_int8(x: torch.Tensor, absmax: torch.Tensor):
    """fp32 ``x`` and its (broadcastable) absmax -> (int8 codes, fp32 scale
    = max(absmax / 127, 1e-12))."""
    scale = torch.clamp(absmax / torch.full_like(absmax, 127.0), min=1e-12)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), scale


def quantize_weight(w: torch.Tensor) -> QuantizedLinear:
    """Symmetric per-channel int8 quantization of a [K, N] (or stacked
    [L, K, N]) weight; channels = the last axis."""
    w = w.float()
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)), keepdim=True)
    w_q, scale = _symmetric_int8(w, absmax)
    return QuantizedLinear(w_q, scale.reshape(w.shape[-1]))


def quantize_weight_stacked(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[L, K, N] stacked weights -> (int8 [L, K, N], fp32 scales [L, N])."""
    w = w.float()
    w_q, scale = _symmetric_int8(w, w.abs().amax(dim=1, keepdim=True))  # (L, 1, N)
    return w_q, scale[:, 0, :]


def quantize_activations(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic symmetric per-row int8: (..., K) -> int8 values + fp32 row
    scales (...,)."""
    xf = x.float()
    x_q, scale = _symmetric_int8(xf, xf.abs().amax(dim=-1, keepdim=True))
    return x_q, scale[..., 0]


def int8_dot(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """The exact integer product of two int8 matrices, (..., K) @ (K, N).
    Sums reach 127^2 x 3,072, past fp32's 2^24: on the CPU the product runs
    in int32; elsewhere (no integer matmul there) in float64, exact below
    2^53."""
    if x_q.device.type == "cpu":
        return x_q.int() @ w_q.int()
    return x_q.double() @ w_q.double()


def int8_matmul_reference(x_q, s_x, w_q, s_w, bias=None) -> torch.Tensor:
    """Reference W8A8 GEMM: dequantized int32 accumulation, fp32 out."""
    out = int8_dot(x_q, w_q).float() * s_x[..., None] * s_w[None, :]
    if bias is not None:
        out = out + bias
    return out


def linear_w8a8(x, w_q, s_w, bias=None) -> torch.Tensor:
    """Drop-in fp-in/fp-out linear over an int8 weight (dynamic act quant)."""
    x_q, s_x = quantize_activations(x)
    return int8_matmul_reference(x_q, s_x, w_q, s_w, bias)


def quantize_params(params: Dict[str, Any]) -> Dict[str, Any]:
    """Quantize the big GEMM weights of a ViT params dict to int8.

    Returns a new dict where the blocks' wqkv/w1/w2 are replaced by
    ``{name: int8, name_scale: fp32}`` pairs; wo (it rides the out_proj
    stage in the working dtype), LN, bias and embedding tensors stay fp.
    Consumed by the 'quant' ops path."""
    out_blocks = dict(params["blocks"])
    for name in ("wqkv", "w1", "w2"):
        w_q, s = quantize_weight_stacked(params["blocks"][name])
        out_blocks[name] = w_q
        out_blocks[name + "_scale"] = s
    out = dict(params)
    out["blocks"] = out_blocks
    return out


_QUANT_SCALE_KEYS = frozenset({"wqkv_scale", "w1_scale", "w2_scale"})


def cast_quantized_params(params: Dict[str, Any], dtype: torch.dtype) -> Dict[str, Any]:
    """Cast fp leaves to the compute dtype, leaving int8 weights and their
    fp32 quantization scales untouched.  (LayerNorm's ln*_scale params are
    NOT quant scales and do get cast.)"""

    def rec(node, name=""):
        if isinstance(node, dict):
            return {k: rec(v, k) for k, v in node.items()}
        if node.dtype == torch.int8 or name in _QUANT_SCALE_KEYS:
            return node
        return node.to(dtype)

    return rec(params)
