"""Plain PyTorch reference ops — the port's ``eager`` tier.

Counterpart of ``vit_tpu.ops.reference`` (the ``xla`` tier): slow,
obviously-correct tensor code every kernel path is checked against, with
the same numerical conventions:

  - LayerNorm: fp32 statistics, centred variance, eps = 1e-6 *inside* the
    rsqrt.
  - GELU: exact erf form, plus the tanh-approximation twin.
  - Linear: y = x @ W + b with W stored [in, out] (pre-transposed from
    torchvision's [out, in] at load time — never ``nn.Linear``'s layout);
    products accumulate in fp32, the bias is added in fp32, then the result
    is cast back to the input dtype.
  - Attention: packed QKV with (head, {q,k,v}, head_dim) column order,
    max-subtracted fp32 softmax.

Activations are (..., T, D).  Accumulation runs in fp32 for bf16 and fp32
inputs and in fp64 for fp64 inputs (``_acc``), so the same functions serve
as a float64 oracle on the CPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _acc(x: torch.Tensor) -> torch.Tensor:
    """``x`` in its accumulation dtype: fp32 for bf16/fp32, fp64 for fp64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Per-token LayerNorm over the last axis, fp32 statistics."""
    xf = _acc(x)
    mean = xf.mean(dim=-1, keepdim=True)
    centered = xf - mean
    var = (centered * centered).mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    out = centered * inv * scale.to(xf.dtype) + bias.to(xf.dtype)
    return out.to(x.dtype)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """Exact-erf GELU ``0.5*x*(1+erf(x/sqrt(2)))``."""
    xf = _acc(x)
    out = 0.5 * xf * (1.0 + torch.erf(xf / math.sqrt(2.0)))
    return out.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """Tanh-approximation GELU."""
    xf = _acc(x)
    inner = 0.7978845608028654 * (xf + 0.044715 * xf * xf * xf)
    out = 0.5 * xf * (1.0 + torch.tanh(inner))
    return out.to(x.dtype)


def linear(
    x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """y = x @ W (+ b); W is [in, out].  Accumulates in fp32."""
    xf = _acc(x)
    y = torch.matmul(xf, w.to(xf.dtype))
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)


def split_packed_qkv(qkv: torch.Tensor, num_heads: int):
    """(..., T, 3D) with (head, {q,k,v}, head_dim) columns -> per-head
    (..., H, T, Dh) q, k, v."""
    *lead, t, d3 = qkv.shape
    head_dim = d3 // (3 * num_heads)
    qkv = qkv.reshape(*lead, t, num_heads, 3, head_dim)
    q = qkv[..., 0, :].movedim(-2, -3)
    k = qkv[..., 1, :].movedim(-2, -3)
    v = qkv[..., 2, :].movedim(-2, -3)
    return q, k, v


def merge_heads(ctx: torch.Tensor) -> torch.Tensor:
    """(..., H, T, Dh) -> (..., T, H*Dh): inverse of the head split."""
    *lead, h, t, dh = ctx.shape
    return ctx.movedim(-3, -2).reshape(*lead, t, h * dh)


def attention(
    x: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    wo: torch.Tensor,
    bo: torch.Tensor,
    num_heads: int,
    *,
    logit_bias: Optional[torch.Tensor] = None,
    return_kmean: bool = False,
    return_probs: bool = False,
):
    """Multi-head self-attention, inference form.

    ``wqkv`` (D, 3D) packed in (head, {q,k,v}, head_dim) column order,
    ``wo`` (D, D) pre-transposed.  Scores and softmax in fp32; the
    probabilities round to the working dtype before ``p @ v``.

    ``logit_bias`` (..., T) fp32, when given, adds a per-key bias to the
    scaled logits (token merging's proportional attention: softmax(q kᵀ /
    sqrt(dh) + log s), ``ops/tome.py``).  ``return_kmean`` also returns the
    mean attention key over heads (..., T, head_dim), token merging's
    similarity metric.  ``return_probs`` also returns the softmax rows
    (..., H, T, T) in the accumulation dtype, from before their rounding to
    the working dtype (the attention probe, ``models/vit.attention_maps``)."""
    ctx, k, probs = attention_context(x, wqkv, bqkv, num_heads, logit_bias)
    out = linear(ctx, wo, bo)
    if return_probs:
        return out, probs
    if return_kmean:
        return out, _acc(k).mean(dim=-3).to(x.dtype)  # heads axis of (..., H, T, Dh)
    return out


def attention_context(x: torch.Tensor, wqkv: torch.Tensor, bqkv: torch.Tensor, num_heads: int,
                      logit_bias: Optional[torch.Tensor] = None):
    """:func:`attention` up to the out_proj: -> (the merged per-head context
    (..., T, H*Dh) in x's dtype, the keys (..., H, T, Dh), the softmax rows
    (..., H, T, T) in the accumulation dtype).  ``wqkv`` may hold any whole
    heads (a tensor-parallel rank's, ``parallel/tp_forward.py``)."""
    qkv = linear(x, wqkv, bqkv)
    q, k, v = split_packed_qkv(qkv, num_heads)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("...hqd,...hkd->...hqk", _acc(q), _acc(k)) * scale
    if logit_bias is not None:
        scores = scores + logit_bias[..., None, None, :].to(scores.dtype)
    probs = torch.softmax(scores, dim=-1)
    ctx = torch.einsum("...hqk,...hkd->...hqd", _acc(probs.to(x.dtype)), _acc(v))
    return merge_heads(ctx.to(x.dtype)), k, probs


def dropout(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Inverted dropout (train time; eval applies nothing): keep each
    element with probability 1 - rate, drawn from ``gen`` (a generator on
    x's device), and scale the kept ones by 1/(1 - rate)."""
    keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
    xf = _acc(x)
    return torch.where(keep, xf / (1.0 - rate), torch.zeros((), dtype=xf.dtype,
                                                            device=x.device)).to(x.dtype)


def mlp(
    x: torch.Tensor,
    w1: torch.Tensor,
    b1: torch.Tensor,
    w2: torch.Tensor,
    b2: torch.Tensor,
    gelu_variant: str = "exact",
    inner_dropout=None,
) -> torch.Tensor:
    """Linear(D->F) -> GELU -> Linear(F->D).  ``inner_dropout``, a
    ``(generator, rate)`` pair, applies torchvision MLPBlock's dropout
    between the GELU and the second linear."""
    h = linear(x, w1, b1)
    h = gelu_exact(h) if gelu_variant == "exact" else gelu_tanh(h)
    if inner_dropout is not None:
        gen, rate = inner_dropout
        h = dropout(h, rate, gen)
    return linear(h, w2, b2)


def patch_embed(
    images: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, patch_size: int
) -> torch.Tensor:
    """Patch embedding as reshape + GEMM.

    images (..., C, H, W) NCHW; kernel (C*p*p, D) flattened channel-major
    over (C, kh, kw).  Returns (..., num_patches, D), row-major over the
    patch grid."""
    *lead, c, h, w = images.shape
    p = patch_size
    gh, gw = h // p, w // p
    x = images.reshape(*lead, c, gh, p, gw, p)
    # -> (..., gh, gw, c, ph, pw): patch-major rows, channel-major in a patch
    x = x.movedim((-5, -4, -3, -2, -1), (-3, -5, -2, -4, -1))
    x = x.reshape(*lead, gh * gw, c * p * p)
    return linear(x, kernel, bias)


def add_cls_and_pos(
    patches: torch.Tensor, cls_token: torch.Tensor, pos_embed: torch.Tensor
) -> torch.Tensor:
    """Prepend the prefix token(s) — (D,) CLS or a (P, D) stack — and add
    the position embeddings."""
    *lead, n, d = patches.shape
    p = 1 if cls_token.dim() == 1 else cls_token.shape[0]
    cls = cls_token.to(patches.dtype).reshape(p, d).expand(*lead, p, d)
    x = torch.cat([cls, patches], dim=-2)
    return x + pos_embed.to(patches.dtype)


def softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Max-subtracted softmax over class logits, in fp32."""
    return torch.softmax(logits.float(), dim=dim)
