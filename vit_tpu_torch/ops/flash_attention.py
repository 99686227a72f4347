"""Differentiable blockwise flash attention — counterpart of the public
functions of ``vit_tpu.ops.pallas.flash_attention``.

``flash_attention(q, k, v)`` on (..., T, dh) and
``flash_context_from_packed_qkv(qkv, batch, seq_len, num_heads)`` run K13
forward and K14 backward under ``torch.autograd.Function`` (the JAX
module's ``_flash_attention3`` and its ``defvjp``).  The forward saves its
inputs, the output and the fp32 (B, H, T) logsumexp — nothing of size
(T, T); the backward recomputes the probabilities tile by tile.  Both
functions reach the same two kernels through strided (batch, head, token,
dh) views: the packed QKV context is read from and written to its
(B·T, 3D) and (B·T, D) rows in place, and its gradient comes back packed,
so the QKV linear's autograd takes it as it is.

The JAX functions take ``block_q``/``block_k`` (their VMEM tiles) and
``interpret``; the kernels' tiles are fixed at 64 on the card.
"""

from __future__ import annotations

import torch


def packed_views(x: torch.Tensor, batch: int, seq_len: int, num_heads: int, parts: int):
    """(B·T, parts·H·dh) rows in the packed (head, part, dh) column order ->
    ``parts`` (B, H, T, dh) views (q, k, v for the QKV; one for a
    context)."""
    dh = x.shape[-1] // (parts * num_heads)
    x5 = x.view(batch, seq_len, num_heads, parts, dh)
    return [x5[:, :, :, i].permute(0, 2, 1, 3) for i in range(parts)]


class FlashAttentionFn(torch.autograd.Function):
    """(q, k, v) (B, H, T, dh) -> softmax(q kᵀ / sqrt(dh)) v: K13 forward,
    K14 backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        from vit_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd

        out, lse = flash_attention_fwd(q, k, v, return_lse=any(ctx.needs_input_grad))
        if lse is not None:
            ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, g):
        from vit_tpu_torch.ops.kernels.flash_attention_bwd import flash_attention_bwd

        q, k, v, out, lse = ctx.saved_tensors
        return flash_attention_bwd(q, k, v, out, lse, g.contiguous())


class FlashContextFn(torch.autograd.Function):
    """(qkv (B·T, 3D) packed, batch, seq_len, num_heads) -> context
    (B·T, D): K13 forward, K14 backward into a packed (B·T, 3D) dqkv."""

    @staticmethod
    def forward(ctx, qkv, batch, seq_len, num_heads):
        from vit_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd

        rows, d3 = qkv.shape
        out = torch.empty(rows, d3 // 3, dtype=qkv.dtype, device=qkv.device)
        (o,) = packed_views(out, batch, seq_len, num_heads, 1)
        _, lse = flash_attention_fwd(*packed_views(qkv, batch, seq_len, num_heads, 3), out=o,
                                     return_lse=ctx.needs_input_grad[0])
        if lse is not None:
            ctx.save_for_backward(qkv, out, lse)
            ctx.shape = (batch, seq_len, num_heads)
        return out

    @staticmethod
    def backward(ctx, g):
        from vit_tpu_torch.ops.kernels.flash_attention_bwd import flash_attention_bwd

        qkv, out, lse = ctx.saved_tensors
        dqkv = torch.empty_like(qkv)
        (o,) = packed_views(out, *ctx.shape, 1)
        (do,) = packed_views(g.contiguous(), *ctx.shape, 1)
        flash_attention_bwd(*packed_views(qkv, *ctx.shape, 3), o, lse, do,
                            *packed_views(dqkv, *ctx.shape, 3))
        return dqkv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(Q Kᵀ / sqrt(dh)) V for (..., T, dh), differentiable, never
    materializing (T, T)."""
    *lead, t, dh = q.shape
    q4, k4, v4 = (a.reshape(-1, 1, t, dh).contiguous() for a in (q, k, v))
    return FlashAttentionFn.apply(q4, k4, v4).reshape(*lead, t, dh)


def flash_context_from_packed_qkv(
    qkv: torch.Tensor, batch: int, seq_len: int, num_heads: int
) -> torch.Tensor:
    """Packed QKV projection -> flash-attention context, flat rows out.

    ``qkv`` is the QKV GEMM output in the packed (head, {q,k,v}, head_dim)
    column order, any leading shape whose last axis is 3·num_heads·dh.
    Returns (batch·seq_len, num_heads·dh).  Differentiable (K14)."""
    qkv2 = qkv.reshape(batch * seq_len, qkv.shape[-1]).contiguous()
    return FlashContextFn.apply(qkv2, batch, seq_len, num_heads)
