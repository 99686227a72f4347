"""K21: softmax(q·kᵀ / sqrt(dh))·v over (..., H, T, dh), CUDA
(``csrc/scaled_dot_product_attention.cu``), and the per-op tier's
``attention`` around it.

Replaces ``vit_tpu/ops/pallas/attention_kernel.py:scaled_dot_product_attention``
(pallas_call at :88; body ``_attn_kernel`` :31) and holds the counterpart
of its ``attention`` (:107): the QKV linear, the kernel on strided views of
the packed (head, {q,k,v}, dh) columns, and the out linear.  The two
linears stay ``reference.linear`` (torch.matmul), as the JAX package leaves
them to XLA outside Pallas.

What bounds it on the H100: device memory at ViT shapes (B/16 @224 batch
100: q, k, v and the output are 121 MB in bf16 against 11.9 GFLOP).  The
TPU kernel holds one (batch, head)'s (T, T) scores in VMEM; the CUDA kernel
reads q, k and v through their (batch, head, token) strides — the packed
QKV in place — and writes the context through the output's, so no head
transpose is copied.  One block per (image, head, 64-query tile), 64-key
tiles streamed twice (row max and sum, then p·v).  In bf16 both products
run on the tensor cores (``csrc/mma_bf16.cuh``: ``mma.sync`` tiles held in
registers, fed by 16-byte ``cp.async`` copies, p repacked from the score
accumulators into the A operand of p·v); fp32 runs K1's SIMT attention
stage (``csrc/attention.cuh``; FMA, never TF32).  Rounding points as the
TPU kernel's: q·(1/sqrt(dh)) in the dtype, fp32 scores and the exact row
max, reciprocal-multiply normalisation, p rounded to v's dtype before p·v,
fp32 accumulation, output rounded.  Every operand's base address and
strides must be multiples of 16 bytes (``_build.check_aligned``); anything
else raises.

Past ``fused_block.VMEM_ATTENTION_MAX_T`` tokens (read at call time) it
routes to K13 (``flash_attention_fwd``), as the JAX function routes to its
flash kernel.
"""

from __future__ import annotations

import math

import torch

from vit_tpu_torch.ops import fused_block, reference
from vit_tpu_torch.ops.kernels import _build

# head dims the attention body is instantiated for (csrc/attention.cuh: K1, K15, K21)
HEAD_DIMS = (16, 32, 64, 80, 128)


def scaled_dot_product_attention_plain(q, k, v, logit_bias=None) -> torch.Tensor:
    """Plain twin on (..., H, T, dh): fp32 compute with casts at the TPU
    kernel's rounding points.  ``logit_bias`` (..., T) fp32 is added to
    every query row's key logits before the row max (K1's token-merging
    hook; K21 takes none)."""
    dtype = q.dtype
    scale = torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=dtype)
    qs = (q.float() * scale.float()).to(dtype)
    s = qs.float() @ k.float().transpose(-1, -2)
    if logit_bias is not None:
        s = s + logit_bias.float()[..., None, None, :]
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    inv = 1.0 / p.sum(dim=-1, keepdim=True)
    p = (p * inv).to(v.dtype)
    return (p.float() @ v.float()).to(dtype)


def _flat_views(*views):
    """(..., H, T, dh) inputs -> (B, H, T, dh), B the product of the leading
    axes: views over the same memory, or copies where no view exists."""
    return [t if t.dim() == 4 else t.reshape(-1, *t.shape[-3:]) for t in views]


def scaled_dot_product_attention(q, k, v, out=None) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(dh)) v for (..., H, T, dh) inputs -> (..., H, T,
    dh).  ``out``, when given, is the (..., H, T, dh) view to write (say of a
    (B·T, D) context); else a new contiguous tensor.  CPU tensors take the
    plain twin; CUDA tensors launch the kernel (K13 past the switch)."""
    t = q.shape[-2]
    if t > fused_block.VMEM_ATTENTION_MAX_T:
        from vit_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd

        q4, k4, v4 = _flat_views(q, k, v)
        o4 = None if out is None else out.view(q4.shape)
        o4, _ = flash_attention_fwd(q4, k4, v4, out=o4)
        return o4.view(q.shape) if out is None else out
    if q.device.type == "cpu":
        ctx = scaled_dot_product_attention_plain(q, k, v)
        return ctx if out is None else out.copy_(ctx)
    name = "scaled_dot_product_attention"
    _build.check_dtype_device(name, q, k, v)
    for n, x in (("k", k), ("v", v)):
        _build.check_shape(name, n, x, q.shape)
    dh = q.shape[-1]
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _build.check_dtype_device(name, q, out)
    _build.check_shape(name, "out", out, q.shape)
    q4, k4, v4 = _flat_views(q, k, v)
    o4 = out.view(q4.shape)  # raises unless out's leading axes flatten in place
    strides = []
    for x in (q4, k4, v4, o4):
        if x.stride(-1) != 1:
            raise ValueError(f"{name}: a (..., H, T, dh) operand needs a contiguous last axis, "
                             f"got strides {x.stride()}")
        strides.append(x.stride()[:3])
    _build.check_aligned(name, q=q4, k=k4, v=v4, out=o4)
    b, h, _, _ = q4.shape
    lib = _build.load_library()
    _build.check(
        lib.vt_scaled_dot_product_attention(
            q4.data_ptr(), *strides[0], k4.data_ptr(), *strides[1], v4.data_ptr(), *strides[2],
            o4.data_ptr(), *strides[3], b, h, t, dh, _build.DTYPE_CODES[q.dtype],
            q.device.index, _build.stream_of(q),
        ),
        name,
    )
    scaled_dot_product_attention.launches += 1
    return out


scaled_dot_product_attention.launches = 0


def attention(x, wqkv, bqkv, wo, bo, num_heads: int) -> torch.Tensor:
    """Drop-in for ``reference.attention`` with K21 as the core: the packed
    QKV linear, K21 on strided views of its (head, {q,k,v}, dh) columns
    writing the context in place in (..., T, D) order, and the out
    linear."""
    from vit_tpu_torch.ops.flash_attention import packed_views

    *lead, t, d = x.shape
    qkv = reference.linear(x, wqkv, bqkv).reshape(-1, wqkv.shape[-1])  # (B·T, 3D)
    b = qkv.shape[0] // t
    q, k, v = packed_views(qkv, b, t, num_heads, 3)
    ctx = torch.empty(b * t, wo.shape[0], dtype=qkv.dtype, device=qkv.device)
    scaled_dot_product_attention(q, k, v, out=packed_views(ctx, b, t, num_heads, 1)[0])
    return reference.linear(ctx.reshape(*lead, t, -1), wo, bo)
