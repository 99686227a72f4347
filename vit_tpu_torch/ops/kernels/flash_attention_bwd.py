"""K14: blockwise flash-attention backward, CUDA
(``csrc/flash_attention_bwd.cu``).

Replaces ``vit_tpu/ops/pallas/flash_attention.py:flash_attention_bwd``
(pallas_calls at :299, the dK/dV kernel ``_flash_bwd_dkv_kernel`` :183,
and :326, the dQ kernel ``_flash_bwd_dq_kernel`` :232).  One wrapper call
launches both kernels and counts once.

What bounds it on the H100: the gradient's five products, 10·B·H·T²·dh
operations of tensor-core work (ViT-B/16 @512 batch 16: 129 GFLOP, 0.13 ms
at 989 TFLOP/s); the two-kernel form computes seven (q_s Kᵀ and dO Vᵀ in
both kernels).  As on the TPU, no accumulator is shared between blocks:
the dK/dV kernel owns a 64-key tile and streams the query tiles, the dQ
kernel owns a 64-query tile and streams the key tiles, each summing in a
fixed order, without atomics, so two runs give the same bits.  In bf16
every product runs on ``mma.sync`` tiles held in registers
(``csrc/mma_bf16.cuh``), fed by a 2-stage 16-byte ``cp.async`` ring: the
dK/dV kernel computes the transposed tiles Sᵀ and dPᵀ so that pᵀ and dSᵀ
leave the accumulators as the A operands of dV and dK, and the dQ kernel
repacks dS as the A operand of dQ; p and dS never pass through shared
memory, nothing of size (T, T) reaches device memory.  fp32 runs the SIMT
tiles of ``csrc/flash.cuh`` (FMA, never TF32).  The base address and
strides of every (batch, head, token, dh) view the kernels read or write
(q, k, v, dO and the gradients) must be multiples of 16 bytes
(``_build.check_aligned``); anything else raises.  delta =
rowsum(dO · O) in fp32 is one torch reduction before the kernels, as it
is an XLA reduce outside the TPU kernels.

Rounding points (the TPU kernel's): q_s = round(q · round(1/sqrt(dh)));
p and dS = p (dP - delta) fp32, each rounded to the dtype before its
product; dQ scaled by 1/sqrt(dh) in fp32 once at the flush; dQ, dK, dV
rounded once to the dtype.
"""

from __future__ import annotations

import math

import torch

from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.flash_attention import scaled_q, view_strides


def flash_delta(out, do) -> torch.Tensor:
    """rowsum(dO · O) in fp32, (B, H, T) contiguous."""
    return (do.float() * out.float()).sum(-1).contiguous()


def flash_attention_bwd_plain(q, k, v, out, lse, do):
    """Plain twin on (B, H, T, dh): dense fp32 with casts at the kernels'
    rounding points.  -> (dq, dk, dv) in q's dtype."""
    dtype, dh = q.dtype, q.shape[-1]
    qs = scaled_q(q)
    p = torch.exp(qs @ k.float().transpose(-1, -2) - lse[..., None])
    dof = do.to(dtype).float()
    dv = p.to(dtype).float().transpose(-1, -2) @ dof
    ds = (p * (dof @ v.float().transpose(-1, -2) - flash_delta(out, do)[..., None])).to(dtype).float()
    dk = ds.transpose(-1, -2) @ qs
    dq = (ds @ k.float()) * (1.0 / math.sqrt(dh))
    return dq.to(dtype), dk.to(dtype), dv.to(dtype)


def flash_attention_bwd(q, k, v, out, lse, do, dq=None, dk=None, dv=None):
    """VJP of :func:`flash_attention_fwd` on (B, H, T, dh) views, from the
    saved out and lse and the upstream gradient ``do`` -> (dq, dk, dv).
    ``dq``/``dk``/``dv``, when given, are the views to write (say of a
    packed (B·T, 3D) gradient), with one set of strides; else new
    contiguous tensors.  CPU tensors take the plain twin; CUDA tensors
    launch the two kernels."""
    grads = (dq, dk, dv)
    if q.device.type == "cpu":
        got = flash_attention_bwd_plain(q, k, v, out, lse, do)
        return tuple(g if o is None else o.copy_(g) for g, o in zip(got, grads))
    name = "flash_attention_bwd"
    if any(g is None for g in grads):
        if any(g is not None for g in grads):
            raise ValueError(f"{name}: give all of dq, dk, dv or none")
        grads = tuple(torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3))
    sq, sk, sv, so, sdo, *sg = view_strides(name, q.shape, q, k, v, out, do, *grads)
    if not sq == sk == sv or not sg[0] == sg[1] == sg[2]:
        raise ValueError(f"{name}: q, k, v (and dq, dk, dv) must share their strides")
    _build.check_aligned(name, q=q, k=k, v=v, do=do, dq=grads[0], dk=grads[1], dv=grads[2])
    b, h, t, dh = q.shape
    if lse.dtype != torch.float32 or lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"{name}: lse must be contiguous float32 on {q.device}")
    _build.check_shape(name, "lse", lse, (b, h, t))
    delta = flash_delta(out, do)
    lib = _build.load_library()
    _build.check(
        lib.vt_flash_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *sq, do.data_ptr(), *sdo,
            lse.data_ptr(), delta.data_ptr(), *(g.data_ptr() for g in grads), *sg[0],
            b, h, t, dh, _build.DTYPE_CODES[q.dtype], q.device.index, _build.stream_of(q),
        ),
        name,
    )
    flash_attention_bwd.launches += 1
    return grads


flash_attention_bwd.launches = 0
