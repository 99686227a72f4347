"""K13: blockwise flash-attention forward with the fp32 logsumexp, CUDA
(``csrc/flash_attention.cu``).

Replaces ``vit_tpu/ops/pallas/flash_attention.py:_flash_forward``
(pallas_call at :115; body ``_flash_kernel`` :37).

What bounds it on the H100: 4·B·H·T²·dh operations of tensor-core work
(ViT-B/16 @512 batch 16: B·H = 192, T = 1,025, dh = 64; 51.6 GFLOP,
0.052 ms at 989 TFLOP/s), against 4·B·T·D elements read and written
(50 MB in bf16, 0.015 ms).  The TPU kernel carries the running max, sum
and output accumulator in VMEM across a sequential grid over key blocks;
here one block owns a 64-query tile of one (image, head) and loops over
64-key tiles itself, so nothing of size (T, T) reaches device memory.  In
bf16 both products run on the tensor cores from registers
(``csrc/mma_bf16.cuh``: ``mma.sync`` tiles fed by 16-byte ``cp.async``
copies through a two-stage ring; the scores, the online softmax and the
output accumulator never leave registers, and p is repacked from the score
accumulators into the A operand of p·v); fp32 runs CUDA-core FMA tiles
(``csrc/flash.cuh``; never TF32).  q, k and v are strided (batch, head,
token, dh) views: the packed (B·T, 3D) QKV is read in place and the
context written straight into (B·T, D), with no head transposes.  Every
bf16 view's base address and strides must be multiples of 16 bytes
(``_build.check_aligned``); anything else raises.

Rounding points (the TPU kernel's): q scaled by round(1/sqrt(dh)) in the
working dtype; scores, max, sum and accumulator fp32; p rounded to v's
dtype before p·v; out = acc · (1/l), rounded once; lse = m + log(l), from
the same l.
"""

from __future__ import annotations

import math

import torch

from vit_tpu_torch.ops.kernels import _build

# head dims the kernels are instantiated for (csrc/flash_attention*.cu)
HEAD_DIMS = (16, 32, 64, 80, 128)
# keys per tile: the kernel's online-softmax step, which the twin mirrors
BLOCK_K = 64


def scaled_q(q: torch.Tensor) -> torch.Tensor:
    """q · round(1/sqrt(dh)) rounded to q's dtype, as fp32 — the kernels'
    q_s (the TPU kernel scales q in its working dtype)."""
    scale = float(torch.tensor(1.0 / math.sqrt(q.shape[-1]), dtype=q.dtype))
    return (q.float() * scale).to(q.dtype).float()


def flash_attention_fwd_plain(q, k, v, return_lse: bool = False):
    """Plain twin on (B, H, T, dh): the kernel's online softmax over 64-key
    tiles, fp32, with casts at its rounding points.  -> (out, lse or None);
    lse (B, H, T) fp32."""
    dtype, t = q.dtype, q.shape[-2]
    qs = scaled_q(q)
    m = torch.full(q.shape[:-1], -math.inf, device=q.device)
    l = torch.zeros(q.shape[:-1], device=q.device)
    acc = torch.zeros(q.shape, device=q.device)
    for k0 in range(0, t, BLOCK_K):
        s = qs @ k[..., k0:k0 + BLOCK_K, :].float().transpose(-1, -2)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + p.to(dtype).float() @ v[..., k0:k0 + BLOCK_K, :].float()
        m = m_new
    out = (acc * (1.0 / l)[..., None]).to(dtype)
    return out, (m + torch.log(l) if return_lse else None)


def view_strides(kernel: str, shape, *views: torch.Tensor):
    """Each view: CUDA, the first one's dtype, ``shape`` (B, H, T, dh) with
    dh a supported head dim, last axis contiguous.  -> each view's
    (batch, head, token) element strides."""
    _build.check_dtype_device(kernel, *views)
    if shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{kernel}: head_dim {shape[-1]} not in {HEAD_DIMS}")
    strides = []
    for t in views:
        _build.check_shape(kernel, "view", t, shape)
        if t.stride(-1) != 1:
            raise ValueError(f"{kernel}: a (batch, head, token, dh) view needs a contiguous "
                             f"last axis, got strides {t.stride()}")
        strides.append(t.stride()[:3])
    return strides


def flash_attention_fwd(q, k, v, out=None, return_lse: bool = False):
    """softmax(q kᵀ / sqrt(dh)) v over (B, H, T, dh) views -> (out, lse or
    None).  ``out``, when given, is the (B, H, T, dh) view to write (say of
    a (B·T, D) context); else a new contiguous tensor.  CPU tensors take the
    plain twin; CUDA tensors launch the kernel."""
    if q.device.type == "cpu":
        o, lse = flash_attention_fwd_plain(q, k, v, return_lse)
        return (o, lse) if out is None else (out.copy_(o), lse)
    name = "flash_attention_fwd"
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    sq, sk, sv, so = view_strides(name, q.shape, q, k, v, out)
    if not sq == sk == sv:
        raise ValueError(f"{name}: q, k and v must share their strides")
    if q.dtype == torch.bfloat16:
        _build.check_aligned(name, q=q, k=k, v=v, out=out)
    b, h, t, dh = q.shape
    lse = torch.empty(b, h, t, dtype=torch.float32, device=q.device) if return_lse else None
    lib = _build.load_library()
    _build.check(
        lib.vt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), *sq, out.data_ptr(), *so,
            None if lse is None else lse.data_ptr(), b, h, t, dh,
            _build.DTYPE_CODES[q.dtype], q.device.index, _build.stream_of(q),
        ),
        name,
    )
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0
