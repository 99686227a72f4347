"""K1: LN1 -> packed QKV projection -> per-head attention, CUDA
(``csrc/ln_qkv_attn.cu``).

Replaces ``vit_tpu/ops/pallas/fused_block.py:ln_qkv_attn`` (pallas_call at
:291; body ``_ln_qkv_attn_kernel`` :193 and ``_head_context`` :165).

What bounds it on the H100: the QKV GEMM (B/16 batch 100: 19,700 x 768 x
2,304, 70 GFLOP) is tensor-core work; attention (T = 197, dh = 64) is a
further 12 GFLOP in many small per-head tiles.  The TPU kernel keeps
W_qkv (3.4 MB bf16) and one image's packed QKV resident in 96 MB of VMEM;
a Hopper block has 227 KB of shared memory, so the design streams tiles
instead, in two stages:

  1. per-row LN1 statistics (fp32 mean, rstd), then a tiled GEMM whose
     A-tile load applies LN1 and rounds to the working dtype, writing the
     packed QKV (+ bias, rounded) to a device scratch (B*T, 3D) — 90.8 MB
     per layer at batch 100 bf16 that the TPU never wrote (the first
     fusion target for later work);
  2. one block per (image, head, 64-query tile) that reads q/k/v straight
     out of the packed (head, {q,k,v}, dh) columns with strides (no
     (B, H, T, dh) reshuffle), streams 64-key tiles twice — once for the
     row max and sum of exp, once for p = exp(s - m) / sum rounded to the
     dtype and p @ v — so any T fits in shared memory and the rounding
     points are the TPU kernel's: q * (1/sqrt(dh)) in the dtype, fp32
     scores, max-subtracted softmax normalised by a reciprocal multiply,
     p rounded before p @ v, fp32 accumulation, output rounded.

bf16 GEMMs run on the tensor cores (WMMA, fp32 accumulators); fp32 runs
plain fp32 FMA, never TF32.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _ln
from vit_tpu_torch.ops.kernels import _build

# head dims the attention stage is instantiated for (csrc/ln_qkv_attn.cu)
HEAD_DIMS = (16, 32, 64, 128)


def ln_qkv_attn_plain(
    x2d: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    num_heads: int,
    seq_len: int,
    eps: float,
) -> torch.Tensor:
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points."""
    dtype = x2d.dtype
    rows, _ = x2d.shape
    d3 = wqkv.shape[-1]
    dh = d3 // (3 * num_heads)
    b = rows // seq_len
    h = _ln(x2d, ln_scale, ln_bias, eps).to(dtype)
    qkv = (h.float() @ wqkv.float() + bqkv.float()).to(dtype)
    qkv = qkv.reshape(b, seq_len, num_heads, 3, dh).permute(3, 0, 2, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]  # (B, H, T, dh)
    scale = torch.tensor(1.0 / dh ** 0.5, dtype=dtype)
    q = (q.float() * scale.float()).to(dtype)
    s = q.float() @ k.float().transpose(-1, -2)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    inv = 1.0 / p.sum(dim=-1, keepdim=True)
    p = (p * inv).to(dtype)
    ctx = (p.float() @ v.float()).to(dtype)  # (B, H, T, dh)
    return ctx.permute(0, 2, 1, 3).reshape(rows, num_heads * dh)


def ln_qkv_attn(
    x2d: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    num_heads: int,
    seq_len: int,
    eps: float,
) -> torch.Tensor:
    """(B*T, D) -> attention context (B*T, D).  CPU tensors take the plain
    twin; CUDA tensors launch the kernel."""
    if x2d.device.type == "cpu":
        return ln_qkv_attn_plain(
            x2d, ln_scale, ln_bias, wqkv, bqkv, num_heads, seq_len, eps
        )
    name = "ln_qkv_attn"
    _build.check_operands(name, x2d, ln_scale, ln_bias, wqkv, bqkv)
    rows, d = x2d.shape
    d3 = wqkv.shape[-1]
    if d3 % (3 * num_heads) or rows % seq_len:
        raise ValueError(
            f"{name}: W_qkv width {d3} is not 3 x {num_heads} heads, or "
            f"{rows} rows are not whole sequences of {seq_len}"
        )
    dh = d3 // (3 * num_heads)
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    _build.check_shape(name, "ln_scale", ln_scale, (d,))
    _build.check_shape(name, "ln_bias", ln_bias, (d,))
    _build.check_shape(name, "wqkv", wqkv, (d, d3))
    _build.check_shape(name, "bqkv", bqkv, (d3,))
    stats = torch.empty(2 * rows, dtype=torch.float32, device=x2d.device)
    qkv = torch.empty(rows, d3, dtype=x2d.dtype, device=x2d.device)
    ctx = torch.empty(rows, d3 // 3, dtype=x2d.dtype, device=x2d.device)
    lib = _build.load_library()
    _build.check(
        lib.vt_ln_qkv_attn(
            x2d.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), stats.data_ptr(),
            qkv.data_ptr(), ctx.data_ptr(), rows // seq_len, seq_len, d,
            num_heads, dh, eps, _build.DTYPE_CODES[x2d.dtype],
            x2d.device.index, _build.stream_of(x2d),
        ),
        name,
    )
    ln_qkv_attn.launches += 1
    return ctx


ln_qkv_attn.launches = 0
