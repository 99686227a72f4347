"""K1: LN1 -> packed QKV projection -> per-head attention, CUDA
(``csrc/ln_qkv_attn.cu``).

Replaces ``vit_tpu/ops/pallas/fused_block.py:ln_qkv_attn`` (pallas_call at
:291; body ``_ln_qkv_attn_kernel`` :193 and ``_head_context`` :165).

What bounds it on the H100: operations.  The QKV GEMM (B/16 batch 100:
19,700 x 768 x 2,304, 70 GFLOP) is tensor-core work; attention (T = 197,
dh = 64) is a further 12 GFLOP in many small per-head tiles.  The TPU
kernel keeps W_qkv (3.4 MB bf16) and one image's packed QKV resident in
96 MB of VMEM; a Hopper block has 227 KB of shared memory, so the design
streams tiles through device-memory scratches instead.  bf16, the main
path, in three stages:

  1. LN1 once per row (fp32 statistics and affine) into a bf16 scratch h
     (B*T, D), the value the TPU kernel rounds to the dtype;
  2. the packed QKV GEMM on the pipelined ``cp.async`` + ``wgmma`` core
     (``csrc/gemm_mma.cuh``), + bias, rounded, into a (B*T, 3D) scratch —
     90.8 MB per layer at batch 100 that the TPU never wrote;
  3. attention on K21's register tiles (``csrc/sdpa_mma.cuh``): one block
     per (image, head, 64-query tile) that reads q/k/v straight out of the
     packed (head, {q,k,v}, dh) columns as strided views, streams 64-key
     tiles twice — once for the row max and sum of exp, once for p =
     exp(s - m) / sum rounded to the dtype and p @ v — so any T fits and
     the rounding points are the TPU kernel's: q * (1/sqrt(dh)) in the
     dtype, fp32 scores, max-subtracted softmax normalised by a reciprocal
     multiply, p rounded before p @ v, fp32 accumulation, output rounded.

Every operand the GEMM core copies 16 bytes at a time is checked: W_qkv on
the 16-byte grid, D and 3D multiples of 8 elements (``check_tile_operands``).
fp32 keeps the first design: LN1 row statistics, a tiled fp32 FMA GEMM
(never TF32) with LN1 applied in the A-tile load, and a SIMT attention
with the same rounding points.

Token merging's two hooks (``models/tome.py``): ``log_size`` (B, T) fp32
is added to every query row's key logits after the scaled q·kᵀ and before
the row max (proportional attention); ``return_kmean`` also returns the
mean key over heads (B*T, dh) — the fp32 sum in head order times 1/H,
rounded to the dtype — read by a third small kernel from the packed-QKV
scratch the attention stage reads (the TPU kernel reads it from VMEM).
Without either, the launches are exactly those of the hook-less kernel.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _ln
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.attention import HEAD_DIMS, scaled_dot_product_attention_plain


def packed_attention_plain(qkv: torch.Tensor, num_heads: int, seq_len: int,
                           log_size=None) -> torch.Tensor:
    """The attention stage's plain twin: packed QKV (B*T, 3D) in the working
    dtype -> context (B*T, D), fp32 compute with casts at the TPU kernel's
    rounding points (``_head_context``); ``log_size`` (B, T) fp32 is added to
    the key logits before the row max."""
    rows, d3 = qkv.shape
    dh = d3 // (3 * num_heads)
    b = rows // seq_len
    qkv = qkv.reshape(b, seq_len, num_heads, 3, dh).permute(3, 0, 2, 1, 4)
    # (B, H, T, dh) each; K21's twin, the same rounding points
    ctx = scaled_dot_product_attention_plain(qkv[0], qkv[1], qkv[2], log_size)
    return ctx.permute(0, 2, 1, 3).reshape(rows, num_heads * dh)


def kmean_plain(qkv: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The k-mean stage's plain twin: packed QKV (B*T, 3D) -> the mean key
    over heads (B*T, dh), an fp32 sum in head order times 1/H, rounded to
    the dtype."""
    rows, d3 = qkv.shape
    k = qkv.reshape(rows, num_heads, 3, d3 // (3 * num_heads))[:, :, 1].float()
    acc = k[:, 0]
    for h in range(1, num_heads):
        acc = acc + k[:, h]
    return (acc * (1.0 / num_heads)).to(qkv.dtype)


def _check_log_size(name: str, log_size, x2d: torch.Tensor, seq_len: int) -> None:
    """log_size: (B, T) float32, contiguous, on x's device."""
    if log_size is None:
        return
    if log_size.device != x2d.device or log_size.dtype != torch.float32 \
            or not log_size.is_contiguous():
        raise ValueError(f"{name}: log_size must be contiguous float32 on {x2d.device}")
    _build.check_shape(name, "log_size", log_size, (x2d.shape[0] // seq_len, seq_len))


def check_tile_operands(x2d, ln_scale, ln_bias, wqkv, *_, **__) -> None:
    """bf16: the operands the GEMM core copies 16 bytes at a time — W_qkv,
    and the width D of LN1's scratch (the GEMM's A rows) — on the 16-byte
    grid; the wrapper's arguments, raises ``ValueError`` otherwise."""
    _build.check_tiles("ln_qkv_attn", (("D", x2d.shape[-1]),), wqkv=wqkv)


def ln_qkv_attn_plain(
    x2d: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    num_heads: int,
    seq_len: int,
    eps: float,
    log_size=None,
    return_kmean: bool = False,
):
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points."""
    dtype = x2d.dtype
    h = _ln(x2d, ln_scale, ln_bias, eps).to(dtype)
    qkv = (h.float() @ wqkv.float() + bqkv.float()).to(dtype)
    ctx = packed_attention_plain(qkv, num_heads, seq_len, log_size)
    return (ctx, kmean_plain(qkv, num_heads)) if return_kmean else ctx


def ln_qkv_attn(
    x2d: torch.Tensor,
    ln_scale: torch.Tensor,
    ln_bias: torch.Tensor,
    wqkv: torch.Tensor,
    bqkv: torch.Tensor,
    num_heads: int,
    seq_len: int,
    eps: float,
    log_size=None,
    return_kmean: bool = False,
):
    """(B*T, D) -> attention context (B*T, D), or (context, kmean (B*T, dh))
    with ``return_kmean``; ``log_size`` (B, T) fp32 biases the key logits.
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    if x2d.device.type == "cpu":
        return ln_qkv_attn_plain(
            x2d, ln_scale, ln_bias, wqkv, bqkv, num_heads, seq_len, eps, log_size, return_kmean
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
    _check_log_size(name, log_size, x2d, seq_len)
    stats = h = None  # fp32's LN1 statistics, or bf16's LN1(x) rows
    if x2d.dtype == torch.bfloat16:
        check_tile_operands(x2d, ln_scale, ln_bias, wqkv)
        h = torch.empty(rows, d, dtype=x2d.dtype, device=x2d.device)
    else:
        stats = torch.empty(2 * rows, dtype=torch.float32, device=x2d.device)
    qkv = torch.empty(rows, d3, dtype=x2d.dtype, device=x2d.device)
    ctx = torch.empty(rows, d3 // 3, dtype=x2d.dtype, device=x2d.device)
    kmean = torch.empty(rows, dh, dtype=x2d.dtype, device=x2d.device) if return_kmean else None
    lib = _build.load_library()
    _build.check(
        lib.vt_ln_qkv_attn(
            x2d.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(),
            wqkv.data_ptr(), bqkv.data_ptr(), _build.ptr_or_null(stats),
            _build.ptr_or_null(h), qkv.data_ptr(), ctx.data_ptr(), _build.ptr_or_null(log_size),
            _build.ptr_or_null(kmean), rows // seq_len, seq_len, d,
            num_heads, dh, eps, _build.DTYPE_CODES[x2d.dtype],
            x2d.device.index, _build.stream_of(x2d),
        ),
        name,
    )
    ln_qkv_attn.launches += 1
    return (ctx, kmean) if return_kmean else ctx


ln_qkv_attn.launches = 0
