"""K15: LN1 -> per-row int8 -> int8 QKV GEMM -> dequant -> per-head
attention, CUDA (``csrc/ln_qkv_attn_q8.cu``).

Replaces ``vit_tpu/ops/pallas/quant_kernels.py:ln_qkv_attn_q8`` (def :152,
pallas_call at :133; body ``_ln_qkv_attn_q8_kernel`` :52, ``_qkv_q8`` :38).

W_qkv arrives as int8 [in, out] with fp32 per-column scales
(``ops/quant.py``).  What bounds it on the H100: the QKV GEMM (B/16 batch
100: 19,700 x 768 x 2,304, 70 G integer operations) is tensor-core work at
the int8 rate, attention (T = 197, dh = 64) a further 12 GFLOP in the
working dtype.  Three stages over device scratches, one C entry point:

  1. per row: LN1 in fp32 from fp32 statistics — h is NOT rounded to the
     working dtype, unlike K1 — the row's absmax, its scale hs =
     max(absmax / 127, 1e-12) and its int8 codes hq =
     clip(round(h / hs), -127, 127), with a true divide and
     round-half-to-even (``csrc/quant_rows.cuh``): a (rows, D) int8 and a
     (rows,) fp32 scratch;
  2. the int8 GEMM hq @ Wq on the tensor cores with exact int32 sums
     (``csrc/gemm_q8.cuh``); epilogue (acc * hs) * ws + b in fp32, rounded
     once to the working dtype into the packed-QKV scratch K1 also writes;
  3. K1's attention stage, unchanged (``csrc/attention.cuh``).

Stages 1-2 are an entry point of their own, :func:`ln_qkv_q8`: the
long-sequence W8A8 block (``ops/quant_block.py``) runs them before K13, so
the short and the long block share one definition of the QKV grouping, as
``_qkv_q8`` does in the JAX package.

A kernel and its twin reduce LN's mean and variance in different orders, so
h differs in its last bits and a code that sat on a rounding boundary moves
by one; the card checks (``eval/quant_stages.py``) therefore compare stage
by stage, each twin stage fed the kernel's own previous stage.

Token merging's hooks are K1's (``ln_qkv_attn.py``) on the same attention
stage: ``log_size`` biases the key logits, ``return_kmean`` also returns
the mean key over heads, read from the dequantized packed QKV — the q8
path's keys, as in the TPU kernel.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _ln
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.ln_qkv_attn import (
    HEAD_DIMS,
    _check_log_size,
    kmean_plain,
    packed_attention_plain,
)
from vit_tpu_torch.ops.quant import int8_matmul_reference, quantize_activations


def ln_qkv_q8_plain(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps):
    """Plain twin of stages 1-2 (``_qkv_q8`` rounded to the working dtype)
    -> (hq int8 (rows, D), hs fp32 (rows,), qkv (rows, 3D))."""
    hq, hs = quantize_activations(_ln(x2d, ln_scale, ln_bias, eps))
    qkv = int8_matmul_reference(hq, hs, wq, w_scale.float(), bqkv.float())
    return hq, hs, qkv.to(x2d.dtype)


def ln_qkv_attn_q8_plain(
    x2d, ln_scale, ln_bias, wq, w_scale, bqkv, num_heads: int, seq_len: int, eps: float,
    log_size=None, return_kmean: bool = False,
):
    """Plain twin: fp32 compute with casts at the TPU kernel's rounding
    points."""
    qkv = ln_qkv_q8_plain(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps)[2]
    ctx = packed_attention_plain(qkv, num_heads, seq_len, log_size)
    return (ctx, kmean_plain(qkv, num_heads)) if return_kmean else ctx


def _stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps, attention=None, log_size=None,
            return_kmean=False):
    """-> {hq, hs, qkv} of stages 1-2, and with ``attention = (num_heads,
    seq_len)`` also {ctx} of the whole of K15 (and {kmean} with
    ``return_kmean``): the kernel's scratches and outputs on the card (one
    launch of the one or the other C entry point), the twin's on the CPU."""
    if x2d.device.type == "cpu":
        st = dict(zip(("hq", "hs", "qkv"),
                      ln_qkv_q8_plain(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps)))
        if attention:
            st["ctx"] = packed_attention_plain(st["qkv"], *attention, log_size)
            if return_kmean:
                st["kmean"] = kmean_plain(st["qkv"], attention[0])
        return st
    fn = ln_qkv_attn_q8 if attention else ln_qkv_q8
    name = fn.__name__
    _build.check_q8_operands(name, x2d, (ln_scale, ln_bias, bqkv), (wq,), (w_scale,))
    rows, d = x2d.shape
    d3 = wq.shape[-1]
    _build.check_shape(name, "ln_scale", ln_scale, (d,))
    _build.check_shape(name, "ln_bias", ln_bias, (d,))
    _build.check_shape(name, "wq", wq, (d, d3))
    _build.check_shape(name, "w_scale", w_scale, (d3,))
    _build.check_shape(name, "bqkv", bqkv, (d3,))
    dev = x2d.device
    st = {"hq": torch.empty(rows, d, dtype=torch.int8, device=dev),
          "hs": torch.empty(rows, dtype=torch.float32, device=dev),
          "qkv": torch.empty(rows, d3, dtype=x2d.dtype, device=dev)}
    operands = [t.data_ptr() for t in (x2d, ln_scale, ln_bias, wq, w_scale, bqkv, *st.values())]
    tail = (eps, _build.DTYPE_CODES[x2d.dtype], dev.index, _build.stream_of(x2d))
    lib = _build.load_library()
    if attention:
        num_heads, seq_len = attention
        if d3 % (3 * num_heads) or rows % seq_len:
            raise ValueError(
                f"{name}: W_qkv width {d3} is not 3 x {num_heads} heads, or "
                f"{rows} rows are not whole sequences of {seq_len}"
            )
        dh = d3 // (3 * num_heads)
        if dh not in HEAD_DIMS:
            raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
        _check_log_size(name, log_size, x2d, seq_len)
        st["ctx"] = torch.empty(rows, d3 // 3, dtype=x2d.dtype, device=dev)
        if return_kmean:
            st["kmean"] = torch.empty(rows, dh, dtype=x2d.dtype, device=dev)
        status = lib.vt_ln_qkv_attn_q8(*operands, st["ctx"].data_ptr(),
                                       _build.ptr_or_null(log_size),
                                       _build.ptr_or_null(st.get("kmean")), rows // seq_len,
                                       seq_len, d, num_heads, dh, *tail)
    else:
        status = lib.vt_ln_qkv_q8(*operands, rows, d, d3, *tail)
    _build.check(status, name)
    fn.launches += 1
    return st


def ln_qkv_q8(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps: float) -> torch.Tensor:
    """(B*T, D) -> packed QKV (B*T, 3D) in x's dtype: K15's stages 1-2 (LN1,
    row quantizer, int8 GEMM, dequant + bias).  CPU tensors take the plain
    twin; CUDA tensors launch the kernel."""
    return _stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps)["qkv"]


ln_qkv_q8.launches = 0


def _ln_qkv_q8_stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps):
    """The stage scratches of :func:`ln_qkv_q8`, for the card checks."""
    return _stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps)


def ln_qkv_attn_q8(
    x2d, ln_scale, ln_bias, wq, w_scale, bqkv, num_heads: int, seq_len: int, eps: float,
    log_size=None, return_kmean: bool = False,
) -> torch.Tensor:
    """(B*T, D) -> attention context (B*T, D) over an int8 W_qkv, or
    (context, kmean (B*T, dh)) with ``return_kmean``; ``log_size`` (B, T)
    fp32 biases the key logits.  CPU tensors take the plain twin; CUDA
    tensors launch the kernel."""
    st = _ln_qkv_attn_q8_stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, num_heads, seq_len,
                                eps, log_size, return_kmean)
    return (st["ctx"], st["kmean"]) if return_kmean else st["ctx"]


ln_qkv_attn_q8.launches = 0


def _ln_qkv_attn_q8_stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, num_heads, seq_len, eps,
                           log_size=None, return_kmean=False):
    """The stage scratches and outputs of :func:`ln_qkv_attn_q8`, for the
    card checks."""
    return _stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps, (num_heads, seq_len),
                   log_size, return_kmean)


def gemm_q8_dequant(x_q, s_x, w_q, s_w) -> torch.Tensor:
    """The int8 GEMM core alone: int8 (M, K) @ (K, N) with exact int32 sums,
    -> fp32 (acc * s_x[m]) * s_w[n].  No model path calls it: it is the
    core's exactness test and its timing hook.  CPU tensors take
    ``int8_matmul_reference``; CUDA tensors launch the kernel."""
    if x_q.device.type == "cpu":
        return int8_matmul_reference(x_q, s_x, w_q, s_w)
    name = "gemm_q8_dequant"
    if x_q.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {x_q.device}")
    for t, dtype in ((x_q, torch.int8), (w_q, torch.int8), (s_x, torch.float32),
                     (s_w, torch.float32)):
        if t.dtype != dtype or t.device != x_q.device or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous int8 matrices and float32 "
                             f"scales on {x_q.device}")
    m, k = x_q.shape
    n = w_q.shape[1]
    _build.check_shape(name, "w_q", w_q, (k, n))
    _build.check_shape(name, "s_x", s_x, (m,))
    _build.check_shape(name, "s_w", s_w, (n,))
    if k % _build.Q8_VEC or n % _build.Q8_VEC or x_q.data_ptr() % _build.Q8_VEC \
            or w_q.data_ptr() % _build.Q8_VEC:
        raise ValueError(f"{name}: K and N must be multiples of {_build.Q8_VEC} and the "
                         f"matrices {_build.Q8_VEC}-byte aligned")
    out = torch.empty(m, n, dtype=torch.float32, device=x_q.device)
    _build.check(
        _build.load_library().vt_gemm_q8_dequant(
            x_q.data_ptr(), s_x.data_ptr(), w_q.data_ptr(), s_w.data_ptr(), out.data_ptr(),
            m, n, k, x_q.device.index, _build.stream_of(x_q),
        ),
        name,
    )
    return out
