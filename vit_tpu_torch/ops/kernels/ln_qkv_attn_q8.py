"""K15: LN1 -> per-row int8 -> int8 QKV GEMM -> dequant -> per-head
attention, CUDA (``csrc/ln_qkv_attn_q8.cu``).

Replaces ``vit_tpu/ops/pallas/quant_kernels.py:ln_qkv_attn_q8`` (def :152,
pallas_call at :133; body ``_ln_qkv_attn_q8_kernel`` :52, ``_qkv_q8`` :38).

W_qkv arrives as int8 [in, out] with fp32 per-column scales
(``ops/quant.py``).  What bounds it on the H100: the QKV GEMM (B/16 batch
100: 19,700 x 768 x 2,304, 70 G integer operations) is tensor-core work at
the int8 rate, attention (T = 197, dh = 64) a further 12 GFLOP in the
working dtype.  Stages over device scratches, one C entry point:

  1. per row: LN1 in fp32 from fp32 statistics — h is NOT rounded to the
     working dtype, unlike K1 — the row's absmax, its scale hs =
     max(absmax / 127, 1e-12) and its int8 codes hq =
     clip(round(h / hs), -127, 127), with a true divide and
     round-half-to-even (``csrc/quant_rows.cuh``): a (rows, D) int8 and a
     (rows,) fp32 scratch;
  2. the int8 GEMM hq @ Wq on the tensor cores with exact int32 sums;
     epilogue (acc * hs) * ws + b in fp32, rounded once to the working
     dtype into the packed-QKV scratch K1 also writes;
  3. K1's attention stage over that packed QKV.

bf16, the main path, runs stage 2 on the int8 TMA + ``wgmma`` core
(``csrc/gemm_mma_q8.cuh``), which reads both operands K-major: the sequence
first copies Wq transposed into an int8 scratch (``kmajor_q8.py``'s kernel;
the parameters keep the JAX package's [in, out] layout), and stage 3 is
K1's bf16 attention on ``mma.sync`` register tiles
(``csrc/qkv_attention_mma.cuh``).  Its operand rule
(``check_tile_operands``): Wq 16-byte aligned with both dimensions
multiples of 16.  fp32 keeps the first design: the WMMA int8 core
(``csrc/gemm_q8.cuh``) and K1's fp32 SIMT attention
(``csrc/attention.cuh``).  Both dtypes share stage 1.

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

K19 :func:`ln_qkv_attn_q8a` (``csrc/ln_qkv_attn_q8a.cu``) replaces
``quant_kernels.py:ln_qkv_attn_q8a`` (def :357; the pallas_call at :133
with ``attn_q8=True``, per-head math ``_head_context_q8`` :314): K15's
stages 1-2, then attention with int8 dots — q codes per (row, head), k
codes per (key, head) (the TPU kernel transposes k before quantizing, so
each key has its own scale), an exact int32 q·kᵀ, e = exp(s - m), and with
``quant_pv`` p8 = round(127 e) at the fixed scale, v codes per (image, head,
column) and an exact int32 p8·v8 dequantized by (1/sum)(1/127) vs;
``quant_pv=False`` keeps p·v in the working dtype.  Only the kernel study
(``cli/bench_kernels.py``) calls it; it takes no token-merging hook, as the
TPU kernel takes none.  The bf16 form runs on the cores the bf16 K15 runs
on: K15's stages 1-2 through the same host function (so the packed QKV is
K15's bit for bit, and the same operand rule, ``check_tile_operands``),
vectorized code passes, and the dots on ``mma.sync`` m16n8k32 s8 register
tiles; its v codes lie keys-contiguous, (B, H, dh, T padded to 16)
(:func:`v8_keys_major`), the K-major B operand of p·v.  fp32 keeps the first
design: the WMMA QKV GEMM and ``__dp4a`` dots on the CUDA cores, v codes in
(B*T, D) rows.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _ln
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.kmajor_q8 import kmajor_q8_scratch
from vit_tpu_torch.ops.kernels.ln_qkv_attn import (
    HEAD_DIMS,
    _check_log_size,
    kmean_plain,
    packed_attention_plain,
)
from vit_tpu_torch.ops.quant import (
    _symmetric_int8,
    int8_dot,
    int8_matmul_reference,
    quantize_activations,
)


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


def _qkv_q8_scratch(name, x2d, ln_scale, ln_bias, wq, w_scale, bqkv) -> dict:
    """Raise on what stages 1-2 do not take; -> their scratches {hq, hs,
    qkv} on x's device."""
    _build.check_q8_operands(name, x2d, (ln_scale, ln_bias, bqkv), (wq,), (w_scale,))
    rows, d = x2d.shape
    d3 = wq.shape[-1]
    _build.check_shape(name, "ln_scale", ln_scale, (d,))
    _build.check_shape(name, "ln_bias", ln_bias, (d,))
    _build.check_shape(name, "wq", wq, (d, d3))
    _build.check_shape(name, "w_scale", w_scale, (d3,))
    _build.check_shape(name, "bqkv", bqkv, (d3,))
    dev = x2d.device
    return {"hq": torch.empty(rows, d, dtype=torch.int8, device=dev),
            "hs": torch.empty(rows, dtype=torch.float32, device=dev),
            "qkv": torch.empty(rows, d3, dtype=x2d.dtype, device=dev)}


def check_tile_operands(x2d, ln_scale, ln_bias, wq, *_, kernel="ln_qkv_attn_q8", **__) -> None:
    """bf16: what the int8 TMA + ``wgmma`` core reads — Wq two-dimensional,
    16-byte aligned, both dimensions multiples of 16 (its K-major copy, the
    code scratch's pitch D, the GEMM's width 3D; a 3D that is a multiple of
    16 also gives the attention tiles' 16-byte rows of the packed QKV); the
    wrapper's arguments (K15's, or K19's with ``kernel="ln_qkv_attn_q8a"``),
    raises ``ValueError`` otherwise."""
    _build.check_q8_matrices(kernel, wq)


def _head_dim(name, d3, rows, num_heads, seq_len) -> int:
    """The head width of a packed QKV of width ``d3``; raises unless the
    attention stage is instantiated for it."""
    if d3 % (3 * num_heads) or rows % seq_len:
        raise ValueError(
            f"{name}: W_qkv width {d3} is not 3 x {num_heads} heads, or "
            f"{rows} rows are not whole sequences of {seq_len}"
        )
    dh = d3 // (3 * num_heads)
    if dh not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {dh} not in {HEAD_DIMS}")
    return dh


def _stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps, attention=None, log_size=None,
            return_kmean=False):
    """-> {hq, hs, qkv} of stages 1-2, and with ``attention = (num_heads,
    seq_len)`` also {ctx} of the whole of K15 (and {kmean} with
    ``return_kmean``): the kernel's scratches and outputs on the card (one
    launch of the one or the other C entry point; bf16 adds {wqt}, the
    K-major copy of Wq its GEMM reads), the twin's on the CPU."""
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
    st = _qkv_q8_scratch(name, x2d, ln_scale, ln_bias, wq, w_scale, bqkv)
    if x2d.dtype == torch.bfloat16:
        check_tile_operands(x2d, ln_scale, ln_bias, wq)
        st["wqt"], = kmajor_q8_scratch(wq)
    rows, d = x2d.shape
    d3 = wq.shape[-1]
    dev = x2d.device
    operands = [*(t.data_ptr() for t in (x2d, ln_scale, ln_bias, wq, w_scale, bqkv)),
                _build.ptr_or_null(st.get("wqt")),
                *(st[k].data_ptr() for k in ("hq", "hs", "qkv"))]
    tail = (eps, _build.DTYPE_CODES[x2d.dtype], dev.index, _build.stream_of(x2d))
    lib = _build.load_library()
    if attention:
        num_heads, seq_len = attention
        dh = _head_dim(name, d3, rows, num_heads, seq_len)
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


# -- K19: int8 attention dots ---------------------------------------------------


# the bf16 kernel's v codes: each (image, head, column)'s keys contiguous,
# padded with zero codes to a multiple of this (16-byte rows)
V8_KEY_PAD = 16


def v8_keys_major(dtype) -> bool:
    """Whether K19 in ``dtype`` writes v's codes keys-contiguous, (B, H, dh,
    T padded to ``V8_KEY_PAD``): bf16 does (its p·v reads them as a K-major
    operand); fp32 writes (B*T, D) rows."""
    return dtype == torch.bfloat16


def attention_q8_codes_plain(qkv, num_heads: int, seq_len: int, quant_pv: bool = True,
                             keys_major: bool = False) -> dict:
    """Stage 3a's twin: the packed QKV (B*T, 3D) -> codes and scales of the
    attention operands, in the kernel's layouts: q8/k8 (B*T, D) int8 with
    qs/ks (B*T, H) fp32 (per row and head, over dh), and with ``quant_pv``
    v8 with vs (B, H, dh) (per image, head and column, over the image's
    tokens): v8 (B*T, D), or with ``keys_major`` (B, H, dh, T padded to
    ``V8_KEY_PAD`` with zero codes), the bf16 kernel's layout."""
    rows, d3 = qkv.shape
    dh = d3 // (3 * num_heads)
    b = rows // seq_len
    q, k, v = qkv.float().reshape(b, seq_len, num_heads, 3, dh).unbind(3)  # (B, T, H, dh)
    (q8, qs), (k8, ks) = quantize_activations(q), quantize_activations(k)
    out = {"q8": q8.reshape(rows, -1), "qs": qs.reshape(rows, num_heads),
           "k8": k8.reshape(rows, -1), "ks": ks.reshape(rows, num_heads)}
    if quant_pv:
        v8, vs = _symmetric_int8(v, v.abs().amax(dim=1, keepdim=True))
        if keys_major:
            pad = -seq_len % V8_KEY_PAD
            v8 = torch.nn.functional.pad(v8.permute(0, 2, 3, 1), (0, pad)).contiguous()
        else:
            v8 = v8.reshape(rows, -1)
        out.update(v8=v8, vs=vs.reshape(b, num_heads, dh))
    return out


def attention_q8_plain(codes: dict, qkv, num_heads: int, seq_len: int, quant_pv: bool = True,
                       p8=None):
    """Stage 3b's twin on given codes (``_head_context_q8``): -> (context
    (B*T, D) in qkv's dtype, p8 (B, H, T, T) int8, or None without
    ``quant_pv``).  A given ``p8`` (the kernel's) replaces the twin's own in
    p8·v8; the row sums stay the twin's."""
    rows, d3 = qkv.shape
    dh = d3 // (3 * num_heads)
    b = rows // seq_len

    def heads(a):  # (B*T, H*w) -> (B, H, T, w)
        return a.reshape(b, seq_len, num_heads, -1).permute(0, 2, 1, 3)

    scale = torch.tensor(1.0 / dh ** 0.5, dtype=torch.float32)
    qs, ks = heads(codes["qs"]), heads(codes["ks"]).transpose(-1, -2)  # (B,H,T,1), (B,H,1,T)
    s = int8_dot(heads(codes["q8"]), heads(codes["k8"]).transpose(-1, -2)).float()
    s = s * (qs * scale) * ks
    e = torch.exp(s - s.amax(-1, keepdim=True))
    total = e.sum(-1, keepdim=True)
    inv = torch.ones_like(total) / total
    if quant_pv:
        if p8 is None:
            p8 = torch.round(e * 127.0).to(torch.int8)  # the fixed scale: e <= 1
        v8 = codes["v8"]  # (B*T, D) rows, or keys-major (B, H, dh, T padded)
        v8 = v8[..., :seq_len].transpose(-1, -2) if v8.dim() == 4 else heads(v8)
        ctx = int8_dot(p8, v8).float() * (inv * (1.0 / 127.0))
        ctx = ctx * codes["vs"][:, :, None, :]
    else:
        v = heads(qkv.reshape(b, seq_len, num_heads, 3, dh)[:, :, :, 2].reshape(rows, -1))
        ctx, p8 = (e * inv).to(qkv.dtype).float() @ v.float(), None
    return ctx.permute(0, 2, 1, 3).reshape(rows, -1).to(qkv.dtype), p8


def ln_qkv_attn_q8a_plain(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, num_heads: int,
                          seq_len: int, eps: float, quant_pv: bool = True) -> torch.Tensor:
    """Plain twin of K19: fp32 compute with the TPU kernel's quantization
    grouping and rounding points."""
    qkv = ln_qkv_q8_plain(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps)[2]
    codes = attention_q8_codes_plain(qkv, num_heads, seq_len, quant_pv)
    return attention_q8_plain(codes, qkv, num_heads, seq_len, quant_pv)[0]


def _ln_qkv_attn_q8a_stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, num_heads, seq_len, eps,
                            quant_pv=True, return_p=False) -> dict:
    """-> {hq, hs, qkv, q8, qs, k8, ks, ctx} (and {v8, vs} with ``quant_pv``,
    {p8} with ``return_p`` too; v8 in the layout of :func:`v8_keys_major`):
    the kernel's scratches and output on the card (one launch; bf16 adds
    {wqt}, the K-major copy of Wq its GEMM reads), the twin's on the CPU."""
    name = "ln_qkv_attn_q8a"
    keys_major = v8_keys_major(x2d.dtype)
    if x2d.device.type == "cpu":
        st = dict(zip(("hq", "hs", "qkv"),
                      ln_qkv_q8_plain(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, eps)))
        st.update(attention_q8_codes_plain(st["qkv"], num_heads, seq_len, quant_pv, keys_major))
        st["ctx"], p8 = attention_q8_plain(st, st["qkv"], num_heads, seq_len, quant_pv)
        if return_p and quant_pv:
            st["p8"] = p8
        return st
    st = _qkv_q8_scratch(name, x2d, ln_scale, ln_bias, wq, w_scale, bqkv)
    if x2d.dtype == torch.bfloat16:
        check_tile_operands(x2d, ln_scale, ln_bias, wq, kernel=name)
        st["wqt"], = kmajor_q8_scratch(wq)
    rows, d = x2d.shape
    d3 = wq.shape[-1]
    dh = _head_dim(name, d3, rows, num_heads, seq_len)
    dev, b = x2d.device, rows // seq_len

    def new(*shape, dtype=torch.int8):
        return torch.empty(*shape, dtype=dtype, device=dev)

    st.update(q8=new(rows, d3 // 3), qs=new(rows, num_heads, dtype=torch.float32),
              k8=new(rows, d3 // 3), ks=new(rows, num_heads, dtype=torch.float32))
    if quant_pv:
        v8 = (new(b, num_heads, dh, seq_len + -seq_len % V8_KEY_PAD) if keys_major
              else new(rows, d3 // 3))
        st.update(v8=v8, vs=new(b, num_heads, dh, dtype=torch.float32))
        if return_p:
            st["p8"] = new(b, num_heads, seq_len, seq_len)
    st["ctx"] = new(rows, d3 // 3, dtype=x2d.dtype)
    ptr = lambda key: _build.ptr_or_null(st.get(key))  # noqa: E731
    _build.check(
        _build.load_library().vt_ln_qkv_attn_q8a(
            *(t.data_ptr() for t in (x2d, ln_scale, ln_bias, wq, w_scale, bqkv)),
            *(ptr(k) for k in ("wqt", "hq", "hs", "qkv", "q8", "qs", "k8", "ks", "v8", "vs",
                               "p8", "ctx")),
            b, seq_len, d, num_heads, dh, int(bool(quant_pv)), eps,
            _build.DTYPE_CODES[x2d.dtype], dev.index, _build.stream_of(x2d),
        ),
        name,
    )
    ln_qkv_attn_q8a.launches += 1
    return st


def ln_qkv_attn_q8a(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, num_heads: int, seq_len: int,
                    eps: float, quant_pv: bool = True, log_size=None,
                    return_kmean: bool = False) -> torch.Tensor:
    """(B*T, D) -> attention context (B*T, D): K15 with int8 q·kᵀ and, with
    ``quant_pv``, int8 p·v.  Token merging's hooks raise, as the TPU
    kernel's do.  CPU tensors take the plain twin; CUDA tensors launch the
    kernel."""
    if log_size is not None or return_kmean:
        raise ValueError("the int8-attention study kernel has no ToMe hooks")
    return _ln_qkv_attn_q8a_stages(x2d, ln_scale, ln_bias, wq, w_scale, bqkv, num_heads,
                                   seq_len, eps, quant_pv)["ctx"]


ln_qkv_attn_q8a.launches = 0


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
