"""The fused encoder block: two CUDA kernels over a flat (B*T, D) activation.

Counterpart of ``vit_tpu.ops.pallas.fused_block.fused_encoder_block``:

  K1 ``ln_qkv_attn``          LN1 -> packed QKV projection -> attention
  K2 ``out_ln_mlp_residual``  out_proj + residual -> LN2 -> FC1 -> GELU ->
                              FC2 -> residual

Past ``VMEM_ATTENTION_MAX_T`` tokens the block is ``_long_seq_block``: K3
``layer_norm``, the QKV product as a plain ``reference.linear``, K13
blockwise flash attention (``ops/flash_attention.py``), then K2.

The shared numerics of the kernels' plain twins live here, as in the JAX
module: ``_ln`` (fp32 statistics, centred variance) and the GELU helpers
(``_gelu``, ``_erf``, ``_erf_tanh_inner``, ``use_fast_erf``).  The CUDA
sources compute the same formulas (``csrc/common.cuh``).
"""

from __future__ import annotations

import numpy as np
import torch

# Past this sequence length the block runs blockwise flash attention, as
# the JAX package's (fused_block.VMEM_ATTENTION_MAX_T) does.  Read at call
# time (tests lower it); it stays at the JAX package's 1024 so that both
# route alike, though K1 takes any T (PERF.md has the H100 measurement).
VMEM_ATTENTION_MAX_T = 1024


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float):
    """fp32 LayerNorm statistics (centred variance), fp32 result."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    c = xf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    return c * torch.rsqrt(var + eps) * scale.float() + bias.float()


def _erf(x: torch.Tensor) -> torch.Tensor:
    """erf via Abramowitz-Stegun 7.1.26 (|err| <= 1.5e-7) — the fp32
    kernels' form (``vit_tpu.ops.pallas.mlp_kernel._erf``)."""
    a = x.abs()
    t = 1.0 / (1.0 + 0.3275911 * a)
    poly = t * (
        0.254829592
        + t * (-0.284496736 + t * (1.421413741 + t * (-1.453152027 + t * 1.061405429)))
    )
    y = 1.0 - poly * torch.exp(-a * a)
    return torch.sign(x) * y


# erf(x) ~= tanh(x * q(x^2)) with x clamped to [-B, B]: |erf err| <= 3.1e-5,
# below bf16 resolution, so the bf16 kernels use it.
_ERF_TANH_Q = (
    1.1281997085186337, 0.10359029852786425, -0.0011219408928909798,
    -0.00022230843767343287, 1.4501721850515667e-05,
)
_ERF_TANH_B = 3.2


def _erf_tanh_inner(x: torch.Tensor):
    """-> (clamped x, q(x^2), tanh(x*q))."""
    xc = x.clamp(-_ERF_TANH_B, _ERF_TANH_B)
    t = xc * xc
    q = torch.full_like(t, _ERF_TANH_Q[-1])
    for c in _ERF_TANH_Q[-2::-1]:
        q = q * t + c
    return xc, q, torch.tanh(xc * q)


def _gelu(h: torch.Tensor, variant: str, fast_erf: bool = False) -> torch.Tensor:
    if variant == "exact":
        if fast_erf:
            _, _, t = _erf_tanh_inner(h * 0.7071067811865476)
            return 0.5 * h * (1.0 + t)
        return 0.5 * h * (1.0 + _erf(h * 0.7071067811865476))
    return 0.5 * h * (1.0 + torch.tanh(0.7978845608028654 * (h + 0.044715 * h * h * h)))


def use_fast_erf(dtype: torch.dtype) -> bool:
    """bf16 paths use the tanh-form erf; fp32 keeps the A-S form."""
    return dtype == torch.bfloat16


# -- training-mode regularizer masks ------------------------------------------
# The regularized kernels (K10-K12a) apply torchvision's three in-block
# dropout sites and stochastic depth in their loads and epilogues.  No mask
# is stored: every kernel regenerates it from a counter-based hash of
# (per-layer seed, site, absolute row, column), bit-identical to the JAX
# package's (vit_tpu/ops/pallas/fused_block.py:104-156).  The CUDA side
# (csrc/common.cuh mask_hash) computes in uint32; this twin computes in
# int64 with every sum and product masked to 32 bits, because the CPU
# build of torch has no uint32 add, shift or compare.

DROP_SITE_ATTN_OUT = 1   # dropout after the attention out_proj
DROP_SITE_MLP_INNER = 2  # dropout between GELU and FC2 (torchvision MLPBlock)
DROP_SITE_MLP_OUT = 3    # dropout after FC2 (+b2)
DROP_SITE_DP_ATTN = 4    # stochastic depth, attention residual branch
DROP_SITE_DP_MLP = 5     # stochastic depth, MLP residual branch

_U32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """(a * k) mod 2^32 for int64 ``a`` in [0, 2^32) and a constant k <
    2^32, as two products below 2^48 (no int64 overflow)."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def mask_hash_u32(seed: int, site: int, r: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Uniform 32-bit hash (as int64 in [0, 2^32)) of (seed, site, row,
    col): a murmur3-finalizer mix.  ``r`` and ``c`` are int64 tensors of
    absolute positions; ``seed`` a Python int (its low 32 bits count)."""
    x = (_mul32(r, 0x9E3779B9) + _mul32(c, 0x85EBCA6B)
         + ((int(seed) & _U32) + ((site * 0x27D4EB2F) & _U32))) & _U32
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_threshold(p: float) -> int:
    """The dropped-below threshold of dropout rate ``p``, in Python double."""
    return int(p * 4294967296.0) & _U32


def dropout_keep(p: float) -> float:
    """The kept value of inverted dropout, fp32(1 / (1 - p))."""
    return float(np.float32(1.0 / (1.0 - p)))


def dropout_launch_args(seed: int, p: float):
    """The regularized kernels' host arguments: (uint32 seed, threshold,
    kept value, dropout on)."""
    return int(seed) & _U32, dropout_threshold(p), dropout_keep(p), int(p > 0)


def dropout_mask(seed: int, site: int, rows0: int, shape, p: float,
                 device=None) -> torch.Tensor:
    """(rows, cols) fp32 inverted-dropout multiplier for absolute rows
    ``rows0 ...`` and columns ``0 ...`` of the site's width: fp32(1/(1-p))
    kept, 0 dropped."""
    rows, cols = shape
    r = torch.arange(rows0, rows0 + rows, dtype=torch.int64, device=device)[:, None]
    c = torch.arange(cols, dtype=torch.int64, device=device)[None, :]
    bits = mask_hash_u32(seed, site, r, c)
    # Python scalars: a scalar tensor made on the card would be a blocking copy
    return torch.where(bits >= dropout_threshold(p), dropout_keep(p), 0.0).float()


def drop_path_threshold(rate: float) -> int:
    """uint32(fp32(rate) * fp32(4294967040)), truncated: 2^32 - 256 is the
    largest fp32 below 2^32, so rate ~ 1 cannot overflow, and rate 0 keeps
    every sample."""
    return int(np.float32(rate) * np.float32(4294967040.0))


def drop_path_scale_rows(seed: int, site: int, batch: int, seq_len: int, rate: float,
                         device=None) -> torch.Tensor:
    """(batch * seq_len,) fp32 stochastic-depth multiplier, constant within
    each sample: fp32 1/(1 - rate) kept, 0 dropped."""
    s = torch.arange(batch, dtype=torch.int64, device=device)
    bits = mask_hash_u32(seed, site, s, torch.zeros_like(s))
    keep = float(np.float32(1.0) / (np.float32(1.0) - np.float32(rate)))
    rows = torch.where(bits >= drop_path_threshold(rate), keep, 0.0).float()
    return rows.repeat_interleave(seq_len)


def _long_seq_block(x2d, blk, num_heads: int, seq_len: int, eps: float, gelu_variant: str):
    """The block past ``VMEM_ATTENTION_MAX_T``
    (``vit_tpu/ops/pallas/fused_block.py:_long_seq_block``): K3 LN1, the
    packed QKV product (a plain GEMM, as XLA's in JAX), K13, then K2."""
    from vit_tpu_torch.ops import reference
    from vit_tpu_torch.ops.flash_attention import flash_context_from_packed_qkv
    from vit_tpu_torch.ops.kernels.layer_norm import layer_norm
    from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import out_ln_mlp_residual

    h = layer_norm(x2d, blk["ln1_scale"], blk["ln1_bias"], eps)
    qkv = reference.linear(h, blk["wqkv"], blk["bqkv"])  # columns (H, 3, Dh)
    ctx = flash_context_from_packed_qkv(qkv, x2d.shape[0] // seq_len, seq_len, num_heads)
    return out_ln_mlp_residual(
        ctx, x2d, blk["wo"], blk["bo"], blk["ln2_scale"], blk["ln2_bias"],
        blk["w1"], blk["b1"], blk["w2"], blk["b2"], eps, gelu_variant,
    )


def fused_encoder_block(
    x2d: torch.Tensor,
    blk,
    num_heads: int,
    seq_len: int,
    eps: float,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """One pre-LN encoder block on a flat (B*T, D) activation: K1 then K2,
    or the long-sequence block past ``VMEM_ATTENTION_MAX_T``."""
    if seq_len > VMEM_ATTENTION_MAX_T:
        return _long_seq_block(x2d, blk, num_heads, seq_len, eps, gelu_variant)
    from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn
    from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import out_ln_mlp_residual

    ctx = ln_qkv_attn(
        x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["bqkv"],
        num_heads, seq_len, eps,
    )
    return out_ln_mlp_residual(
        ctx, x2d, blk["wo"], blk["bo"], blk["ln2_scale"], blk["ln2_bias"],
        blk["w1"], blk["b1"], blk["w2"], blk["b2"], eps, gelu_variant,
    )
