"""The fused encoder block: two CUDA kernels over a flat (B*T, D) activation.

Counterpart of ``vit_tpu.ops.pallas.fused_block.fused_encoder_block``:

  K1 ``ln_qkv_attn``          LN1 -> packed QKV projection -> attention
  K2 ``out_ln_mlp_residual``  out_proj + residual -> LN2 -> FC1 -> GELU ->
                              FC2 -> residual

The shared numerics of the kernels' plain twins live here, as in the JAX
module: ``_ln`` (fp32 statistics, centred variance) and the GELU helpers
(``_gelu``, ``_erf``, ``_erf_tanh_inner``, ``use_fast_erf``).  The CUDA
sources compute the same formulas (``csrc/common.cuh``).
"""

from __future__ import annotations

import torch

# Past this sequence length the JAX package routes the block to blockwise
# flash attention (fused_block.VMEM_ATTENTION_MAX_T), which is not ported.
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


def fused_encoder_block(
    x2d: torch.Tensor,
    blk,
    num_heads: int,
    seq_len: int,
    eps: float,
    gelu_variant: str = "exact",
) -> torch.Tensor:
    """One pre-LN encoder block on a flat (B*T, D) activation: K1 then K2."""
    if seq_len > VMEM_ATTENTION_MAX_T:
        raise NotImplementedError(
            f"seq_len {seq_len} > {VMEM_ATTENTION_MAX_T}: the JAX package "
            "routes this to blockwise flash attention (K13), which is not "
            "ported yet (ROADMAP.md)"
        )
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
