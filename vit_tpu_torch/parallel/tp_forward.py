"""Tensor-parallel inference through the fused and W8A8 kernels —
counterpart of ``vit_tpu.parallel.tp_forward`` (its forward; training
through these blocks comes with the port's parallel training).

SPMD over a :class:`~vit_tpu_torch.parallel.mesh.Mesh`: every rank runs
this code on its own shard of the weights (``sharding.shard_params``), and
the ``tp`` group's all-reduces complete each block:

  - K1 ``ln_qkv_attn`` (K15 ``ln_qkv_attn_q8`` on ``quant``) is
    column-parallel: a rank holds the packed (head, {q,k,v}, head_dim)
    columns of its own heads and attends over those heads only.  Nothing
    is communicated: LN1's input is whole on every rank.
  - out_proj is row-parallel: the local context columns times the matching
    wo rows give an fp32 partial (``torch.matmul`` in fp32, never TF32);
    an all-reduce SUM completes it, and the bias and the residual are
    added after the sum.
  - The MLP is column- then row-parallel: K5 ``ln_mlp_residual(partial=
    True)`` returns this rank's fp32 partial (no b2, no residual), an
    all-reduce SUM completes it, then b2 and the residual.  On ``quant``,
    K18a ``ln_fc1_gelu_q8``, the row absmax all-reduced MAX, K18b
    ``fc2_q8_partial`` and an int32 all-reduce SUM before the dequant keep
    the unsharded kernel's quantization grouping bit for bit
    (``_mlp_q8_tp``).

Two all-reduces of the (B_local*T, D) fp32 activation per layer (a third,
of one float per row, on ``quant``).  ``dp`` composes: the batch splits
over it (``shard_forward.py``) while the weights are whole over it.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.ops import fused_block
from vit_tpu_torch.ops import reference
from vit_tpu_torch.parallel.mesh import Mesh


def _ctx_long_seq_tp(x2d, blk, heads_local: int, seq_len: int, eps: float, quant: bool):
    """Local-head attention context past ``VMEM_ATTENTION_MAX_T``: LN1 and
    the QKV product in plain torch (K15's stages 1-2, ``ln_qkv_q8``, on
    ``quant``: the same W8A8 grouping), then K13 over the local heads —
    ``fused_block._long_seq_block``'s entry."""
    from vit_tpu_torch.ops.flash_attention import flash_context_from_packed_qkv

    rows, d = x2d.shape
    b = rows // seq_len
    if quant:
        from vit_tpu_torch.ops.kernels.ln_qkv_attn_q8 import ln_qkv_q8

        qkv = ln_qkv_q8(x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
                        blk["wqkv_scale"], blk["bqkv"], eps)
    else:
        h = reference.layer_norm(x2d, blk["ln1_scale"], blk["ln1_bias"], eps)
        qkv = reference.linear(h, blk["wqkv"], blk["bqkv"])
    return flash_context_from_packed_qkv(qkv, b, seq_len, heads_local)


def fused_block_tp(x2d: torch.Tensor, blk, heads_local: int, seq_len: int, eps: float,
                   gelu_variant: str, mesh: Mesh, quant: bool) -> torch.Tensor:
    """One pre-LN encoder block, this rank's slice: local-head attention,
    out_proj and MLP completed by all-reduces over ``tp`` (module
    docstring).  The switch to the long-sequence context is read at call
    time."""
    dtype = x2d.dtype
    if seq_len > fused_block.VMEM_ATTENTION_MAX_T:
        ctx = _ctx_long_seq_tp(x2d, blk, heads_local, seq_len, eps, quant)
    elif quant:
        from vit_tpu_torch.ops.kernels.ln_qkv_attn_q8 import ln_qkv_attn_q8

        ctx = ln_qkv_attn_q8(x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
                             blk["wqkv_scale"], blk["bqkv"], heads_local, seq_len, eps)
    else:
        from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn

        ctx = ln_qkv_attn(x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["bqkv"],
                          heads_local, seq_len, eps)
    # row-parallel out_proj: fp32 partial -> sum over tp -> bias + residual
    part = mesh.all_reduce(torch.matmul(ctx.float(), blk["wo"].float()), "tp")
    x2d = (part + blk["bo"].float() + x2d.float()).to(dtype)
    if quant:
        return _mlp_q8_tp(x2d, blk, eps, gelu_variant, mesh)
    from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual

    part2 = ln_mlp_residual(x2d, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["b1"],
                            blk["w2"], blk["b2"], eps, gelu_variant, partial=True)
    part2 = mesh.all_reduce(part2, "tp")
    return (part2 + blk["b2"].float() + x2d.float()).to(dtype)


def _dequant_out(acc2, ms, blk, x2d):
    """(acc2 ms) w2s + b2 + x, rounded: the unsharded kernel's order."""
    out = acc2.float() * ms * blk["w2_scale"].float()
    return (out + blk["b2"].float() + x2d.float()).to(x2d.dtype)


def _row_scale(mmax: torch.Tensor) -> torch.Tensor:
    """max(mmax / 127, 1e-12), divided tensor by tensor (torch divides by a
    Python scalar through a reciprocal on CUDA)."""
    return torch.clamp(mmax / torch.full_like(mmax, 127.0), min=1e-12)


def _mlp_q8_tp(x2d, blk, eps: float, variant: str, mesh: Mesh) -> torch.Tensor:
    """The W8A8 MLP, tensor-parallel, through K18a and K18b.  The row scale
    of ``mid`` is an absmax over the whole hidden row, but a rank holds
    F/tp of its columns: so the row maxima meet in an all-reduce MAX
    between the two kernels, and FC2's int32 sums meet in an all-reduce SUM
    before the dequant, which keeps the arithmetic the unsharded kernel's.
    ``_mlp_q8_tp_ref`` is its plain oracle."""
    from vit_tpu_torch.ops.kernels.fc2_q8_partial import fc2_q8_partial
    from vit_tpu_torch.ops.kernels.ln_fc1_gelu_q8 import ln_fc1_gelu_q8

    mid = ln_fc1_gelu_q8(x2d, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["w1_scale"],
                         blk["b1"], eps, variant,
                         # the unsharded kernels' erf form: another would move
                         # values right before the round()
                         fast_erf=fused_block.use_fast_erf(x2d.dtype))
    ms = _row_scale(mesh.all_reduce(mid.abs().amax(-1, keepdim=True), "tp", "max"))
    acc2 = mesh.all_reduce(fc2_q8_partial(mid, ms, blk["w2"]), "tp")  # exact: int32
    return _dequant_out(acc2, ms, blk, x2d)


def _mlp_q8_tp_ref(x2d, blk, eps: float, variant: str, mesh: Mesh) -> torch.Tensor:
    """Plain torch formulation of :func:`_mlp_q8_tp`, the oracle the kernel
    pair is held to; the same math by design."""
    from vit_tpu_torch.ops.quant import int8_dot, int8_matmul_reference, quantize_activations

    hq, hs = quantize_activations(fused_block._ln(x2d, blk["ln2_scale"], blk["ln2_bias"], eps))
    mid = int8_matmul_reference(hq, hs, blk["w1"], blk["w1_scale"].float(), blk["b1"].float())
    mid = fused_block._gelu(mid, variant, fast_erf=fused_block.use_fast_erf(x2d.dtype))
    ms = _row_scale(mesh.all_reduce(mid.abs().amax(-1, keepdim=True), "tp", "max"))
    mq = torch.clamp(torch.round(mid / ms), -127, 127).to(torch.int8)
    acc2 = mesh.all_reduce(int8_dot(mq, blk["w2"]).to(torch.int32), "tp")
    return _dequant_out(acc2, ms, blk, x2d)


def _local_forward(params, images, cfg: ViTConfig, heads_local: int, gelu_variant: str,
                   quant: bool, mesh: Mesh, return_features: bool = False) -> torch.Tensor:
    """This rank's forward: whole embeddings and head, tensor-parallel
    encoder blocks (``models/vit.forward``'s fused branch)."""
    from vit_tpu_torch.models import vit

    x = images.to(params["pos_embed"].dtype)
    x = reference.patch_embed(x, params["patch_embed"]["kernel"], params["patch_embed"]["bias"],
                              cfg.patch_size)
    x = reference.add_cls_and_pos(x, vit.prefix_tokens(params), params["pos_embed"])
    b, t, d = x.shape
    x2 = x.reshape(b * t, d)
    for blk in vit.layers(params["blocks"])[: cfg.depth]:
        x2 = fused_block_tp(x2, blk, heads_local, t, cfg.layernorm_eps, gelu_variant, mesh,
                            quant)
    from vit_tpu_torch.ops.kernels.layer_norm import layer_norm

    x = layer_norm(x2.reshape(b, t, d), params["ln_final"]["scale"],
                   params["ln_final"]["bias"], cfg.layernorm_eps)
    if return_features:
        return x[..., 0, :].float()
    return vit.apply_head(x, params)


def shard_forward_tp(cfg: ViTConfig, mesh: Mesh, ops_name: str, gelu_variant: str = "exact",
                     return_features: bool = False):
    """-> ``forward(local_params, images)`` running the ``fused`` or
    ``quant`` kernel path over a (dp x) tp mesh: ``local_params`` this
    rank's shard (``sharding.shard_params``), ``images`` the whole batch on
    every rank (it splits over ``dp``), the logits (or features) of the
    whole batch out on every rank."""
    from vit_tpu_torch.parallel.shard_forward import shard_forward_dp

    if "tp" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'tp' axis")
    tp = mesh.shape["tp"]
    if cfg.num_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.num_heads}")
    if cfg.mlp_dim % tp:
        raise ValueError(f"tp={tp} must divide mlp_dim={cfg.mlp_dim}")
    if ops_name not in ("fused", "quant"):
        raise ValueError(f"shard_forward_tp supports ops 'fused'/'quant', got {ops_name!r}")
    heads_local, quant = cfg.num_heads // tp, ops_name == "quant"

    def local_fn(p, x):
        return _local_forward(p, x, cfg, heads_local, gelu_variant, quant, mesh,
                              return_features=return_features)

    return shard_forward_dp(local_fn, mesh)
