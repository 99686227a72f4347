"""Sequence parallelism: ring attention over an ``sp`` mesh axis —
counterpart of ``vit_tpu.parallel.sequence``.

The token axis splits over ``sp``: a rank holds ceil(T / sp) tokens of
every image of its batch.  Every encoder op but attention (LayerNorm, MLP,
residuals, and the patch embedding and position add in front) is per token
and runs on the local block alone; the patch embedding reads only the image
rows that hold the shard's own patches, so no rank ever holds the whole
(B, T, D) sequence.  Attention, the one cross-token op, runs as **ring
attention**: each rank keeps its block's queries and passes the keys and
values around the ring (``mesh.Shift``, one shift of K and V together a
hop), folding each incoming block into a blockwise online softmax.  No rank
holds T x T scores or the whole K/V.

Token counts that do not divide the ring (197 = 14^2 + CLS) pad with zero
rows: padded keys are masked out of the softmax and padded query rows are
dropped at the exit (only the prefix rows reach the head).  A shard that is
all padding is kept.

``eager`` runs the plain blocks with attention swapped for the ring;
``fused_train`` runs each shard's out_proj + residual through K4/K9
(``trainable.OutResidualFn``) and LN2 + MLP + residual through K5/K8
(``trainable.LnMlpResidualFn``), LN1 + QKV and the ring staying plain.
The ring's matmuls are plain PyTorch in fp32 (TF32 off), or bf16 products
accumulated in fp32, as the JAX package's are plain XLA ops.

Gradients: ``Shift``'s backward passes each hop's K/V gradients back
around the ring (``ppermute``'s transpose); the prefix rows reach the head
through ``mesh.BroadcastFrom``, whose gradient stays on shard 0, so every
leaf but the heads holds a shard's part of its gradient and is summed over
``sp`` (``sharding.sum_partial_grads``), the heads being differentiated
whole on every shard.  ``dp`` composes: the batch splits over it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import EAGER_OPS
from vit_tpu_torch.parallel.mesh import BroadcastFrom, Mesh, Shift

__all__ = ["attention_sp", "shard_forward_sp", "make_sp_train_step"]


def _ring_attention(q, k, v, valid_keys: torch.Tensor, mesh: Mesh, axis: str = "sp"):
    """Blockwise online-softmax attention around the ``axis`` ring.

    q, k, v: (B, H, T_local, Dh), this rank's token block.  ``valid_keys``:
    (n, T_local) bool, for each ring rank which of its key rows are real
    tokens.  -> (B, H, T_local, Dh) in the accumulation dtype: softmax(q kᵀ
    / sqrt(Dh)) v over the whole key range.  The local block folds first,
    then n - 1 hops, each folding the block that came from one rank further
    back.  The running maximum is taken as 0 while a row has seen no valid
    key, so that a block of padding alone gives alpha 0 and p 0, never NaN
    (nor a NaN gradient)."""
    n, me = mesh.size(axis), mesh.index(axis)
    scale = 1.0 / math.sqrt(q.shape[-1])
    qa = reference._acc(q)

    def fold(carry, kb, vb, src):
        m, l, acc = carry
        s = torch.einsum("bhqd,bhkd->bhqk", qa, reference._acc(kb)) * scale
        s = s.masked_fill(~valid_keys[src], float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1))
        m_safe = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - m_safe)  # 0 while m is -inf
        p = torch.exp(s - m_safe[..., None])  # masked entries give 0
        l_new = l * alpha + p.sum(dim=-1)
        # the probabilities rounded to v's dtype, accumulated in fp32 (as
        # reference.attention does)
        acc_new = acc * alpha[..., None] + torch.einsum(
            "bhqk,bhkd->bhqd", reference._acc(p.to(vb.dtype)), reference._acc(vb))
        return m_new, l_new, acc_new

    shape = q.shape[:-1]
    carry = (torch.full(shape, float("-inf"), dtype=qa.dtype, device=q.device),
             torch.zeros(shape, dtype=qa.dtype, device=q.device),
             torch.zeros(q.shape, dtype=qa.dtype, device=q.device))
    carry = fold(carry, k, v, me)
    kv = torch.stack([k, v])
    for hop in range(1, n):
        kv = Shift.apply(kv, mesh, axis)
        # after `hop` shifts the block came from rank (me - hop) mod n
        carry = fold(carry, kv[0], kv[1], (me - hop) % n)
    _, l, acc = carry
    return acc / l[..., None]


def attention_sp(x_local, wqkv, bqkv, wo, bo, num_heads: int, valid_keys: torch.Tensor,
                 mesh: Mesh, axis: str = "sp"):
    """``reference.attention`` on an sp-split token block: the local QKV
    projection, ring attention, the local out_proj (the packed (head,
    {q,k,v}, head_dim) column order)."""
    qkv = reference.linear(x_local, wqkv, bqkv)
    q, k, v = reference.split_packed_qkv(qkv, num_heads)
    ctx = _ring_attention(q, k, v, valid_keys, mesh, axis)
    return reference.linear(reference.merge_heads(ctx.to(x_local.dtype)), wo, bo)


def _layout(cfg: ViTConfig, n: int) -> int:
    """-> tokens a shard, after the JAX package's check that shard 0 holds
    every prefix token."""
    t_local = -(-cfg.seq_len // n)
    if t_local < cfg.num_prefix_tokens:
        raise ValueError(f"sp={n} leaves {t_local} tokens/shard < {cfg.num_prefix_tokens} "
                         "prefix tokens — shard 0 must hold the full prefix")
    return t_local


def _embed_shard(params, images, cfg: ViTConfig, i: int, t_local: int) -> torch.Tensor:
    """Shard ``i``'s (B, T_local, D) block of the embedded sequence: the
    prefix tokens on shard 0, the patches of this shard's tokens from the
    image rows that hold them alone, zero rows past the sequence, plus the
    position table's rows (zero past the sequence)."""
    p, gw, n_prefix = cfg.patch_size, cfg.image_size // cfg.patch_size, cfg.num_prefix_tokens
    b, d = images.shape[0], cfg.embed_dim
    dtype = params["pos_embed"].dtype
    tok0, tok1 = i * t_local, min((i + 1) * t_local, cfg.seq_len)
    parts = []
    if i == 0:
        parts.append(vit.prefix_tokens(params).to(dtype).reshape(n_prefix, d)
                     .expand(b, n_prefix, d))
    p0, p1 = max(tok0 - n_prefix, 0), max(tok1 - n_prefix, 0)  # this shard's patches
    if p1 > p0:
        r0, r1 = p0 // gw, (p1 - 1) // gw + 1  # the grid rows that hold them
        rows = images[..., r0 * p:r1 * p, :].to(dtype)
        patches = reference.patch_embed(rows, params["patch_embed"]["kernel"],
                                        params["patch_embed"]["bias"], p)
        parts.append(patches[:, p0 - r0 * gw:p1 - r0 * gw])
    pad = t_local - max(tok1 - tok0, 0)
    if pad:
        parts.append(torch.zeros((b, pad, d), dtype=dtype, device=images.device))
    x = torch.cat(parts, dim=1)
    pos = params["pos_embed"].to(dtype)[tok0:tok1]
    if pad:
        pos = torch.cat([pos, torch.zeros((pad, d), dtype=dtype, device=pos.device)])
    return x + pos


def _local_forward_sp(cfg: ViTConfig, mesh: Mesh, gelu_variant: str, ops_name: str):
    """-> ``forward(params, local images) -> logits`` of this rank's token
    block (the batch its ``dp`` slice)."""
    if ops_name not in ("eager", "fused_train"):
        raise ValueError(f"sp ops {ops_name!r}: use 'eager' or 'fused_train'")
    if "sp" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'sp' axis")
    n, i = mesh.shape["sp"], mesh.index("sp")
    t_local = _layout(cfg, n)
    eps, n_prefix = cfg.layernorm_eps, cfg.num_prefix_tokens

    def forward(params, images):
        valid = (torch.arange(n * t_local, device=images.device) < cfg.seq_len).reshape(
            n, t_local)
        xl = _embed_shard(params, images, cfg, i, t_local)
        if ops_name == "fused_train":
            from vit_tpu_torch.ops.trainable import LnMlpResidualFn, OutResidualFn

            b, tl, d = xl.shape
            for blk in vit.layers(params["blocks"])[: cfg.depth]:
                h = reference.layer_norm(xl, blk["ln1_scale"], blk["ln1_bias"], eps)
                q, k, v = reference.split_packed_qkv(
                    reference.linear(h, blk["wqkv"], blk["bqkv"]), cfg.num_heads)
                ctx = reference.merge_heads(_ring_attention(q, k, v, valid, mesh).to(xl.dtype))
                x2 = OutResidualFn.apply(ctx.reshape(b * tl, d), xl.reshape(b * tl, d),
                                         blk["wo"], blk["bo"])
                x3 = LnMlpResidualFn.apply(x2, blk["ln2_scale"], blk["ln2_bias"], blk["w1"],
                                           blk["b1"], blk["w2"], blk["b2"], eps, gelu_variant)
                xl = x3.reshape(b, tl, d)
        else:
            # vit.encoder_block with attention swapped for the ring
            sp_ops = dataclasses.replace(
                EAGER_OPS, name="sp",
                attention=lambda h, wqkv, bqkv, wo, bo, nh: attention_sp(
                    h, wqkv, bqkv, wo, bo, nh, valid, mesh))
            for blk in vit.layers(params["blocks"])[: cfg.depth]:
                xl = vit.encoder_block(xl, blk, cfg, sp_ops, gelu_variant)
        xl = reference.layer_norm(xl[:, :n_prefix], params["ln_final"]["scale"],
                                  params["ln_final"]["bias"], eps)
        # the prefix tokens (CLS, and the distillation token) live on shard 0
        return vit.apply_head(BroadcastFrom.apply(xl, mesh, "sp", 0), params)

    return forward


def shard_forward_sp(cfg: ViTConfig, mesh: Mesh, gelu_variant: str = "exact",
                     ops_name: str = "eager"):
    """Build ``forward(params, images) -> logits`` with the tokens split over
    ``sp`` (and the batch over ``dp`` when the mesh has it): ``params``
    whole on every rank, ``images`` the whole batch, the whole batch's
    logits out on every rank.  ``eager`` or ``fused_train`` (module
    docstring)."""
    from vit_tpu_torch.parallel.shard_forward import shard_forward_dp

    return shard_forward_dp(_local_forward_sp(cfg, mesh, gelu_variant, ops_name), mesh)


def make_sp_train_step(
    cfg: ViTConfig,
    optimizer: torch.optim.Optimizer,
    mesh: Mesh,
    gelu_variant: str = "exact",
    label_smoothing: float = 0.0,
    compute_dtype=None,
    remat: bool = True,
    ops_name: str = "eager",
    grad_clip: float = 0.0,
    guard=None,
    trained=None,
):
    """Sequence-parallel training, ``(params, local images, local labels,
    step=None) -> loss``: the counterpart of the JAX package's
    ``make_sp_train_step``.  Params and optimizer state whole on every rank;
    the gradients flow back around the ring (module docstring), the partial
    ones are summed over ``sp`` and everything averaged over ``dp``
    (``trainer._finish``), so every rank applies the same update.
    ``compute_dtype`` casts the params and images inside the loss (fp32
    masters).  ``remat`` (on by default for ``eager``) recomputes the
    forward, its ring too, in the backward; ``fused_train`` forces it off,
    its backward kernels recomputing from their stashed inputs already."""
    from vit_tpu_torch.runtime import trainer

    if ops_name == "fused_train":
        remat = False
    forward = _local_forward_sp(cfg, mesh, gelu_variant, ops_name)
    return trainer.make_train_step_dp(
        cfg, optimizer, mesh, remat=remat, compute_dtype=compute_dtype,
        label_smoothing=label_smoothing, grad_clip=grad_clip,
        forward_fn=lambda p, x, _rng: forward(p, x), guard=guard, trained=trained)
