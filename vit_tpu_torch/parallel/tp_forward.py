"""Tensor-parallel inference and training through the fused and W8A8
kernels — counterpart of ``vit_tpu.parallel.tp_forward``.

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

The fp path is trainable, as the JAX package's is through its custom VJPs:
``LnMlpPartialFn`` pairs K5's partial form with K8 ``residual=False``, and
``trainable.TomeLnQkvAttnFn`` (no hooks) pairs K1 with K6 ``dres=None``.
``shard_map``'s transpose places the sums over ``tp`` for JAX; here they
are placed by hand.  Each rank's K6 and K8 give a *partial* dx (from its
own heads or hidden columns), so the activation entering K1 and K5 takes
an all-reduce SUM over ``tp`` in the backward (``_CopyToTP``: identity
forward), and the two row-parallel exits are an all-reduce forward and the
identity backward (``_SumOverTP``).  The LayerNorm scales and biases get
partial gradients the same way; the step sums them over ``tp`` once, after
the backward (``sharding.TP_PARTIAL_GRADS``).  bo, b2, the embeddings, the
final LayerNorm and the head are computed after the sums, identically on
every rank: their gradients are whole and are not summed.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.ops import fused_block
from vit_tpu_torch.ops import reference
from vit_tpu_torch.parallel.mesh import Mesh


class _CopyToTP(torch.autograd.Function):
    """The identity forward; the gradient summed over ``tp`` backward (the
    input of a column-parallel kernel, whose VJP is this rank's part)."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.clone(memory_format=torch.contiguous_format), "tp"), None


class _SumOverTP(torch.autograd.Function):
    """An all-reduce SUM over ``tp`` in place forward; the identity backward
    (a row-parallel exit: every rank's partial, completed)."""

    @staticmethod
    def forward(ctx, part, mesh):
        ctx.mark_dirty(part)
        return mesh.all_reduce(part, "tp")

    @staticmethod
    def backward(ctx, g):
        return g, None


class LnMlpPartialFn(torch.autograd.Function):
    """(x1, ln_scale, ln_bias, w1, b1, w2, eps, gelu_variant) -> this rank's
    fp32 MLP partial, no b2 and no residual: K5 ``partial=True`` forward, K8
    ``residual=False`` backward (``_ln_mlp_partial_diff`` and ``_lmp_bwd``
    in the JAX package).  K8's db2 is dropped: b2 is added after the sum.
    Each gradient in its input's dtype."""

    @staticmethod
    def forward(ctx, x1, s, b, w1, b1, w2, eps, gelu_variant):
        from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual

        ctx.save_for_backward(x1, s, b, w1, b1, w2)
        ctx.block_args = (eps, gelu_variant)
        return ln_mlp_residual(x1, s, b, w1, b1, w2, None, eps, gelu_variant, partial=True)

    @staticmethod
    def backward(ctx, g):
        from vit_tpu_torch.ops.kernels.ln_mlp_residual_bwd import ln_mlp_residual_bwd

        x1, *params = ctx.saved_tensors
        s, b, w1, b1, w2 = params
        dx1, *grads, _db2 = ln_mlp_residual_bwd(g.to(x1.dtype).contiguous(), x1, s, b, w1, b1,
                                                w2, *ctx.block_args, residual=False)
        return (dx1, *(d.to(p.dtype) for d, p in zip(grads, params)), None, None)


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
    docstring); differentiable on the fp path.  The switch to the
    long-sequence context is read at call time."""
    from vit_tpu_torch.ops.trainable import TomeLnQkvAttnFn

    dtype = x2d.dtype
    x_in = x2d if quant else _CopyToTP.apply(x2d, mesh)
    if seq_len > fused_block.VMEM_ATTENTION_MAX_T:
        ctx = _ctx_long_seq_tp(x_in, blk, heads_local, seq_len, eps, quant)
    elif quant:
        from vit_tpu_torch.ops.kernels.ln_qkv_attn_q8 import ln_qkv_attn_q8

        ctx = ln_qkv_attn_q8(x2d, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
                             blk["wqkv_scale"], blk["bqkv"], heads_local, seq_len, eps)
    else:
        ctx = TomeLnQkvAttnFn.apply(x_in, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
                                    blk["bqkv"], None, heads_local, seq_len, eps, False)
    # row-parallel out_proj: fp32 partial -> sum over tp -> bias + residual
    part = _SumOverTP.apply(torch.matmul(ctx.float(), blk["wo"].float()), mesh)
    x2d = (part + blk["bo"].float() + x2d.float()).to(dtype)
    if quant:
        return _mlp_q8_tp(x2d, blk, eps, gelu_variant, mesh)
    part2 = LnMlpPartialFn.apply(_CopyToTP.apply(x2d, mesh), blk["ln2_scale"], blk["ln2_bias"],
                                 blk["w1"], blk["b1"], blk["w2"], eps, gelu_variant)
    part2 = _SumOverTP.apply(part2, mesh)
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
                   quant: bool, mesh: Mesh, return_features: bool = False,
                   train: bool = False) -> torch.Tensor:
    """This rank's forward: whole embeddings and head, tensor-parallel
    encoder blocks (``models/vit.forward``'s fused branch).  ``train`` runs
    the final LayerNorm in plain differentiable torch (K3 has no backward),
    as the JAX package's ``_local_forward`` does."""
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

    x = (reference.layer_norm if train else layer_norm)(
        x2.reshape(b, t, d), params["ln_final"]["scale"], params["ln_final"]["bias"],
        cfg.layernorm_eps)
    if return_features:
        return x[..., 0, :].float()
    return vit.apply_head(x, params)


def _check_tp(cfg: ViTConfig, mesh: Mesh) -> int:
    """-> tp, after the JAX package's checks of the mesh and the widths."""
    if "tp" not in mesh.axis_names:
        raise ValueError(f"mesh {mesh.axis_names} has no 'tp' axis")
    tp = mesh.shape["tp"]
    if cfg.num_heads % tp:
        raise ValueError(f"tp={tp} must divide num_heads={cfg.num_heads}")
    if cfg.mlp_dim % tp:
        raise ValueError(f"tp={tp} must divide mlp_dim={cfg.mlp_dim}")
    return tp


def train_forward_tp(cfg: ViTConfig, mesh: Mesh, gelu_variant: str = "exact"):
    """-> ``forward(local_params, local_images) -> local logits``, the
    differentiable ``fused`` path over a (dp x) tp mesh: this rank's shard
    of the weights (``sharding.shard_params``) and its own slice of the
    batch (the trainer averages over ``dp``).  The counterpart of the
    forward that ``jit_train_step_kernel_tp`` differentiates."""
    heads_local = cfg.num_heads // _check_tp(cfg, mesh)

    def forward(params, images):
        return _local_forward(params, images, cfg, heads_local, gelu_variant, False, mesh,
                              train=True)

    return forward


def shard_forward_tp(cfg: ViTConfig, mesh: Mesh, ops_name: str, gelu_variant: str = "exact",
                     return_features: bool = False, split_dp: bool = True):
    """-> ``forward(local_params, images)`` running the ``fused`` or
    ``quant`` kernel path over a (dp x) tp mesh: ``local_params`` this
    rank's shard (``sharding.shard_params``), ``images`` the whole batch on
    every rank (it splits over ``dp``), the logits (or features) of the
    whole batch out on every rank.  ``split_dp=False``: ``images`` are this
    rank's dp slice already, and its logits come out (the tp group's
    all-reduces only)."""
    from vit_tpu_torch.parallel.shard_forward import shard_forward_dp

    tp = _check_tp(cfg, mesh)
    if ops_name not in ("fused", "quant"):
        raise ValueError(f"shard_forward_tp supports ops 'fused'/'quant', got {ops_name!r}")
    heads_local, quant = cfg.num_heads // tp, ops_name == "quant"

    def local_fn(p, x):
        return _local_forward(p, x, cfg, heads_local, gelu_variant, quant, mesh,
                              return_features=return_features)

    return shard_forward_dp(local_fn, mesh) if split_dp else local_fn
