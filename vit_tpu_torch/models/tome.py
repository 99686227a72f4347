"""ToMe-accelerated ViT forwards — counterpart of ``vit_tpu.models.tome``.

Token merging (``ops/tome.py``) shrinks the token count by a fixed
schedule, so every layer has its own T: the layer loop runs over the
per-layer views of the stacked block params with the live (B, T, D)
activation.  The forwards:

  - :func:`forward_eager`: plain PyTorch (the ``eager`` tier; the oracle
    the kernel paths are checked against), gather/scatter merge;
  - :func:`forward_fused`: K1 with its hooks (the log-size bias on the key
    logits, the mean key out) -> K4 -> merge-matrix GEMM -> K5 per layer;
  - :func:`forward_quant`: the same over int8 weights, K15 with the hooks
    -> K4 (wo stays floating point) -> merge -> K17;
  - :func:`forward_train`: the differentiable kernel path — K1's VJP with
    K6 behind it, K4/K9 and K5/K8, or with dropout the regularized K10/K12c
    and K11/K12b, the merge matrix built without gradient and the GEMM
    differentiated.

The final LayerNorm is the plain ``reference.layer_norm`` on every path,
as in the JAX package.  r = 0 merges nothing and runs each path's kernels
without hooks.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.models import vit
from vit_tpu_torch.ops import fused_block, reference, tome
from vit_tpu_torch.ops.fused_block import (
    DROP_SITE_ATTN_OUT,
    DROP_SITE_DP_ATTN,
    DROP_SITE_DP_MLP,
    DROP_SITE_MLP_INNER,
    DROP_SITE_MLP_OUT,
    drop_path_scale_rows,
    dropout_mask,
)

# Inference schedule bucketing: each group of MERGE_CHUNK layers merges its
# whole budget at the group's first layer (the JAX package's default, kept
# for parity: the same merges, layer for layer).
MERGE_CHUNK = 3
# The training default, also the JAX package's.
TRAIN_MERGE_CHUNK = 2


def schedule(cfg: ViTConfig, r: int, chunk: int = MERGE_CHUNK):
    """The default (chunked) merge schedule for a (config, r) pair."""
    p = cfg.num_prefix_tokens
    counts = tome.compress_counts(tome.merge_counts(cfg.seq_len, cfg.depth, r, p), chunk,
                                  cfg.seq_len, p)
    return tome.validate_counts(counts, cfg.seq_len, p)


def check_config(cfg: ViTConfig, r: int) -> None:
    """Validate a (config, r) pair: r >= 0, and a sequence the single-tile
    attention stage takes (``fused_block.VMEM_ATTENTION_MAX_T``, read at
    call time; past it the plain paths switch to flash attention, which has
    no merging hooks)."""
    if r < 0:
        raise ValueError(f"tome_r must be >= 0, got {r}")
    max_t = fused_block.VMEM_ATTENTION_MAX_T
    if cfg.seq_len > max_t:
        raise ValueError(
            f"ToMe supports seq_len <= {max_t} ({cfg.name} has {cfg.seq_len}); long "
            "sequences use the flash-attention path without token merging"
        )


def _embed(params, images, cfg):
    x = images.to(params["pos_embed"].dtype)
    x = reference.patch_embed(x, params["patch_embed"]["kernel"], params["patch_embed"]["bias"],
                              cfg.patch_size)
    return reference.add_cls_and_pos(x, vit.prefix_tokens(params), params["pos_embed"])


def _head(x, params, cfg, separate_heads: bool = False):
    x = reference.layer_norm(x, params["ln_final"]["scale"], params["ln_final"]["bias"],
                             cfg.layernorm_eps)
    return vit.apply_head(x, params, separate=separate_heads)


def _regularizers(x, cfg, dropout_rng):
    """The embedding-site dropout (torchvision's input + position-embedding
    site, drawn as ``vit.forward`` draws it) and one uint32 seed per layer,
    in ``vit.forward``'s order of draws from the host generator."""
    if cfg.dropout > 0:
        x = vit._dropout(x, cfg.dropout, vit.device_generator(dropout_rng, x.device))
    return x, vit.layer_seeds(dropout_rng, cfg.depth), vit._dp_rates(cfg)


def forward_eager(
    params: Dict[str, Any],
    images: torch.Tensor,
    cfg: ViTConfig,
    r: int,
    gelu_variant: str = "exact",
    counts=None,
    dropout_rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Plain-PyTorch ToMe forward: images (B, C, H, W) -> fp32 logits.

    Kept on the gather/scatter merge (``tome.merge_tokens``), so the kernel
    paths' merge-matrix GEMM is checked against other code.
    ``dropout_rng`` (a host generator) applies the regularizers with the
    kernels' hash masks from the same per-layer seeds as
    :func:`forward_train`, bit for bit — the gradient oracle of merged
    training with dropout."""
    check_config(cfg, r)
    x = _embed(params, images, cfg)
    b, _, d = x.shape
    use_reg = dropout_rng is not None
    if use_reg:
        x, seeds, rates = _regularizers(x, cfg, dropout_rng)

    def drop(h2d, seed, site):
        if cfg.dropout <= 0:
            return h2d
        return h2d * dropout_mask(seed, site, 0, tuple(h2d.shape), cfg.dropout,
                                  h2d.device).to(h2d.dtype)

    p = cfg.num_prefix_tokens
    counts = schedule(cfg, r) if counts is None else counts
    sizes = torch.ones(b, cfg.seq_len, dtype=torch.float32, device=x.device)
    merged_any = False  # sizes are all ones (bias 0) until the first merge
    for l, blk in enumerate(vit.layers(params["blocks"])[: cfg.depth]):
        h = reference.layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.layernorm_eps)
        out = reference.attention(
            h, blk["wqkv"], blk["bqkv"], blk["wo"], blk["bo"], cfg.num_heads,
            logit_bias=torch.log(sizes) if merged_any else None, return_kmean=counts[l] > 0,
        )
        attn, kmean = out if counts[l] > 0 else (out, None)
        if use_reg:
            t = x.shape[1]
            a2 = drop(attn.reshape(b * t, d), seeds[l], DROP_SITE_ATTN_OUT)
            dp_attn = drop_path_scale_rows(seeds[l], DROP_SITE_DP_ATTN, b, t, rates[l], x.device)
            attn = (a2 * dp_attn.to(a2.dtype)[:, None]).reshape(b, t, d)
        x = x + attn
        if counts[l] > 0:
            x, sizes = tome.merge_tokens(x, kmean, sizes, counts[l], p)
            merged_any = True
        h = reference.layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.layernorm_eps)
        if use_reg:
            t = x.shape[1]
            u = reference.linear(h.reshape(b * t, d), blk["w1"], blk["b1"])
            g = reference.gelu_exact(u) if gelu_variant == "exact" else reference.gelu_tanh(u)
            y = reference.linear(drop(g, seeds[l], DROP_SITE_MLP_INNER), blk["w2"], blk["b2"])
            y = drop(y, seeds[l], DROP_SITE_MLP_OUT)
            dp_mlp = drop_path_scale_rows(seeds[l], DROP_SITE_DP_MLP, b, t, rates[l], x.device)
            x = x + (y * dp_mlp.to(y.dtype)[:, None]).reshape(b, t, d)
        else:
            x = x + reference.mlp(h, blk["w1"], blk["b1"], blk["w2"], blk["b2"], gelu_variant)
    return _head(x, params, cfg)


def _merge(x, kmean, sizes, r, p):
    """The kernel paths' merge: the matrix from the layer's k-mean (no
    gradient), then the GEMM.  -> (merged x (B, T - r, D), new sizes)."""
    b, t, _ = x.shape
    with torch.no_grad():
        w, s_out = tome.merge_matrix(kmean.detach().reshape(b, t, -1), sizes, r, p)
    return tome.apply_merge_matrix(x, w, s_out), s_out


def _forward_inference(params, images, cfg, r, counts, attn_stage, mlp_stage):
    """The inference chain shared by :func:`forward_fused` and
    :func:`forward_quant`: per layer ``attn_stage(x2d, blk, t, log_size,
    return_kmean)`` -> K4 -> merge -> ``mlp_stage(x2d, blk)``."""
    from vit_tpu_torch.ops.kernels.out_residual import out_residual

    check_config(cfg, r)
    x = _embed(params, images, cfg)
    b, _, d = x.shape
    p = cfg.num_prefix_tokens
    counts = schedule(cfg, r) if counts is None else counts
    sizes = torch.ones(b, cfg.seq_len, dtype=torch.float32, device=x.device)
    merged_any = False
    for l, blk in enumerate(vit.layers(params["blocks"])[: cfg.depth]):
        t = x.shape[1]
        x2 = x.reshape(b * t, d)
        # the bias operand and the k-mean output only where they are needed
        out = attn_stage(x2, blk, t, torch.log(sizes) if merged_any else None, counts[l] > 0)
        ctx, kmean = out if counts[l] > 0 else (out, None)
        x = out_residual(ctx, x2, blk["wo"], blk["bo"]).reshape(b, t, d)
        if counts[l] > 0:
            x, sizes = _merge(x, kmean, sizes, counts[l], p)
            merged_any = True
        t = x.shape[1]
        x = mlp_stage(x.reshape(b * t, d), blk).reshape(b, t, d)
    return _head(x, params, cfg)


def forward_fused(
    params: Dict[str, Any],
    images: torch.Tensor,
    cfg: ViTConfig,
    r: int,
    gelu_variant: str = "exact",
    counts=None,
) -> torch.Tensor:
    """Kernel-path ToMe forward: K1 (LN1 + QKV + attention, the log-size
    bias on the key logits, the k-mean out) -> K4 (out_proj + residual) ->
    merge-matrix GEMM -> K5 (LN2 + MLP + residual), per layer, on the
    default chunked schedule."""
    from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual
    from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn

    eps, heads = cfg.layernorm_eps, cfg.num_heads

    def attn_stage(x2, blk, t, log_size, return_kmean):
        return ln_qkv_attn(x2, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["bqkv"], heads,
                           t, eps, log_size=log_size, return_kmean=return_kmean)

    def mlp_stage(x2, blk):
        return ln_mlp_residual(x2, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["b1"],
                               blk["w2"], blk["b2"], eps, gelu_variant)

    return _forward_inference(params, images, cfg, r, counts, attn_stage, mlp_stage)


def forward_quant(
    params: Dict[str, Any],
    images: torch.Tensor,
    cfg: ViTConfig,
    r: int,
    gelu_variant: str = "exact",
    counts=None,
) -> torch.Tensor:
    """W8A8 ToMe forward over a quantized params tree
    (``ops/quant.quantize_params``): K15 (LN1 -> int8 QKV GEMM -> attention
    with the log-size bias, the k-mean of the dequantized keys out) -> K4
    (wo stays floating point) -> merge-matrix GEMM -> K17 (LN2 -> int8
    MLP -> residual)."""
    from vit_tpu_torch.ops.kernels.ln_mlp_residual_q8 import ln_mlp_residual_q8
    from vit_tpu_torch.ops.kernels.ln_qkv_attn_q8 import ln_qkv_attn_q8

    eps, heads = cfg.layernorm_eps, cfg.num_heads

    def attn_stage(x2, blk, t, log_size, return_kmean):
        return ln_qkv_attn_q8(x2, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"],
                              blk["wqkv_scale"], blk["bqkv"], heads, t, eps, log_size=log_size,
                              return_kmean=return_kmean)

    def mlp_stage(x2, blk):
        return ln_mlp_residual_q8(x2, blk["ln2_scale"], blk["ln2_bias"], blk["w1"],
                                  blk["w1_scale"], blk["b1"], blk["w2"], blk["w2_scale"],
                                  blk["b2"], eps, gelu_variant)

    return _forward_inference(params, images, cfg, r, counts, attn_stage, mlp_stage)


def forward_train(
    params: Dict[str, Any],
    images: torch.Tensor,
    cfg: ViTConfig,
    r: int,
    gelu_variant: str = "exact",
    counts=None,
    separate_heads: bool = False,
    chunk: Optional[int] = None,
    dropout_rng: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Differentiable kernel-path ToMe forward (training with merging).

    Per layer: K1 through its VJP (``trainable.TomeLnQkvAttnFn``: K6 with
    the log-size bias and no residual join behind it); K4/K9; the merge
    matrix from the k-mean without gradient and the merge GEMM with it;
    K5/K8.  ``dropout_rng`` (a host generator) turns on the regularizers:
    the embedding-site dropout, then one seed per layer
    (``vit.layer_seeds``) from which K10/K12c and K11/K12b regenerate the
    masks — the mask rows are each layer's merged B·t_l.  With
    ``cfg.dropout == 0`` (drop-path only) the row scale composes around the
    clean kernels, y = x + s (k(x) - x), and a layer whose rate is 0 is the
    clean kernel exactly.  ``chunk`` overrides the schedule's bucketing
    (default ``TRAIN_MERGE_CHUNK``)."""
    from vit_tpu_torch.ops import trainable as TR

    check_config(cfg, r)
    x = _embed(params, images, cfg)
    b, _, d = x.shape
    p = cfg.num_prefix_tokens
    if counts is None:
        counts = schedule(cfg, r, TRAIN_MERGE_CHUNK if chunk is None else chunk)
    sizes = torch.ones(b, cfg.seq_len, dtype=torch.float32, device=x.device)
    merged_any = False
    use_reg = dropout_rng is not None
    dp_lerp = use_reg and float(cfg.dropout) == 0.0
    if use_reg:
        x, seeds, rates = _regularizers(x, cfg, dropout_rng)
    eps = cfg.layernorm_eps
    for l, blk in enumerate(vit.layers(params["blocks"])[: cfg.depth]):
        t = x.shape[1]
        x2 = x.reshape(b * t, d)
        out = TR.tome_ln_qkv_attn(x2, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["bqkv"],
                                  torch.log(sizes) if merged_any else None, cfg.num_heads, t,
                                  eps, counts[l] > 0)
        ctx, kmean = out if counts[l] > 0 else (out, None)
        attn_args = (ctx, x2, blk["wo"], blk["bo"])
        if use_reg:
            dp_attn = drop_path_scale_rows(seeds[l], DROP_SITE_DP_ATTN, b, t, rates[l], x.device)
            if dp_lerp:
                y = TR.OutResidualFn.apply(*attn_args)
                if rates[l] != 0.0:  # rate 0: exactly the clean kernel
                    y = x2 + dp_attn.to(y.dtype)[:, None] * (y - x2)
            else:
                y = TR.OutResidualTrainFn.apply(*attn_args, dp_attn, seeds[l], float(cfg.dropout))
        else:
            y = TR.OutResidualFn.apply(*attn_args)
        x = y.reshape(b, t, d)
        if counts[l] > 0:
            x, sizes = _merge(x, kmean, sizes, counts[l], p)
            merged_any = True
        t = x.shape[1]
        x2 = x.reshape(b * t, d)
        mlp_args = (x2, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["b1"], blk["w2"],
                    blk["b2"])
        if use_reg and not dp_lerp:
            dp_mlp = drop_path_scale_rows(seeds[l], DROP_SITE_DP_MLP, b, t, rates[l], x.device)
            y = TR.LnMlpResidualTrainFn.apply(*mlp_args, dp_mlp, seeds[l], float(cfg.dropout),
                                              eps, gelu_variant)
        else:
            y = TR.LnMlpResidualFn.apply(*mlp_args, eps, gelu_variant)
            if dp_lerp and rates[l] != 0.0:
                dp_mlp = drop_path_scale_rows(seeds[l], DROP_SITE_DP_MLP, b, t, rates[l],
                                              x.device)
                y = x2 + dp_mlp.to(y.dtype)[:, None] * (y - x2)
        x = y.reshape(b, t, d)
    return _head(x, params, cfg, separate_heads)
