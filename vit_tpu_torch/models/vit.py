"""Functional ViT forward on a params dict, and its initializer.

Counterpart of ``vit_tpu.models.vit``.  The params dict has the JAX
package's tree and names exactly (see that module's docstring): weights
[in, out], encoder layers stacked on a leading L axis under ``blocks``,
packed QKV in (head, {q,k,v}, head_dim) column order.  ``lax.scan`` over
the stacked layers becomes a Python loop over ``unbind`` views of the
stacked tensors, whose backward stacks the per-layer gradients back.

``attention_maps`` and ``attention_rollout`` are the interpretability probe:
each layer's softmax rows through the plain reference ops, and the
CLS->patch relevance composed from them (Abnar & Zuidema 2020).
"""

from __future__ import annotations

import abc
from typing import Any, Dict, Optional

import torch
from torch import nn

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.ops import reference
from vit_tpu_torch.ops.dispatch import EAGER_OPS, OpsImpl

Params = Dict[str, Any]


def prefix_tokens(params: Params) -> torch.Tensor:
    """(D,) CLS alone, or the (2, D) [CLS, distillation] stack for
    DeiT-distilled params."""
    dist = params.get("dist_token")
    if dist is None:
        return params["cls_token"]
    return torch.stack([params["cls_token"], dist])


def apply_head(x: torch.Tensor, params: Params, separate: bool = False):
    """Final-LN activations (..., T, D) -> fp32 logits (..., num_classes).

    The CLS row goes through the classifier; DeiT-distilled params also run
    the distillation token (row 1) through its own head and average the
    two.  ``separate`` returns the (cls_logits, dist_logits) pair."""
    logits = reference.linear(
        x[..., 0, :], params["head"]["kernel"], params["head"]["bias"]
    ).float()
    dist_head = params.get("head_dist")
    if dist_head is None:
        if separate:
            raise ValueError(
                "separate head logits need DeiT-distilled params (head_dist)"
            )
        return logits
    dist_logits = reference.linear(
        x[..., 1, :], dist_head["kernel"], dist_head["bias"]
    ).float()
    if separate:
        return logits, dist_logits
    return (logits + dist_logits) * 0.5


def encoder_block(
    x: torch.Tensor,
    blk: Dict[str, torch.Tensor],
    cfg: ViTConfig,
    ops: OpsImpl = EAGER_OPS,
    gelu_variant: str = "exact",
    dropout_rng: Optional[torch.Generator] = None,
    drop_path_rate: float = 0.0,
) -> torch.Tensor:
    """One pre-LN encoder block: LN1 -> MHA -> residual; LN2 -> MLP ->
    residual.

    ``dropout_rng`` (a generator on x's device), when given, applies
    cfg.dropout at torchvision's three in-block sites — after the attention
    out_proj, between the MLP's GELU and FC2 (``ops.mlp``'s
    ``inner_dropout``), after FC2 — and, when cfg.drop_path > 0, stochastic
    depth at ``drop_path_rate`` on both residual branches."""
    use_rng = dropout_rng is not None
    drop = use_rng and cfg.dropout > 0
    h = ops.layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.layernorm_eps)
    h = ops.attention(h, blk["wqkv"], blk["bqkv"], blk["wo"], blk["bo"], cfg.num_heads)
    if drop:
        h = _dropout(h, cfg.dropout, dropout_rng)
    if use_rng and cfg.drop_path > 0:
        h = _drop_path(h, drop_path_rate, dropout_rng)
    x = x + h
    h = ops.layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.layernorm_eps)
    mlp_kw = {"inner_dropout": (dropout_rng, cfg.dropout)} if drop else {}
    h = ops.mlp(h, blk["w1"], blk["b1"], blk["w2"], blk["b2"], gelu_variant=gelu_variant,
                **mlp_kw)
    if drop:
        h = _dropout(h, cfg.dropout, dropout_rng)
    if use_rng and cfg.drop_path > 0:
        h = _drop_path(h, drop_path_rate, dropout_rng)
    return x + h


def _dp_rates(cfg: ViTConfig):
    """Per-layer stochastic-depth rates, linear from 0 at the first block to
    cfg.drop_path at the last (the standard schedule)."""
    if cfg.depth == 1:
        return [float(cfg.drop_path)]
    return [cfg.drop_path * l / (cfg.depth - 1) for l in range(cfg.depth)]


_dropout = reference.dropout


def _drop_path(x: torch.Tensor, rate: float, gen: torch.Generator) -> torch.Tensor:
    """Stochastic depth: drop the whole residual branch per sample (leading
    axis), rescaling survivors by 1/(1 - rate)."""
    keep = torch.rand((x.shape[0],) + (1,) * (x.dim() - 1), generator=gen,
                      device=x.device) >= rate
    xf = x.float()
    return torch.where(keep, xf / (1.0 - rate), torch.zeros((), device=x.device)).to(x.dtype)


def device_generator(gen: torch.Generator, device) -> torch.Generator:
    """A generator on ``device`` seeded from one draw of the host generator
    ``gen`` (a CUDA tensor cannot draw from a CPU generator)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=gen))
    return torch.Generator(device=device).manual_seed(seed)


def layer_seeds(gen: torch.Generator, depth: int):
    """One uint32 seed per layer for the regularized kernels, drawn on the
    host from ``gen`` (a kernel launch argument: no device sync)."""
    return [int(s) for s in torch.randint(0, 2 ** 32, (depth,), generator=gen)]


class LayeredBlocks(abc.ABC):
    """A stacked ``blocks`` subtree that hands out its layers itself
    (``layers()``), where they are not slices of whole tensors: FSDP's
    gathered view (``parallel/sharding.DpShards.view``)."""

    @abc.abstractmethod
    def layers(self) -> list:
        """Every layer's mapping of block params, in order."""


def layers(blocks):
    """Every layer's slice of the stacked block params, as views that
    autograd joins back into one stacked gradient per leaf (a
    :class:`LayeredBlocks` hands out its own)."""
    if isinstance(blocks, LayeredBlocks):
        return blocks.layers()
    keys = list(blocks)
    return [dict(zip(keys, vals)) for vals in zip(*(blocks[k].unbind(0) for k in keys))]


def forward(
    params: Params,
    images: torch.Tensor,
    cfg: ViTConfig,
    ops: OpsImpl = EAGER_OPS,
    gelu_variant: str = "exact",
    return_features: bool = False,
    separate_heads: bool = False,
    dropout_rng: Optional[Any] = None,
):
    """images (B, C, H, W) -> fp32 logits (B, num_classes), or the final-LN
    CLS embedding (B, D) when ``return_features``, or the (cls, dist) logit
    pair when ``separate_heads`` (DeiT params only).

    patch-embed -> prefix tokens + pos -> depth x encoder block -> final
    LN -> head on the CLS row.  Softmax is left to the caller
    (``reference.softmax``).  Differentiable on every op table whose block
    is (``eager``, ``fused_train``).

    ``dropout_rng`` (a host ``torch.Generator``) turns on training-mode
    dropout at torchvision's four sites (input + position embedding here,
    in plain torch; the three in-block sites) and stochastic depth on the
    linear schedule (``_dp_rates``).  On ``eager`` the blocks draw their
    masks from device generators seeded from it; on ``fused_train`` one
    uint32 seed per layer (``layer_seeds``) goes to the regularized kernels,
    which regenerate the masks.  ``fused`` has no regularized kernels and
    raises."""
    if dropout_rng is not None and ops.encoder_block is not None \
            and ops.encoder_block_train is None:
        raise ValueError(
            f"dropout/drop-path on ops={ops.name!r} has no kernel hooks — use "
            "ops='fused_train' (in-kernel regularizers) or 'eager'"
        )
    x = images.to(params["pos_embed"].dtype)
    x = ops.patch_embed(
        x, params["patch_embed"]["kernel"], params["patch_embed"]["bias"],
        cfg.patch_size,
    )
    x = reference.add_cls_and_pos(x, prefix_tokens(params), params["pos_embed"])
    if dropout_rng is not None and cfg.dropout > 0:
        # torchvision's Encoder drops input + pos_embedding before block 0
        x = _dropout(x, cfg.dropout, device_generator(dropout_rng, x.device))

    per_layer = layers(params["blocks"])[: cfg.depth]
    if ops.encoder_block is not None:
        # fused path: one flat (B*T, D) activation through every layer
        *lead, t, d = x.shape
        x2 = x.reshape(-1, d)
        if dropout_rng is not None:
            seeds = layer_seeds(dropout_rng, cfg.depth)
            for blk, seed, rate in zip(per_layer, seeds, _dp_rates(cfg)):
                x2 = ops.encoder_block_train(
                    x2, blk, cfg.num_heads, t, cfg.layernorm_eps, gelu_variant,
                    seed, cfg.dropout, rate,
                )
        else:
            for blk in per_layer:
                x2 = ops.encoder_block(
                    x2, blk, cfg.num_heads, t, cfg.layernorm_eps, gelu_variant,
                )
        x = x2.reshape(*lead, t, d)
    elif dropout_rng is not None:
        for blk, rate in zip(per_layer, _dp_rates(cfg)):
            x = encoder_block(x, blk, cfg, ops, gelu_variant,
                              device_generator(dropout_rng, x.device), rate)
    else:
        for blk in per_layer:
            x = encoder_block(x, blk, cfg, ops, gelu_variant)

    x = ops.layer_norm(
        x, params["ln_final"]["scale"], params["ln_final"]["bias"], cfg.layernorm_eps
    )
    if return_features:
        return x[..., 0, :].float()
    return apply_head(x, params, separate=separate_heads)


def attention_maps(
    params: Params, images: torch.Tensor, cfg: ViTConfig, gelu_variant: str = "exact"
) -> torch.Tensor:
    """Interpretability probe: (B, C, H, W) -> per-layer attention
    probabilities (depth, B, H, T, T), fp32 (fp64 for fp64 params).

    Runs the plain reference ops, not the kernels (an oracle-grade tool, not
    a throughput path), and stacks each layer's softmax rows."""
    x = images.to(params["pos_embed"].dtype)
    x = reference.patch_embed(
        x, params["patch_embed"]["kernel"], params["patch_embed"]["bias"], cfg.patch_size
    )
    x = reference.add_cls_and_pos(x, prefix_tokens(params), params["pos_embed"])
    maps = []
    for blk in layers(params["blocks"]):
        h = reference.layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.layernorm_eps)
        h, probs = reference.attention(h, blk["wqkv"], blk["bqkv"], blk["wo"], blk["bo"],
                                       cfg.num_heads, return_probs=True)
        x = x + h
        h = reference.layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.layernorm_eps)
        x = x + reference.mlp(h, blk["w1"], blk["b1"], blk["w2"], blk["b2"], gelu_variant)
        maps.append(probs)
    return torch.stack(maps)


def attention_rollout(probs: torch.Tensor, num_prefix_tokens: int = 1) -> torch.Tensor:
    """Attention rollout (Abnar & Zuidema 2020): per-layer probabilities
    (depth, B, H, T, T) -> CLS->patch relevance (B, T - num_prefix_tokens).

    Heads average, each layer mixes with the identity (residual flow) and
    renormalizes, layers compose by matrix product; the CLS row restricted
    to the patch columns (the prefix tokens dropped: CLS, and DeiT's
    distillation token) is the input-patch relevance map.

    Only that row of the product A_L ... A_1 is kept, so it is composed as a
    row vector through the layers, last to first, each step an elementwise
    product and a sum in the probabilities' dtype: true fp32, which no
    ``torch.set_float32_matmul_precision`` setting (TF32) reaches."""
    a = probs.mean(dim=2)  # (depth, B, T, T)
    t = a.shape[-1]
    a = 0.5 * a + 0.5 * torch.eye(t, dtype=a.dtype, device=a.device)
    a = a / a.sum(dim=-1, keepdim=True)
    row = torch.zeros(a.shape[1:-1], dtype=a.dtype, device=a.device)  # (B, T)
    row[:, 0] = 1.0
    for layer in a.flip(0):
        row = (row[..., :, None] * layer).sum(dim=-2)
    return row[:, num_prefix_tokens:]


def logits_fn(cfg: ViTConfig, ops: OpsImpl = EAGER_OPS, **kw):
    """Convenience closure: (params, images) -> logits."""

    def fn(params, images):
        return forward(params, images, cfg, ops, **kw)

    return fn


def cast_params(params: Params, dtype: torch.dtype) -> Params:
    """Cast every floating-point leaf to ``dtype``; others pass through."""
    return {
        k: cast_params(v, dtype)
        if isinstance(v, dict)
        else (v.to(dtype) if v.is_floating_point() else v)
        for k, v in params.items()
    }


def _trunc(gen: torch.Generator, shape, fan_in: int, dtype) -> torch.Tensor:
    """Normal truncated to [-2, 2] standard deviations, scaled by
    1/sqrt(fan_in) (``vit_tpu.models.vit.init_params``'s ``trunc``)."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (t * (1.0 / max(fan_in, 1)) ** 0.5).to(dtype)


def init_params(gen: torch.Generator, cfg: ViTConfig, dtype=torch.float32) -> Params:
    """Random-init a params dict with the JAX package's shapes, scales and
    truncation (``vit_tpu.models.vit.init_params``), drawn from ``gen`` on
    the CPU.  The draws cannot match ``jax.random``'s bit for bit; parity
    tests carry the JAX package's params across instead."""
    d, f, t, p, c = cfg.embed_dim, cfg.mlp_dim, cfg.seq_len, cfg.patch_dim, cfg.num_classes
    L = cfg.depth
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype)  # noqa: E731
    ones = lambda *shape: torch.ones(shape, dtype=dtype)  # noqa: E731
    out = {
        "cls_token": zeros(d),
        "patch_embed": {"kernel": _trunc(gen, (p, d), p, dtype), "bias": zeros(d)},
        "pos_embed": (torch.randn((t, d), generator=gen) * 0.02).to(dtype),
        "blocks": {
            "ln1_scale": ones(L, d),
            "ln1_bias": zeros(L, d),
            "wqkv": _trunc(gen, (L, d, 3 * d), d, dtype),
            "bqkv": zeros(L, 3 * d),
            "wo": _trunc(gen, (L, d, d), d, dtype),
            "bo": zeros(L, d),
            "ln2_scale": ones(L, d),
            "ln2_bias": zeros(L, d),
            "w1": _trunc(gen, (L, d, f), d, dtype),
            "b1": zeros(L, f),
            "w2": _trunc(gen, (L, f, d), f, dtype),
            "b2": zeros(L, d),
        },
        "ln_final": {"scale": ones(d), "bias": zeros(d)},
        "head": init_head(gen, cfg, dtype),
    }
    if cfg.distilled:
        # DeiT: distillation token (like CLS, zero-init) + its own head
        out["dist_token"] = zeros(d)
        out["head_dist"] = init_head(gen, cfg, dtype)
    return out


def init_head(gen: torch.Generator, cfg: ViTConfig, dtype=torch.float32) -> Params:
    """Fresh classification head only (``init_params``'s head rule), for
    transfer learning over a loaded backbone."""
    d, c = cfg.embed_dim, cfg.num_classes
    return {"kernel": _trunc(gen, (d, c), d, dtype), "bias": torch.zeros(c, dtype=dtype)}


def num_params(params: Params) -> int:
    return sum(v.numel() if not isinstance(v, dict) else num_params(v) for v in params.values())


class _Tree(nn.Module):
    """A params dict as a module: sub-dicts become child modules and leaves
    frozen parameters, so ``state_dict`` keys are the JAX tree's paths
    (``blocks.wqkv``, ``head.kernel``, ...)."""

    def __init__(self, tree: Params):
        super().__init__()
        for key, value in tree.items():
            if isinstance(value, dict):
                self.add_module(key, _Tree(value))
            else:
                self.register_parameter(key, nn.Parameter(value, requires_grad=False))

    def as_dict(self) -> Params:
        out: Params = dict(self._parameters)
        for key, child in self._modules.items():
            out[key] = child.as_dict()
        return out


class ViT(nn.Module):
    """ViT classifier holding its params under the JAX tree's names.

    ``ViT(cfg, params, ops=get_ops("fused"))(images)`` runs :func:`forward`
    on the module's own tensors; ``.to(device)`` moves them."""

    def __init__(
        self,
        cfg: ViTConfig,
        params: Params,
        ops: OpsImpl = EAGER_OPS,
        gelu_variant: str = "exact",
    ):
        super().__init__()
        self.cfg = cfg
        self.ops = ops
        self.gelu_variant = gelu_variant
        self.params = _Tree(params)

    def forward(self, images: torch.Tensor, return_features: bool = False):
        return forward(
            self.params.as_dict(), images, self.cfg, self.ops,
            self.gelu_variant, return_features=return_features,
        )
