"""Functional ViT forward on a params dict, and its initializer.

Counterpart of ``vit_tpu.models.vit``.  The params dict has the JAX
package's tree and names exactly (see that module's docstring): weights
[in, out], encoder layers stacked on a leading L axis under ``blocks``,
packed QKV in (head, {q,k,v}, head_dim) column order.  ``lax.scan`` over
the stacked layers becomes a Python loop over ``unbind`` views of the
stacked tensors, whose backward stacks the per-layer gradients back.

The dropout and drop-path hooks and the attention probe wait for their
slices of the port.
"""

from __future__ import annotations

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
) -> torch.Tensor:
    """One pre-LN encoder block: LN1 -> MHA -> residual; LN2 -> MLP ->
    residual."""
    h = ops.layer_norm(x, blk["ln1_scale"], blk["ln1_bias"], cfg.layernorm_eps)
    x = x + ops.attention(
        h, blk["wqkv"], blk["bqkv"], blk["wo"], blk["bo"], cfg.num_heads
    )
    h = ops.layer_norm(x, blk["ln2_scale"], blk["ln2_bias"], cfg.layernorm_eps)
    return x + ops.mlp(
        h, blk["w1"], blk["b1"], blk["w2"], blk["b2"], gelu_variant=gelu_variant
    )


def layers(blocks: Dict[str, torch.Tensor]):
    """Every layer's slice of the stacked block params, as views that
    autograd joins back into one stacked gradient per leaf."""
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
    is (``eager``, ``fused_train``).  ``dropout_rng`` (training dropout and
    drop-path) is not ported yet and raises."""
    if dropout_rng is not None:
        raise NotImplementedError(
            "dropout/drop-path (dropout_rng) is not ported yet: the JAX "
            "package runs it in the regularized kernels K10-K12 of "
            "ROADMAP.md queue 1 item 8"
        )
    x = images.to(params["pos_embed"].dtype)
    x = ops.patch_embed(
        x, params["patch_embed"]["kernel"], params["patch_embed"]["bias"],
        cfg.patch_size,
    )
    x = reference.add_cls_and_pos(x, prefix_tokens(params), params["pos_embed"])

    per_layer = layers(params["blocks"])
    if ops.encoder_block is not None:
        # fused path: one flat (B*T, D) activation through every layer
        *lead, t, d = x.shape
        x2 = x.reshape(-1, d)
        for blk in per_layer[: cfg.depth]:
            x2 = ops.encoder_block(
                x2, blk, cfg.num_heads, t, cfg.layernorm_eps, gelu_variant,
            )
        x = x2.reshape(*lead, t, d)
    else:
        for blk in per_layer[: cfg.depth]:
            x = encoder_block(x, blk, cfg, ops, gelu_variant)

    x = ops.layer_norm(
        x, params["ln_final"]["scale"], params["ln_final"]["bias"], cfg.layernorm_eps
    )
    if return_features:
        return x[..., 0, :].float()
    return apply_head(x, params, separate=separate_heads)


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
