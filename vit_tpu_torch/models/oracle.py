"""Sequential NumPy oracle — a copy of ``vit_tpu.models.oracle``, an
independent second implementation.

The reference keeps a scalar CPU forward pass (`ViT_seq`, ViT_seq.c:326-439)
as ground truth for the OpenCL path (the commented-out A/B at Main.c:48-53).
This module is its analog: a from-scratch, per-image, float64-capable NumPy
forward that shares *no code* with the torch and CUDA paths, used for
differential tests and the <1e-3 max-logit-deviation gate (BASELINE.md).
It is numpy and scipy only; ``params`` may hold the port's torch tensors
(on any device, any float dtype) or numpy arrays.

Conventions match the reference CPU path: exact-erf GELU (ViT_seq.c:232),
LayerNorm eps inside the sqrt (1e-6, ViT_seq.c:115), max-subtracted softmax
(ViT_seq.c:171-189, :304-324).
"""

from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
from scipy.special import erf as _erf  # scipy ships with the baked-in stack

from vit_tpu_torch.config import ViTConfig


def _layer_norm(x: np.ndarray, scale, bias, eps: float) -> np.ndarray:
    mean = x.mean(axis=-1, keepdims=True)
    var = x.var(axis=-1, keepdims=True)
    return (x - mean) / np.sqrt(var + eps) * scale + bias


def _gelu(x: np.ndarray) -> np.ndarray:
    return 0.5 * x * (1.0 + _erf(x / math.sqrt(2.0)))


def _softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def forward_one(
    params: Dict[str, Any], image: np.ndarray, cfg: ViTConfig, dtype=np.float64
) -> np.ndarray:
    """One image (C, H, W) -> logits (num_classes,), sequential like ViT_seq.

    ``params`` is the same pytree layout as vit_tpu_torch.models.vit
    (weights pre-transposed to [in, out]); leaves may be torch tensors or
    numpy arrays, or an already-flattened ``_np_tree`` dict (so batch
    callers convert once).
    """
    p = params if _is_np_tree(params) else _np_tree(params, dtype)
    ps = cfg.patch_size
    c, h, w = image.shape
    gh, gw = h // ps, w // ps
    img = np.asarray(image, dtype=dtype)

    # Patch embed: channel-major patch flatten (matches ViT_seq.c:36-41) + GEMM.
    x = img.reshape(c, gh, ps, gw, ps)
    x = x.transpose(1, 3, 0, 2, 4).reshape(gh * gw, c * ps * ps)
    x = x @ p["patch_embed.kernel"] + p["patch_embed.bias"]

    # Prefix token(s) + pos (ViT_seq.c:72-101); DeiT-distilled params carry
    # a second prefix token (distillation) after CLS.
    prefix = [p["cls_token"][None, :]]
    if "dist_token" in p:
        prefix.append(p["dist_token"][None, :])
    x = np.concatenate(prefix + [x], axis=0) + p["pos_embed"]

    d = cfg.embed_dim
    hd = cfg.head_dim
    for l in range(cfg.depth):
        ln1 = _layer_norm(x, p["blocks.ln1_scale"][l], p["blocks.ln1_bias"][l],
                          cfg.layernorm_eps)
        qkv = ln1 @ p["blocks.wqkv"][l] + p["blocks.bqkv"][l]
        heads = []
        for hh in range(cfg.num_heads):  # serial per-head loop, like ViT_seq.c:156
            # packed columns are (head, {q,k,v}, head_dim)-ordered (io.weights)
            base = hh * 3 * hd
            qh = qkv[:, base : base + hd]
            kh = qkv[:, base + hd : base + 2 * hd]
            vh = qkv[:, base + 2 * hd : base + 3 * hd]
            s = (qh @ kh.T) / math.sqrt(hd)
            heads.append(_softmax(s, axis=-1) @ vh)
        attn = np.concatenate(heads, axis=-1) @ p["blocks.wo"][l] + p["blocks.bo"][l]
        x = x + attn

        ln2 = _layer_norm(x, p["blocks.ln2_scale"][l], p["blocks.ln2_bias"][l],
                          cfg.layernorm_eps)
        hmid = _gelu(ln2 @ p["blocks.w1"][l] + p["blocks.b1"][l])
        x = x + (hmid @ p["blocks.w2"][l] + p["blocks.b2"][l])

    x = _layer_norm(x, p["ln_final.scale"], p["ln_final.bias"], cfg.layernorm_eps)
    logits = x[0] @ p["head.kernel"] + p["head.bias"]  # CLS row (ViT_seq.c:433)
    if "head_dist.kernel" in p:
        # DeiT: average the CLS head with the distillation-token head
        logits = 0.5 * (logits + x[1] @ p["head_dist.kernel"] + p["head_dist.bias"])
    return logits


def forward(params, images: np.ndarray, cfg: ViTConfig, dtype=np.float64) -> np.ndarray:
    """Batch (B, C, H, W) -> logits (B, num_classes); serial per image like
    the reference's outer loop (ViT_seq.c:354).

    Converts the params pytree to numpy ONCE (for ViT-B/16 at fp64 that's
    ~0.7 GB of conversion — per image would dominate a batch-100 gate)."""
    p = _np_tree(params, dtype)
    return np.stack([forward_one(p, img, cfg, dtype) for img in np.asarray(images)])


def probabilities(logits: np.ndarray) -> np.ndarray:
    return _softmax(logits, axis=-1)


def _is_np_tree(params: Dict[str, Any]) -> bool:
    """True when ``params`` is already a ``_np_tree`` output (flat dotted
    keys, no nested dicts) rather than the nested pytree."""
    return isinstance(params, dict) and not any(
        isinstance(v, dict) for v in params.values()
    )


def _np_tree(params: Dict[str, Any], dtype) -> Dict[str, np.ndarray]:
    """Flatten the nested params pytree to dotted keys as numpy arrays."""
    out = {}

    def rec(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(f"{prefix}.{k}" if prefix else k, v)
        else:
            if hasattr(node, "detach"):  # a torch tensor: to the host, widened
                node = node.detach().cpu().double().numpy()
            out[prefix] = np.asarray(node, dtype=dtype)

    rec("", params)
    return out
