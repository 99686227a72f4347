"""HuggingFace transformers ViT/DeiT state dict -> the params tree —
counterpart of ``vit_tpu.io.hf_convert``.

HF's ViT stores separate Q/K/V projections
(``attention.attention.query/key/value``) under its own key names; this
merges them into the port's packed (head, {q,k,v}, head_dim) QKV columns
and maps the rest.  HF's ViT forward matches torchvision's for the same
weights (pre-LN encoder, CLS head), so the converted tree runs on every
path of the port unchanged.  numpy in, numpy out (or torch leaves with a
torch ``dtype``); no ``transformers`` import here.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.utils.tree import cast_tree


def _np(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x.astype(np.float32)
    # a torch tensor; .float() first: .numpy() refuses bfloat16
    return x.detach().cpu().float().numpy().astype(np.float32)


def params_from_hf_state_dict(sd: Mapping[str, Any], cfg: ViTConfig,
                              dtype=np.float32) -> Dict[str, Any]:
    """HF ViT/DeiT state dict -> the params tree.

    Takes ``ViTForImageClassification`` (backbone prefix ``vit.``, head
    ``classifier``), ``DeiTForImageClassificationWithTeacher`` (prefix
    ``deit.``, heads ``cls_classifier`` + ``distillation_classifier``) and
    plain ``DeiTForImageClassification`` (``deit.`` and one ``classifier``;
    the distillation token rides along unheaded)."""
    d, hd, nh, L = cfg.embed_dim, cfg.head_dim, cfg.num_heads, cfg.depth
    mp = "deit" if any(k.startswith("deit.") for k in sd) else "vit"

    def get(key):
        if key not in sd:
            raise KeyError(f"HF state dict missing {key!r}")
        return _np(sd[key])

    # head naming: WithTeacher DeiT splits the cls/distillation classifiers
    dual_head = "cls_classifier.weight" in sd
    head_key = "cls_classifier" if dual_head else "classifier"
    has_dist = f"{mp}.embeddings.distillation_token" in sd
    if has_dist != cfg.distilled:
        raise ValueError(
            f"HF checkpoint {'has' if has_dist else 'lacks'} a distillation "
            f"token but config {cfg.name} "
            f"{'lacks' if has_dist else 'has'} distilled=True — pick the "
            f"matching --config (deit_* for DeiT checkpoints)"
        )

    # name the mismatch before a reshape turns it into "cannot reshape"
    head_w = get(f"{head_key}.weight")
    if head_w.shape != (cfg.num_classes, d):
        raise ValueError(
            f"HF classifier is {head_w.shape}, config {cfg.name} expects "
            f"({cfg.num_classes}, {d}) — pass --num-classes "
            f"{head_w.shape[0]} (and check --config)"
        )
    pos = get(f"{mp}.embeddings.position_embeddings")
    if pos.size != cfg.seq_len * d:
        raise ValueError(
            f"HF position embeddings have {pos.size // max(d, 1)} tokens, "
            f"config {cfg.name} expects {cfg.seq_len} "
            f"(image_size/patch_size mismatch — pick the matching --config)"
        )

    def pack_qkv(l):
        """Three [D, D] (torch [out, in]) -> (D, 3D) packed (head, {q,k,v},
        hd) columns; the biases likewise."""
        prefix = f"{mp}.encoder.layer.{l}.attention.attention"
        mats = [get(f"{prefix}.{n}.weight") for n in ("query", "key", "value")]
        biases = [get(f"{prefix}.{n}.bias") for n in ("query", "key", "value")]
        w = np.stack([m.T.reshape(d, nh, hd) for m in mats], axis=2)  # (D, H, 3, hd)
        b = np.stack([x.reshape(nh, hd) for x in biases], axis=1)  # (H, 3, hd)
        return w.reshape(d, 3 * d), b.reshape(3 * d)

    layer = lambda l, k: f"{mp}.encoder.layer.{l}.{k}"  # noqa: E731
    stack = lambda fn: np.stack([fn(l) for l in range(L)])  # noqa: E731
    packed = [pack_qkv(l) for l in range(L)]

    params = {
        "cls_token": get(f"{mp}.embeddings.cls_token").reshape(d),
        "patch_embed": {
            "kernel": get(f"{mp}.embeddings.patch_embeddings.projection.weight")
            .reshape(d, cfg.patch_dim).T.copy(),
            "bias": get(f"{mp}.embeddings.patch_embeddings.projection.bias"),
        },
        "pos_embed": pos.reshape(cfg.seq_len, d),
        "blocks": {
            "ln1_scale": stack(lambda l: get(layer(l, "layernorm_before.weight"))),
            "ln1_bias": stack(lambda l: get(layer(l, "layernorm_before.bias"))),
            "wqkv": np.stack([w for w, _ in packed]),
            "bqkv": np.stack([b for _, b in packed]),
            "wo": stack(lambda l: get(layer(l, "attention.output.dense.weight")).T.copy()),
            "bo": stack(lambda l: get(layer(l, "attention.output.dense.bias"))),
            "ln2_scale": stack(lambda l: get(layer(l, "layernorm_after.weight"))),
            "ln2_bias": stack(lambda l: get(layer(l, "layernorm_after.bias"))),
            "w1": stack(lambda l: get(layer(l, "intermediate.dense.weight")).T.copy()),
            "b1": stack(lambda l: get(layer(l, "intermediate.dense.bias"))),
            "w2": stack(lambda l: get(layer(l, "output.dense.weight")).T.copy()),
            "b2": stack(lambda l: get(layer(l, "output.dense.bias"))),
        },
        "ln_final": {"scale": get(f"{mp}.layernorm.weight"), "bias": get(f"{mp}.layernorm.bias")},
        "head": {"kernel": head_w.T.copy(), "bias": get(f"{head_key}.bias")},
    }
    if has_dist:
        params["dist_token"] = get(f"{mp}.embeddings.distillation_token").reshape(d)
        if dual_head:
            params["head_dist"] = {
                "kernel": get("distillation_classifier.weight").T.copy(),
                "bias": get("distillation_classifier.bias"),
            }
    return params if dtype is np.float32 else cast_tree(params, dtype)


def config_from_hf(hf_config) -> ViTConfig:
    """A transformers ViTConfig/DeiTConfig -> the port's ViTConfig."""
    distilled = getattr(hf_config, "model_type", "vit") == "deit"
    return ViTConfig(
        image_size=hf_config.image_size,
        patch_size=hf_config.patch_size,
        in_channels=hf_config.num_channels,
        num_classes=getattr(hf_config, "num_labels", 1000) or 1000,
        embed_dim=hf_config.hidden_size,
        depth=hf_config.num_hidden_layers,
        num_heads=hf_config.num_attention_heads,
        mlp_ratio=hf_config.intermediate_size / hf_config.hidden_size,
        layernorm_eps=hf_config.layer_norm_eps,
        distilled=distilled,
        name=(
            f"hf_{'deit' if distilled else 'vit'}_"
            f"{hf_config.hidden_size}_{hf_config.patch_size}"
        ),
    )
