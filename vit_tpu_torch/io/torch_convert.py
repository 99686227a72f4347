"""torchvision state dict <-> the reference layout and the params tree —
counterpart of ``vit_tpu.io.torch_convert``.

The reference's ``Weight_{idx}_{name}.bin`` files are a torchvision
``vit_*`` state dict exported tensor by tensor (each file name is a
state-dict key with its dots replaced by underscores).  Inbound: a state
dict (or a ``.pth`` file) -> the indexed tensors in the reference's layout
(``export_reference_bins`` writes the same files the reference's export
does) or straight to the params tree.  Outbound: the params tree -> a
state dict in torchvision's own shapes (``save_pth``).  Everything in
between is numpy, fp32.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np

from vit_tpu_torch.config import VIT_B_16, ViTConfig
from vit_tpu_torch.io import weights as wio


def _to_numpy(x) -> np.ndarray:
    if isinstance(x, np.ndarray):
        return x.astype(np.float32)
    # a torch tensor; .float() first: .numpy() refuses bfloat16
    return x.detach().cpu().float().numpy().astype(np.float32)


def state_dict_key(name: str) -> str:
    """Reference file-name fragment -> torchvision state-dict key, e.g.
    ``encoder_layers_encoder_layer_3_mlp_0_weight`` ->
    ``encoder.layers.encoder_layer_3.mlp.0.weight``."""
    for old, new in (
        ("encoder_layers_encoder_layer_", "encoder.layers.encoder_layer_"),
        ("_ln_1_", ".ln_1."),
        ("_ln_2_", ".ln_2."),
        ("_self_attention_in_proj_", ".self_attention.in_proj_"),
        ("_self_attention_out_proj_", ".self_attention.out_proj."),
        ("_mlp_0_", ".mlp.0."),
        ("_mlp_3_", ".mlp.3."),
        ("encoder_pos_embedding", "encoder.pos_embedding"),
        ("encoder_ln_weight", "encoder.ln.weight"),
        ("encoder_ln_bias", "encoder.ln.bias"),
        ("conv_proj_weight", "conv_proj.weight"),
        ("conv_proj_bias", "conv_proj.bias"),
        ("heads_head_weight", "heads.head.weight"),
        ("heads_head_bias", "heads.head.bias"),
    ):
        name = name.replace(old, new)
    return name


def tensors_from_state_dict(state_dict: Mapping[str, Any],
                            cfg: ViTConfig = VIT_B_16) -> Dict[int, np.ndarray]:
    """torchvision state dict -> {index: tensor} in the reference layout."""
    if cfg.distilled:
        raise ValueError(
            f"config {cfg.name} is DeiT-distilled; torchvision's vit_* state "
            "dicts have no distillation token — use the HF DeiT converter "
            "(io.hf_convert) or .npz/Orbax checkpoints"
        )
    out: Dict[int, np.ndarray] = {}
    for idx, name, shape in wio.reference_tensor_specs(cfg):
        key = state_dict_key(name)
        if key not in state_dict:
            raise KeyError(f"state dict missing {key!r} (for Weight_{idx}_{name})")
        out[idx] = _to_numpy(state_dict[key]).reshape(shape)
    return out


def params_from_state_dict(state_dict: Mapping[str, Any], cfg: ViTConfig = VIT_B_16,
                           round_to_6dp: bool = False, dtype=np.float32):
    """torchvision state dict -> the params tree, optionally with the
    reference loader's 6-decimal rounding (pipeline parity)."""
    tensors = tensors_from_state_dict(state_dict, cfg)
    if round_to_6dp:
        tensors = {i: wio.round6(t) for i, t in tensors.items()}
    return wio.params_from_tensors(tensors, cfg, dtype)


def load_pth(path, cfg: ViTConfig = VIT_B_16, **kw):
    """A torchvision .pth checkpoint (tensors only) -> the params tree."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return params_from_state_dict(sd, cfg, **kw)


def export_reference_bins(state_dict, out_dir, cfg: ViTConfig = VIT_B_16) -> None:
    """Write the Weight_{idx}_{name}.bin files the reference's export of the
    same checkpoint writes."""
    wio.save_reference_weights(tensors_from_state_dict(state_dict, cfg), out_dir, cfg)


def state_dict_from_params(params, cfg: ViTConfig = VIT_B_16) -> Dict[str, np.ndarray]:
    """Inverse of :func:`params_from_state_dict`: the params tree (numpy or
    torch leaves) -> torchvision state-dict arrays in torchvision's shapes:
    class_token (1, 1, D), encoder.pos_embedding (1, T, D), everything else
    the reference tensors' shapes, which are the state dict's."""
    tensors = wio.tensors_from_params(params, cfg)
    out: Dict[str, np.ndarray] = {}
    for idx, name, _shape in wio.reference_tensor_specs(cfg):
        arr = np.asarray(tensors[idx], np.float32)
        if name == "class_token":
            arr = arr.reshape(1, 1, -1)
        elif name == "encoder_pos_embedding":
            arr = arr.reshape(1, cfg.seq_len, cfg.embed_dim)
        out[state_dict_key(name)] = arr
    return out


def save_pth(params, path, cfg: ViTConfig = VIT_B_16) -> None:
    """The params tree as a torchvision-loadable .pth state dict
    (``torch.save`` of {key: fp32 tensor}): the outbound half of the .pth
    interop, :func:`load_pth` the inbound."""
    import torch

    sd = {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
          for k, v in state_dict_from_params(params, cfg).items()}
    torch.save(sd, path)
