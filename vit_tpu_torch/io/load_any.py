"""One weight-source resolver for the CLIs — counterpart of
``vit_tpu.io.load_any``, dispatched on what the path is:

  - a directory holding ``Weight_*.bin``  -> ``io.weights`` (6-decimal
    rounding parity, synthetic fill for stripped blobs)
  - ``*.npz``                             -> ``io.checkpoint`` (params, or
    the params of a train-state archive)
  - ``*.pth`` / ``*.pt``                  -> a torchvision state dict,
    repacked through ``io.weights.params_from_tensors``
  - any other directory                   -> an Orbax checkpoint, which
    restores through JAX: refused
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np

from vit_tpu_torch.config import VIT_B_16, ViTConfig
from vit_tpu_torch.io import weights as wio


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


def params_from_state_dict(state_dict: Mapping[str, Any], cfg: ViTConfig = VIT_B_16,
                           round_to_6dp: bool = False):
    """torchvision ``vit_*`` state dict -> the params tree (fp32 numpy)."""
    if cfg.distilled:
        raise ValueError(
            f"config {cfg.name} is DeiT-distilled; torchvision's vit_* state dicts "
            "have no distillation token — load from .npz instead"
        )
    tensors: Dict[int, np.ndarray] = {}
    for idx, name, shape in wio.reference_tensor_specs(cfg):
        key = state_dict_key(name)
        if key not in state_dict:
            raise KeyError(f"state dict missing {key!r} (for Weight_{idx}_{name})")
        v = state_dict[key]
        a = v if isinstance(v, np.ndarray) else v.detach().cpu().float().numpy()
        tensors[idx] = a.astype(np.float32).reshape(shape)
    if round_to_6dp:
        tensors = {i: wio.round6(t) for i, t in tensors.items()}
    return wio.params_from_tensors(tensors, cfg)


def load_pth(path, cfg: ViTConfig = VIT_B_16, **kw):
    """A torchvision .pth checkpoint (tensors only) -> the params tree."""
    import torch

    sd = torch.load(path, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return params_from_state_dict(sd, cfg, **kw)


def load_params_any(source, cfg: ViTConfig = VIT_B_16, round_to_6dp: bool = True,
                    allow_synth: bool = False):
    """Resolve ``source`` (see the module docstring) to a params tree of
    numpy arrays.  ``round_to_6dp`` and ``allow_synth`` apply to Weight_*.bin
    directories, as in the JAX package (a .pth loads unrounded)."""
    p = Path(source)
    if p.is_dir():
        if not any(p.glob("Weight_*.bin")):
            raise ValueError(
                f"{source}: a directory with no Weight_*.bin is an Orbax checkpoint, "
                "which restores through JAX; convert it first (vit-tpu-convert) "
                "to .npz or Weight_*.bin"
            )
        _check_native_checkpoint(cfg, source)
        return wio.load_reference_weights(p, cfg, round_to_6dp=round_to_6dp,
                                          allow_synth=allow_synth)
    suffix = p.suffix.lower()
    if suffix == ".npz":
        from vit_tpu_torch.io import checkpoint as ckpt

        tree = ckpt.load_params_from_state(p) if ckpt.is_train_state(p) else ckpt.load_npz(p)
        return _no_mae(tree, source)
    if suffix in (".pth", ".pt"):
        _check_native_checkpoint(cfg, source)
        return load_pth(p, cfg)
    raise ValueError(
        f"unrecognized weight source {source!r}: expected a Weight_*.bin "
        "directory, a .npz, or a .pth/.pt"
    )


def _no_mae(tree, source):
    """An MAE pretraining tree (decoder, no classifier head) cannot serve as
    classifier weights: refuse it at load, with the conversion recipe,
    rather than with a KeyError('head') later in the forward."""
    from vit_tpu_torch.models.mae import is_mae_params

    if is_mae_params(tree):
        raise ValueError(
            f"{source} is an MAE pretraining checkpoint (decoder present, no classifier "
            "head): extract the fine-tuning backbone first — vit-tpu-torch-train --mae "
            "--save-backbone PATH, then use PATH here"
        )
    return tree


def _check_native_checkpoint(cfg, source):
    """Published-family checkpoints pack QKV columns per cfg.num_heads; a
    config with a head geometry no published checkpoint shares would load
    one without a shape error and compute wrong attention."""
    if not cfg.native_checkpoints:
        raise ValueError(
            f"{source} is a published-family checkpoint, but config {cfg.name} has "
            f"a head geometry ({cfg.num_heads}x{cfg.head_dim}) no published "
            "checkpoint shares; load a .npz trained for this config instead"
        )
