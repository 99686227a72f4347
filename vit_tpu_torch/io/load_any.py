"""One weight-source resolver for the CLIs — counterpart of
``vit_tpu.io.load_any``, dispatched on what the path is:

  - a directory holding ``Weight_*.bin``  -> ``io.weights`` (6-decimal
    rounding parity, synthetic fill for stripped blobs)
  - ``*.npz``                             -> ``io.checkpoint`` (params, or
    the params of a train-state archive)
  - ``*.pth`` / ``*.pt``                  -> a torchvision state dict,
    repacked through ``io.torch_convert.load_pth``
  - any other directory                   -> an Orbax checkpoint, which
    restores through JAX: refused
"""

from __future__ import annotations

from pathlib import Path

from vit_tpu_torch.config import VIT_B_16, ViTConfig
from vit_tpu_torch.io import weights as wio
from vit_tpu_torch.io.torch_convert import load_pth


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
