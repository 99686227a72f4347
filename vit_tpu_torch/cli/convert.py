"""Checkpoint conversion CLI — counterpart of ``vit_tpu.cli.convert``.

One command between the weight formats the port reads and writes
(``io/load_any.py`` resolves the input; the output format follows from
``--to``'s suffix, or ``--format``):

  - IN : reference ``Weight_*.bin`` dir / trained ``.npz`` / torchvision
         ``.pth`` / HuggingFace model dir (``--hf``)
  - OUT: ``.npz`` | reference-format dir (``--format reference``) |
         torchvision ``.pth``

Orbax is the one format it does not write: Orbax saves and restores
through JAX, so ``--format orbax`` exits 2 and names ``vit-tpu-convert``
(and an Orbax source dir is refused by ``load_params_any`` the same way).
Otherwise its flags, messages, output files and exit codes (2 on a client
error) are the JAX CLI's.

Usage::

    vit-tpu-torch-convert --from model.pth --to ./Network --format reference
    vit-tpu-torch-convert --from ./Network --to params.npz
    vit-tpu-torch-convert --from hf_dir --hf --to params.npz
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="vit-tpu-torch-convert")
    p.add_argument("--config", default="vit_b_16")
    p.add_argument("--from", dest="src", required=True,
                   help="source: Weight_*.bin dir, .npz, .pth/.pt, or (with --hf) a "
                   "HuggingFace ViT model dir")
    p.add_argument("--to", dest="dst", required=True,
                   help="destination path (.npz or .pth file, or a directory for "
                   "--format reference)")
    p.add_argument(
        "--format", default=None, choices=["npz", "reference", "orbax", "pth"],
        help="output format (default: npz for a *.npz destination, pth for *.pth/*.pt, "
        "reference otherwise); orbax saves through JAX: use vit-tpu-convert",
    )
    p.add_argument(
        "--hf", action="store_true",
        help="treat --from as a HuggingFace ViTForImageClassification checkpoint "
        "directory (io/hf_convert.py)",
    )
    p.add_argument("--allow-synth-weights", action="store_true")
    p.add_argument(
        "--no-round6", action="store_true",
        help="skip the reference loader's 6-decimal rounding on read",
    )
    return p


def _load_hf(args, cfg):
    """--hf: (params, cfg), or an exit code.  The transformers loading of the
    JAX CLI, step for step: DeiT's head layout from the checkpoint's
    recorded architecture, a headless checkpoint refused, the checkpoint's
    num_classes adopted, the structural fields checked against --config."""
    try:
        from transformers import ViTForImageClassification
    except ImportError:
        print("error: --hf needs the transformers package", file=sys.stderr)
        return 2
    from vit_tpu_torch.io.hf_convert import config_from_hf, params_from_hf_state_dict

    try:
        from transformers import AutoConfig

        hf_auto = AutoConfig.from_pretrained(args.src)
        if getattr(hf_auto, "model_type", "vit") == "deit":
            # distilled DeiT checkpoints carry two heads (WithTeacher), plain
            # fine-tunes one: pick by the recorded architecture (WithTeacher
            # when untagged, as every published distilled checkpoint is)
            from transformers import (
                DeiTForImageClassification,
                DeiTForImageClassificationWithTeacher,
            )

            archs = getattr(hf_auto, "architectures", None) or []
            cls = (DeiTForImageClassification if "DeiTForImageClassification" in archs
                   else DeiTForImageClassificationWithTeacher)
            model, info = cls.from_pretrained(args.src, output_loading_info=True)
            if any("classifier" in k for k in info["missing_keys"]):
                # an untagged checkpoint with the other head layout
                other = (DeiTForImageClassificationWithTeacher
                         if cls is DeiTForImageClassification else DeiTForImageClassification)
                model, info = other.from_pretrained(args.src, output_loading_info=True)
                if any("classifier" in k for k in info["missing_keys"]):
                    # a headless backbone: never export random-initialized heads
                    print(
                        f"error: {args.src!r} carries no classifier "
                        "head in either DeiT layout — convert a "
                        "*ForImageClassification checkpoint, or "
                        "fine-tune a head first (vit-tpu-train "
                        "--num-classes)",
                        file=sys.stderr,
                    )
                    return 2
        else:
            model, info = ViTForImageClassification.from_pretrained(
                args.src, output_loading_info=True)
            if any("classifier" in k for k in info["missing_keys"]):
                print(
                    f"error: {args.src!r} carries no classifier head — "
                    "convert a *ForImageClassification checkpoint, or "
                    "fine-tune a head first (vit-tpu-train "
                    "--num-classes)",
                    file=sys.stderr,
                )
                return 2
        hf_cfg = config_from_hf(model.config)
        # the checkpoint knows its own head width: adopt it
        if hf_cfg.num_classes != cfg.num_classes:
            import dataclasses

            print(f"note: adopting the checkpoint's num_classes="
                  f"{hf_cfg.num_classes} (config had {cfg.num_classes})")
            cfg = dataclasses.replace(cfg, num_classes=hf_cfg.num_classes)
        for field in ("image_size", "patch_size", "embed_dim", "depth", "num_heads",
                      "distilled"):
            got, want = getattr(hf_cfg, field), getattr(cfg, field)
            if got != want:
                print(f"error: HF checkpoint has {field}={got} but "
                      f"--config {cfg.name} expects {want}; pick the "
                      "matching --config", file=sys.stderr)
                return 2
        return params_from_hf_state_dict(model.state_dict(), cfg), cfg
    except Exception as e:  # a bad path or an incompatible checkpoint
        print(f"error: cannot load HF checkpoint {args.src!r}: {e}", file=sys.stderr)
        return 2


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vit_tpu_torch.config import get_config
    from vit_tpu_torch.io import checkpoint as ckpt
    from vit_tpu_torch.io import weights as wio
    from vit_tpu_torch.utils.tree import flatten_tree

    cfg = get_config(args.config)

    if args.hf:
        loaded = _load_hf(args, cfg)
        if isinstance(loaded, int):
            return loaded
        params, cfg = loaded
    else:
        from vit_tpu_torch.io.load_any import load_params_any

        try:
            params = load_params_any(args.src, cfg, round_to_6dp=not args.no_round6,
                                     allow_synth=args.allow_synth_weights)
        except (ValueError, KeyError, FileNotFoundError, RuntimeError) as e:
            # KeyError: an incompatible .pth state dict; RuntimeError: a
            # corrupt torch file — client errors, not tracebacks
            print(f"error: {e}", file=sys.stderr)
            return 2

    fmt = args.format
    if fmt is None:
        dst = str(args.dst).lower()  # .NPZ from a case-insensitive file system
        if dst.endswith(".npz"):
            fmt = "npz"
        elif dst.endswith((".pth", ".pt")):
            fmt = "pth"
        else:
            fmt = "reference"

    try:
        if fmt == "npz":
            ckpt.save_npz(params, args.dst)
        elif fmt == "orbax":
            raise ValueError(f"--format orbax saves through JAX; convert {args.dst} with "
                             "vit-tpu-convert (the JAX package's CLI)")
        elif fmt == "pth":
            from vit_tpu_torch.io.torch_convert import save_pth

            save_pth(params, args.dst, cfg)
        else:
            wio.save_reference_weights(wio.tensors_from_params(params, cfg), args.dst, cfg)
    except ValueError as e:
        # a distilled (DeiT) tree has no reference or torchvision layout
        print(f"error: {e}", file=sys.stderr)
        return 2
    n = len(flatten_tree(params))
    print(f"converted {args.src} -> {args.dst} ({fmt}, {n} tensors, {cfg.name})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
