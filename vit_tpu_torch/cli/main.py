"""Classification CLI — counterpart of ``vit_tpu.cli.main``.

Loads an image batch and weights, runs the model, and writes one
``[%d] label: %d / prob: %.6f`` line per image (the reference result
format); ``--golden`` gates the results against a golden file and the
exit code is the comparator's.  Weight directories in the reference's
Weight_*.bin format, raw ``--images`` and ``--golden`` read through the
JAX package's numpy-only ``vit_tpu.io`` / ``vit_tpu.eval`` modules; the
``.npz``, ``--input`` and ``--synth`` routes load nothing of it.

Usage::

    vit-tpu-torch --weights ./Network --input ./Data/input-100.bin \
                  --output ./Data/result.txt --golden ./Data/answer_result.txt
    vit-tpu-torch --weights ./Network --synth 8 --allow-synth-weights --device cpu

``--tp/--dp/--tome/--attn-rollout/--profile/--interpolate-pos-from`` of the
JAX package's CLI wait for their slices of the port.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vit-tpu-torch", description="ViT ImageNet classifier (PyTorch + CUDA)"
    )
    p.add_argument("--config", default="vit_b_16", help="model variant name")
    p.add_argument(
        "--num-classes", type=int, default=None, metavar="K",
        help="override the config's class count (fine-tuned checkpoints)",
    )
    p.add_argument(
        "--weights", required=True,
        help="weight source: Weight_*.bin dir, .npz checkpoint, or torchvision .pth",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--input", help="input-100.bin-format image batch")
    src.add_argument("--synth", type=int, help="use N synthetic images")
    src.add_argument(
        "--images", nargs="+", metavar="PATH",
        help="raw image files or directories, preprocessed with the "
        "torchvision eval transform",
    )
    p.add_argument("--output", help="write results here (reference text format)")
    p.add_argument("--golden", help="golden answer_result.txt to compare against")
    p.add_argument(
        "--compare-count", type=int, default=None,
        help="gate only the first N lines (reference parity: 1); default all",
    )
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument(
        "--ops", default="auto", choices=["auto", "eager", "fused"],
        help="compute path: fused (CUDA kernels), eager (plain PyTorch); "
        "auto = fused on cuda, eager on cpu",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--gelu", default="exact", choices=["exact", "tanh"])
    p.add_argument("--batch-pad", type=int, default=32)
    p.add_argument(
        "--no-round6", action="store_true",
        help="skip the reference's 6-decimal weight rounding (Network.c:186)",
    )
    p.add_argument(
        "--allow-synth-weights", action="store_true",
        help="synthesize any missing weight files (stripped-blob checkpoints)",
    )
    p.add_argument("--labels", help="label names: text file or C source array")
    p.add_argument("--top", type=int, default=1, help="print top-K classes per image")
    p.add_argument("--json", action="store_true", help="machine-readable summary")
    return p


def load_params(source, cfg, round_to_6dp: bool, allow_synth: bool):
    """``vit_tpu.io.load_any.load_params_any`` without the routes that need
    JAX: an Orbax directory is refused, and ``.npz`` is read directly."""
    p = Path(source)
    if p.is_dir() and not any(p.glob("Weight_*.bin")):
        raise ValueError(
            f"{source}: a directory with no Weight_*.bin is an Orbax checkpoint, "
            "which restores through JAX; convert it first (vit-tpu-convert) "
            "to .npz or Weight_*.bin"
        )
    if p.suffix.lower() == ".npz":
        from vit_tpu_torch.io import checkpoint as ckpt

        tree = ckpt.load_params_from_state(p) if ckpt.is_train_state(p) else ckpt.load_npz(p)
        if "decoder" in tree and "head" not in tree:
            raise ValueError(
                f"{source} is an MAE pretraining checkpoint (no classifier head)"
            )
        return tree
    from vit_tpu.io.load_any import load_params_any

    return load_params_any(
        source, cfg, round_to_6dp=round_to_6dp, allow_synth=allow_synth
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vit_tpu_torch.config import resolve_config
    from vit_tpu_torch.io import images as iio
    from vit_tpu_torch.io import results
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = resolve_config(args.config, args.num_classes)
    ops = args.ops
    if ops == "auto":
        ops = "fused" if args.device == "cuda" else "eager"

    t_load0 = time.perf_counter()
    source_names = None
    if args.input:
        images = iio.load_image_bin(args.input)
    elif args.images:
        from vit_tpu.io.preprocess import load_and_preprocess

        images, source_names = load_and_preprocess(args.images, cfg)
    else:
        images = iio.synth_images(args.synth, cfg, seed=0)
    try:
        params = load_params(
            args.weights, cfg, round_to_6dp=not args.no_round6,
            allow_synth=args.allow_synth_weights,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    t_load = time.perf_counter() - t_load0

    engine = InferenceEngine(
        cfg, params, dtype=args.dtype, ops=ops, device=args.device,
        batch_pad=args.batch_pad, gelu_variant=args.gelu,
    )

    t0 = time.perf_counter()
    probs = engine.probabilities(images).cpu().numpy()  # waits for the device
    elapsed = time.perf_counter() - t0

    pred = probs.argmax(-1)
    top_prob = probs[np.arange(len(pred)), pred]

    label_names = results.load_labels(args.labels, cfg.num_classes)
    for i in range(len(pred)):
        line = results.format_result_line(i, pred[i], top_prob[i])
        if args.top > 1:
            order = probs[i].argsort()[::-1][: args.top]
            extra = ", ".join(f"{label_names[j]}={probs[i, j]:.4f}" for j in order)
            line += f"   [{extra}]"
        else:
            line += f"   ({label_names[pred[i]]})"
        if source_names is not None:
            line += f"   {source_names[i]}"
        print(line)

    if args.output:
        results.write_result_file(pred, top_prob, args.output)

    n_errors = 0
    if args.golden:
        from vit_tpu.eval import comparator

        got = [
            comparator.ResultLine(i, int(l), float(p))
            for i, (l, p) in enumerate(zip(pred, top_prob))
        ]
        want = comparator.parse_result_file(args.golden)
        mismatches = comparator.compare_results(got, want, count=args.compare_count)
        n_errors = len(mismatches)
        for m in mismatches:
            print(f"MISMATCH {m}", file=sys.stderr)
        n_lines = len(want) if args.compare_count is None else args.compare_count
        print(f"comparator: {n_errors} error(s) over {n_lines} line(s)")

    print(
        f"model: {cfg.name}  images: {len(pred)}  ops: {ops}  dtype: {args.dtype}  "
        f"device: {engine.device}  load: {t_load:.2f}s  inference: {elapsed:.3f}s "
        f"({len(pred) / elapsed:.1f} img/s incl. first-call kernel build)"
    )
    if args.json:
        print(
            json.dumps(
                {
                    "images": int(len(pred)),
                    "inference_sec": elapsed,
                    "images_per_sec": len(pred) / elapsed,
                    "comparator_errors": n_errors,
                    "ops": ops,
                    "dtype": args.dtype,
                    "device": str(engine.device),
                }
            )
        )
    return 1 if n_errors else 0


if __name__ == "__main__":
    sys.exit(main())
