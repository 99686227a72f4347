#!/usr/bin/env python
"""Classify images with the port's library API (PyTorch + CUDA), the
counterpart of ``examples/classify.py``.

With ``--weights`` pointing at a checkpoint (reference ``Weight_*.bin``
dir, ``.npz`` or torchvision ``.pth``: whatever ``io/load_any.py``
resolves) the predictions are real; without one, synthetic weights from a
seed keep the example running end to end (real shapes, meaningless
labels).  It runs on the card unless ``--device cpu`` asks for the CPU.

    python examples/torch_classify.py                       # card, fused kernels
    python examples/torch_classify.py --device cpu --ops eager
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--weights", default=None, help="checkpoint (any format load_any reads)")
    ap.add_argument("--config", default="vit_b_16")
    ap.add_argument("--ops", default="fused", help="eager | per_op | fused | quant")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from vit_tpu_torch.config import get_config
    from vit_tpu_torch.io import weights as wio
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.results import load_labels
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = get_config(args.config)
    if args.weights:
        from vit_tpu_torch.io.load_any import load_params_any

        params = load_params_any(args.weights, cfg)
    else:
        params = wio.params_from_tensors(wio.synth_reference_tensors(cfg, seed=0), cfg)

    images = synth_images(args.batch, cfg, seed=0)  # or io.images.preprocess for raw pixels
    engine = InferenceEngine(cfg, params, dtype="bfloat16", ops=args.ops, device=args.device)
    labels, top_probs = engine.classify(images)

    # the names follow the config's head width (a fine-tuned head gets
    # class_i placeholders, not the 1000-name ImageNet table)
    names = load_labels(num_classes=cfg.num_classes)
    for i, (lbl, p) in enumerate(zip(labels, top_probs)):
        print(f"[{i}] label: {lbl} / prob: {p:.6f}   ({names[lbl]})")

    # the probes need fp weights: none on the int8 engine
    if args.ops != "quant":
        feats = engine.features(images)  # (B, D) CLS embeddings
        heat = engine.attention_maps(images, rollout=True)  # (B, grid, grid)
        print(f"features {tuple(feats.shape)}  rollout {tuple(heat.shape)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
