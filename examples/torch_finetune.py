#!/usr/bin/env python
"""Train with the port's library API and round-trip a checkpoint, the
counterpart of ``examples/finetune.py``: a miniature of what
``vit-tpu-torch-train`` builds from its flags (``cli/train_setup.py``).
Build a train step, run it, save an ``.npz``, reload it and evaluate.
Synthetic data keeps it runnable anywhere; it runs on the card unless
``--device cpu`` asks for the CPU.

    python examples/torch_finetune.py                      # card, fused_train kernels
    python examples/torch_finetune.py --device cpu --ops eager
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import dataclasses
import tempfile


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ops", default="fused_train", help="eager | fused_train | qat")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import checkpoint
    from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    # a small config that converges in seconds; drop the `replace` to train
    # the real B/16 (or start from a loaded checkpoint: --init-weights)
    cfg = dataclasses.replace(VIT_B_16, depth=2, embed_dim=64, num_heads=4, image_size=32,
                              patch_size=16, num_classes=5, name="vit_example")

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(32, 3, cfg.image_size, cfg.image_size))
                         .astype(np.float32)).to(args.device)
    y = torch.from_numpy(np.arange(32) % cfg.num_classes).to(args.device)

    params, optimizer = trainer.init_train_state(
        torch.Generator().manual_seed(0), cfg, lambda p: torch.optim.AdamW(
            trainer.leaves(p), lr=3e-3, weight_decay=1e-4), device=args.device)
    step = trainer.make_train_step(cfg, optimizer, get_ops(args.ops), remat=False)

    for i in range(args.steps):
        loss = step(params, x, y)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: loss {float(loss):.4f}")

    # checkpoint round trip (.npz; Weight_*.bin and .pth exports are in
    # io.weights and io.torch_convert, or vit-tpu-torch-convert)
    out = Path(tempfile.mkdtemp()) / "model.npz"
    checkpoint.save_npz(params_to_numpy(params), out)
    restored = params_from_numpy(checkpoint.load_npz(out), args.device)

    with torch.no_grad():
        logits = vit.forward(restored, x, cfg)
    acc = float((logits.argmax(-1) == y).float().mean())
    print(f"train top-1 after {args.steps} steps (reloaded ckpt): {acc:.2f}")
    return 0 if acc >= 0.9 else 1


if __name__ == "__main__":
    raise SystemExit(main())
