#!/usr/bin/env python
"""DeiT knowledge distillation with the port's library API, the
counterpart of ``examples/distill.py``: a miniature of
``vit-tpu-torch-train --distill-teacher``.  A frozen teacher's forward
runs inside the student's step; the student's CLS head trains on the
labels, its distillation head on the teacher (hard distillation, Touvron
et al. 2021).  At the end the two heads average into one classifier
(``vit.forward``'s deployed head).  It runs on the card unless ``--device
cpu`` asks for the CPU.

    python examples/torch_distill.py                        # card, fused_train kernels
    python examples/torch_distill.py --device cpu --ops eager --alpha 1.0
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import dataclasses


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--alpha", type=float, default=0.5,
                    help="(1-a)*CE(cls, labels) + a*KD(dist, teacher)")
    ap.add_argument("--soft", action="store_true",
                    help="soft KD (temperature KL) instead of hard argmax CE")
    ap.add_argument("--ops", default="fused_train", help="eager | fused_train")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from vit_tpu_torch.config import DEIT_T_16
    from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    # a tiny distilled student and a smaller frozen teacher, so the example
    # runs in seconds; a real teacher comes from any checkpoint at full scale
    student_cfg = dataclasses.replace(DEIT_T_16, depth=2, embed_dim=64, num_heads=4,
                                      image_size=32, patch_size=16, num_classes=5,
                                      name="deit_example")
    teacher_cfg = dataclasses.replace(student_cfg, distilled=False, depth=1,
                                      name="teacher_example")
    teacher = params_from_numpy(params_to_numpy(
        vit.init_params(torch.Generator().manual_seed(7), teacher_cfg)), args.device)

    def teacher_fwd(x):  # frozen: the step runs it under no_grad
        return vit.forward(teacher, x, teacher_cfg)

    rng = np.random.default_rng(0)
    size = student_cfg.image_size
    x = torch.from_numpy(rng.normal(size=(32, 3, size, size)).astype(np.float32)).to(args.device)
    y = torch.from_numpy(np.arange(32) % student_cfg.num_classes).to(args.device)
    with torch.no_grad():
        teacher_labels = teacher_fwd(x).argmax(-1)

    params, optimizer = trainer.init_train_state(
        torch.Generator().manual_seed(0), student_cfg,
        lambda p: torch.optim.Adam(trainer.leaves(p), lr=3e-3), device=args.device)
    step = trainer.make_distill_train_step(student_cfg, optimizer, teacher_fwd,
                                           get_ops(args.ops), remat=False, alpha=args.alpha,
                                           hard=not args.soft)

    for i in range(args.steps):
        loss = step(params, x, y)
        if (i + 1) % 10 == 0:
            print(f"step {i + 1}: loss {float(loss):.4f}")

    with torch.no_grad():
        cls_logits, dist_logits = vit.forward(params, x, student_cfg, separate_heads=True)
        avg = vit.forward(params, x, student_cfg)  # the deployed head
    agree = float((dist_logits.argmax(-1) == teacher_labels).float().mean())
    acc = float((avg.argmax(-1) == y).float().mean())
    print(f"dist-head agreement with the teacher: {agree:.2f}")
    print(f"averaged-head train top-1 vs labels:  {acc:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
