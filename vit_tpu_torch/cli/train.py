"""Training CLI — counterpart of ``vit_tpu.cli.train``.

Cross-entropy training of a ViT with AdamW, on the ``fused_train`` CUDA
kernels (forward K1/K4/K5, backward K7/K6; with ``--dropout``/
``--drop-path``, forward K1/K10/K11, backward K12a/K6) or plain PyTorch
autograd (``eager``); ``--optimizer fused_adamw`` updates the weights with
the fused AdamW kernel (K20) in place of ``torch.optim.AdamW``.  ``--ops
qat`` trains through fake-int8 QKV and MLP GEMMs (plain PyTorch); ``--mae``
pretrains a masked autoencoder (the encoder on the visible tokens and the
decoder's blocks on the same kernels); ``--distill-teacher`` trains a
DeiT student against a frozen teacher on ``fused`` (or, with
``--distill-teacher-int8``, ``quant``).  Data is an input-100.bin-format
batch plus an int32 label file, or synthetic.

``--tp``/``--dp`` run SPMD under ``torchrun``, one process per rank: ``--tp``
trains tensor-parallel through the fused kernels (K1/K6 at the local
heads, K5 partial/K8 ``residual=False`` over the local hidden columns),
``--dp`` splits each batch over the ranks on any op table (MAE and
distillation too), ``--pp`` pipelines the layer stack over stages in
``--microbatches`` (``eager``, ``fused_train``; with ``--tp`` the
tensor-parallel fused block), ``--sp`` splits the tokens over a ring
(``eager`` with ring attention, ``fused_train`` with K4/K9 and K5/K8 on
each shard).  Every rank draws the same global batch and keeps its
dp slice; rank 0 alone prints, logs and saves (whole params); every rank
exits with the worst rank's code.

``--save-state`` (every ``--save-every`` steps, at the end, and on SIGTERM
before exiting) writes the JAX package's train-state archive, which
``--resume`` continues in either package; ``--ema-decay`` tracks an
average of the params (held-out evaluation scores it); ``--augment``
crops, flips and mixes each batch on the device inside the step;
``--freeze-backbone`` trains the head(s) alone; ``--skip-nonfinite``
skips an update whose gradients are not finite; ``--save-reference``
exports ``Weight_*.bin`` files.

Usage::

    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --mixed-precision
    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --mixed-precision \\
        --dropout 0.1 --drop-path 0.1
    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --mixed-precision \\
        --optimizer fused_adamw
    vit-tpu-torch-train --config vit_b_16 --steps 1000 --batch 64 --mixed-precision \\
        --data-dir SHARDS --augment crop,flip,mixup,cutmix --ema-decay 0.999 \\
        --save-state run.npz --save-every 100 [--resume run.npz]
    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --mixed-precision \
        --mae --save-backbone backbone.npz
    vit-tpu-torch-train --config deit_b_16 --steps 20 --batch 64 --mixed-precision \
        --distill-teacher teacher.npz [--distill-teacher-int8]
    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --ops qat
    vit-tpu-torch-train --config vit_b_16 --steps 2 --batch 4 --device cpu
    torchrun --standalone --nproc-per-node 2 -m vit_tpu_torch.cli.train \
        --config vit_b_16 --steps 3 --batch 16 --tp 2 --dist-backend gloo
    torchrun --standalone --nproc-per-node 2 -m vit_tpu_torch.cli.train \
        --config vit_b_16 --steps 2 --batch 4 --dp 2 --device cpu
    torchrun --standalone --nproc-per-node 2 -m vit_tpu_torch.cli.train \
        --config vit_b_16 --steps 2 --batch 8 --pp 2 --microbatches 4 --dist-backend gloo
    torchrun --standalone --nproc-per-node 2 -m vit_tpu_torch.cli.train \
        --config vit_b_16 --steps 2 --batch 8 --sp 2 --ops fused_train --dist-backend gloo

Flag definitions in cli/train_args.py, run construction in
cli/train_setup.py, the step loop in cli/train_loop.py.
"""

from __future__ import annotations

import sys

from vit_tpu_torch.cli.train_args import build_parser

__all__ = ["build_parser", "main"]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import contextlib
    import io

    from vit_tpu_torch.cli import train_loop
    from vit_tpu_torch.cli.train_setup import SetupError, build_mesh, prepare

    try:
        mesh, device = build_mesh(args)
    except SetupError as e:
        print(str(e), file=sys.stderr)
        return e.code
    lead = mesh is None or mesh.rank == 0
    # rank 0 alone prints
    with contextlib.redirect_stdout(sys.stdout if lead else io.StringIO()):
        try:
            rc = train_loop.run(args, prepare(args, mesh, device))
        except SetupError as e:
            if lead:
                print(str(e), file=sys.stderr)
            rc = e.code
    if mesh is not None:  # every rank exits with the worst rank's code
        import torch
        import torch.distributed as dist

        worst = torch.tensor([rc], dtype=torch.int32, device=device)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        rc = int(worst.item())
    return rc


if __name__ == "__main__":
    sys.exit(main())
