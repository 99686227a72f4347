"""Training CLI — counterpart of ``vit_tpu.cli.train`` on one device.

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

Usage::

    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --mixed-precision
    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --mixed-precision \\
        --dropout 0.1 --drop-path 0.1
    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --mixed-precision \\
        --optimizer fused_adamw
    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --mixed-precision \
        --mae --save-backbone backbone.npz
    vit-tpu-torch-train --config deit_b_16 --steps 20 --batch 64 --mixed-precision \
        --distill-teacher teacher.npz [--distill-teacher-int8]
    vit-tpu-torch-train --config vit_b_16 --steps 20 --batch 64 --ops qat
    vit-tpu-torch-train --config vit_b_16 --steps 2 --batch 4 --device cpu

Flag definitions in cli/train_args.py, run construction in
cli/train_setup.py, the step loop in cli/train_loop.py.
"""

from __future__ import annotations

import sys

from vit_tpu_torch.cli.train_args import build_parser

__all__ = ["build_parser", "main"]


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vit_tpu_torch.cli import train_loop
    from vit_tpu_torch.cli.train_setup import SetupError, prepare

    try:
        setup = prepare(args)
    except SetupError as e:
        print(str(e), file=sys.stderr)
        return e.code
    return train_loop.run(args, setup)


if __name__ == "__main__":
    sys.exit(main())
