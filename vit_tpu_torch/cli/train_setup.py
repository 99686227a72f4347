"""Training-run construction for the vit-tpu-torch-train CLI: device, op
table, params, optimizer, step and data.  Counterpart of
``vit_tpu.cli.train_setup`` for one device; ``prepare(args)`` returns a
:class:`TrainSetup`, and invalid flags raise :class:`SetupError` (the CLI
prints the message and exits 2).
"""

from __future__ import annotations

import dataclasses
import math
import sys
from typing import Callable, Optional

import numpy as np
import torch

from vit_tpu_torch.ops import fused_block


class SetupError(Exception):
    """Invalid flag combination; exit code in ``code``."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


@dataclasses.dataclass
class TrainSetup:
    """Everything the step loop (cli/train_loop.py) needs."""

    cfg: object
    device: torch.device
    ops_name: str
    step: Callable
    params: dict
    optimizer: torch.optim.Optimizer
    lr_at: Optional[Callable[[int], float]]  # step -> lr, None when constant
    images: np.ndarray
    labels: np.ndarray
    n_static: int  # len(images) after ragged-batch truncation


_DECAY_KEYS = {"kernel", "wqkv", "wo", "w1", "w2"}


def decay_mask(params):
    """True where weight decay applies (the GEMM weights); False for
    LayerNorm scales/biases, every bias, and the cls/pos embeddings — the
    standard ViT recipe (``vit_tpu.cli.train_setup.decay_mask``)."""
    return {
        k: decay_mask(v) if isinstance(v, dict) else k in _DECAY_KEYS
        for k, v in params.items()
    }


def adamw_param_groups(params, weight_decay: float, exempt_norm_bias: bool):
    """AdamW param groups: one with ``weight_decay`` for every leaf, or,
    with ``exempt_norm_bias``, the ``decay_mask`` leaves at
    ``weight_decay`` and the rest at 0."""
    from vit_tpu_torch.runtime.trainer import leaves

    if not exempt_norm_bias:
        return [{"params": list(leaves(params)), "weight_decay": weight_decay}]
    flags = list(leaves(decay_mask(params)))
    tensors = list(leaves(params))
    return [
        {"params": [t for t, f in zip(tensors, flags) if f], "weight_decay": weight_decay},
        {"params": [t for t, f in zip(tensors, flags) if not f], "weight_decay": 0.0},
    ]


def warmup_cosine(lr: float, steps: int) -> Callable[[int], float]:
    """step -> learning rate, equal to
    ``optax.warmup_cosine_decay_schedule(0, lr, max(steps // 10, 1), steps)``:
    linear from 0 to ``lr`` over the warmup, then a cosine to 0."""
    warm = max(steps // 10, 1)
    decay = steps - warm
    if decay <= 0:
        raise SetupError(f"error: --schedule warmup_cosine needs --steps > {warm} (got {steps})")

    def lr_at(count: int) -> float:
        if count < warm:
            return lr * count / warm
        c = min(count - warm, decay)
        return lr * 0.5 * (1.0 + math.cos(math.pi * c / decay))

    return lr_at


def _load_data(args, cfg):
    """-> (images, labels): --input/--labels, or synthetic images and
    random labels made exactly as the JAX CLI makes them."""
    from vit_tpu_torch.io import images as iio

    rng = np.random.default_rng(args.seed)
    if not args.input:
        images = iio.synth_images(args.batch, cfg, seed=args.seed)
        return images, rng.integers(0, cfg.num_classes, args.batch).astype(np.int32)
    images = iio.load_image_bin(args.input)
    if not args.labels:
        print("warning: --input given without --labels; pairing real images with "
              "RANDOM labels (smoke-test only)", file=sys.stderr)
        return images, rng.integers(0, cfg.num_classes, len(images)).astype(np.int32)
    labels = np.fromfile(args.labels, dtype="<i4")
    if len(labels) < len(images):
        raise SetupError(f"error: {len(labels)} labels < {len(images)} images in {args.labels}")
    labels = labels[: len(images)]
    if labels.size and (labels.min() < 0 or labels.max() >= cfg.num_classes):
        raise SetupError(f"error: labels outside [0, {cfg.num_classes}) in {args.labels}")
    return images, labels


def prepare(args) -> TrainSetup:
    from vit_tpu_torch.config import resolve_config
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda: torch.cuda.is_available() is False (no NVIDIA card "
            "or a CPU-only PyTorch); pass --device cpu to train on the CPU"
        )
    device = torch.device(args.device)
    load_cfg = resolve_config(args.config)  # --init-weights loads under its own head
    cfg = resolve_config(args.config, args.num_classes)
    ops_name = args.ops
    if ops_name == "auto":
        ops_name = "fused_train" if device.type == "cuda" else "eager"
    compute_dtype = torch.bfloat16 if args.mixed_precision else None
    # fused_train's backward kernels recompute from (x, ctx, x1) already;
    # recomputing the whole forward on top would run it twice
    remat = not args.no_remat and ops_name != "fused_train"
    print(f"device: {device}  ops: {ops_name}  mixed_precision: "
          f"{bool(args.mixed_precision)}  remat: {remat}")
    if args.batch % args.grad_accum:
        raise SetupError(f"error: --grad-accum {args.grad_accum} must divide --batch {args.batch}")
    use_dropout = bool(args.dropout or args.drop_path)
    if use_dropout:
        # eager: masks drawn in the plain blocks; fused_train: regenerated in
        # the kernels from one seed per layer (ops/trainable.py).  --ops
        # takes no table without regularizer hooks (argparse refuses fused).
        max_t = fused_block.VMEM_ATTENTION_MAX_T
        if ops_name == "fused_train" and cfg.seq_len > max_t:
            raise SetupError(
                "error: --dropout/--drop-path through the fused kernels support "
                f"seq_len <= {max_t} (got {cfg.seq_len}); use --ops eager for very "
                "long sequences"
            )
        cfg = dataclasses.replace(cfg, dropout=args.dropout, drop_path=args.drop_path)
        print(f"dropout: {args.dropout}  drop_path: {args.drop_path}")

    if args.init_weights:
        try:
            tree = load_params_any(args.init_weights, load_cfg, round_to_6dp=True,
                                   allow_synth=args.allow_synth_weights)
        except ValueError as e:
            raise SetupError(f"error: {e}") from e
        params = params_from_numpy(tree, "cpu", torch.float32)
        if args.num_classes:
            params["head"] = vit.init_head(torch.Generator().manual_seed(args.seed ^ 0x4EAD), cfg)
            print(f"transfer learning: fresh {cfg.embed_dim} x {args.num_classes} head")
    else:
        params = vit.init_params(torch.Generator().manual_seed(args.seed), cfg)
    params = trainer.as_trainable(params, device, torch.float32)

    lr_at = warmup_cosine(args.lr, args.steps) if args.schedule == "warmup_cosine" else None
    optimizer = torch.optim.AdamW(
        adamw_param_groups(params, args.weight_decay, args.wd_exempt_norm_bias),
        lr=lr_at(0) if lr_at else args.lr,
    )
    if args.wd_exempt_norm_bias:
        print("weight decay: GEMM kernels only (norm/bias/embeddings exempt)")
    if args.grad_clip:
        print(f"grad-clip: global norm {args.grad_clip}")
    step = trainer.make_train_step(
        cfg, optimizer, get_ops(ops_name), remat=remat, compute_dtype=compute_dtype,
        label_smoothing=args.label_smoothing, grad_accum=args.grad_accum,
        grad_clip=args.grad_clip, use_dropout=use_dropout,
        rng=torch.Generator().manual_seed(args.seed) if use_dropout else None,
    )

    images, labels = _load_data(args, cfg)
    if len(images) < args.batch:
        raise SetupError(
            f"error: {len(images)} image(s) < --batch {args.batch}; reduce --batch"
        )
    n_static = (len(images) // args.batch) * args.batch  # drop the ragged tail
    return TrainSetup(
        cfg=cfg, device=device, ops_name=ops_name, step=step, params=params,
        optimizer=optimizer, lr_at=lr_at, images=images[:n_static],
        labels=labels[:n_static], n_static=n_static,
    )
