"""Argument parser for the training CLI (vit-tpu-torch-train).

The flags of ``vit_tpu.cli.train_args`` that the one-device PyTorch port
runs; the mesh, augmentation, distillation, MAE, EMA, resume and
streaming-data flags wait for their slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import argparse


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vit-tpu-torch-train", description="ViT training (PyTorch + CUDA)"
    )
    p.add_argument("--config", default="vit_b_16")
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--weight-decay", type=float, default=0.05)
    p.add_argument(
        "--wd-exempt-norm-bias", action="store_true",
        help="apply weight decay only to the GEMM kernels (patch embed, "
        "QKV/out/MLP/head weights); LayerNorm params, biases and the "
        "cls/pos embeddings are exempt (an AdamW param group of their own)",
    )
    p.add_argument(
        "--schedule", default="constant", choices=["constant", "warmup_cosine"],
        help="learning-rate schedule (warmup = 10%% of steps)",
    )
    p.add_argument("--input", help="input-100.bin-format images (else synthetic)")
    p.add_argument("--labels", help="raw int32 label file matching --input")
    p.add_argument(
        "--init-weights",
        help="warm-start from a Weight_*.bin dir, .npz or .pth (Orbax "
        "directories restore through JAX and are refused)",
    )
    p.add_argument(
        "--allow-synth-weights", action="store_true",
        help="synthesize any missing weight files (stripped-blob checkpoints)",
    )
    p.add_argument(
        "--num-classes", type=int, default=None, metavar="K",
        help="train K classes; with --init-weights the backbone is kept and "
        "the head is re-initialized at (D, K)",
    )
    p.add_argument("--save", help="save final params to this .npz")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument(
        "--ops", default="auto", choices=["auto", "eager", "fused_train"],
        help="eager (plain PyTorch autograd) or fused_train (CUDA kernels "
        "forward and backward; their plain twins on the CPU). auto = "
        "fused_train on cuda, eager on cpu",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument(
        "--mixed-precision", action="store_true",
        help="bf16 compute with fp32 master weights and optimizer state",
    )
    p.add_argument(
        "--optimizer", default="adamw", choices=["adamw", "fused_adamw"],
        help="adamw (torch.optim.AdamW) or fused_adamw (the in-place fused AdamW "
        "kernel, one launch per leaf; requires --ops fused_train)",
    )
    p.add_argument(
        "--grad-clip", type=float, default=0.0, metavar="NORM",
        help="clip gradients to this global L2 norm before the update",
    )
    p.add_argument(
        "--label-smoothing", type=float, default=0.0, metavar="EPS",
        help="label-smoothing epsilon for the cross-entropy loss",
    )
    p.add_argument(
        "--grad-accum", type=int, default=1, metavar="K",
        help="accumulate gradients over K microbatches per step (K must "
        "divide --batch)",
    )
    p.add_argument(
        "--dropout", type=float, default=0.0, metavar="P",
        help="training dropout at torchvision's four sites (input + pos "
        "embedding, post-attention, intra-MLP, post-MLP); --ops eager or "
        "fused_train (in-kernel masks)",
    )
    p.add_argument(
        "--drop-path", type=float, default=0.0, metavar="R",
        help="stochastic depth: per-sample residual-branch drop, rate "
        "scaled linearly from 0 at the first block to R at the last",
    )
    p.add_argument(
        "--tome", type=int, default=None, metavar="R",
        help="train with token merging active (ToMe): merge R token pairs "
        "per layer on the chunked schedule; --ops fused_train (the split "
        "kernels around the merge-matrix GEMM) or eager",
    )
    p.add_argument(
        "--tome-chunk", type=int, default=None, metavar="N",
        help="override the ToMe merge-schedule bucketing for training "
        "(default models/tome.TRAIN_MERGE_CHUNK = 2)",
    )
    p.add_argument(
        "--log-jsonl", metavar="PATH",
        help="append one JSON line per step (step, loss, ms, images/sec)",
    )
    return p
