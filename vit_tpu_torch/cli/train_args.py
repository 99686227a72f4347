"""Argument parser for the training CLI (vit-tpu-torch-train).

The flags of ``vit_tpu.cli.train_args`` that the PyTorch port runs, with
``--tp``/``--dp``/``--pp``/``--sp`` under ``torchrun`` (one process per
rank), ``--multihost`` with its coordinator flags (or under ``torchrun``),
and ``--dist-backend``; the ZeRO-1 and FSDP flags wait for their slice of
the port (ROADMAP.md item 14).
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
        "--data-dir", metavar="DIR",
        help="stream shuffled minibatches from a directory of "
        "input-100.bin-format shards, each with a <stem>.labels.bin int32 "
        "file (io/dataset.py: native threaded gather reads + a side-stream "
        "host->device prefetch); overrides --input/--labels",
    )
    p.add_argument(
        "--image-dir", metavar="DIR",
        help="train from an ImageNet-style folder-per-class tree of raw "
        "image files (root/<class>/*.jpg, classes = sorted subdir names); "
        "decoded full-frame to the model resolution (the train-mode "
        "transform) and streamed through the same prefetch as --data-dir",
    )
    p.add_argument(
        "--data-threads", type=int, default=8,
        help="reader threads for the native gather loader (--data-dir) or "
        "the image decoder pool (--image-dir)",
    )
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
    p.add_argument(
        "--freeze-backbone", action="store_true",
        help="linear probe: update only the classification head(s) (head, "
        "and head_dist on distilled configs); the backbone gets no update and "
        "no weight decay; pairs with --init-weights and --num-classes",
    )
    p.add_argument("--save", help="save final params to this .npz")
    p.add_argument(
        "--save-reference", metavar="DIR",
        help="export final params as reference-format Weight_{idx}_{name}"
        ".bin files (torchvision layout; loadable by the reference C "
        "engine and by --init-weights)",
    )
    p.add_argument(
        "--save-state", metavar="PATH",
        help="checkpoint the FULL training state (params+optimizer+step) "
        "to this .npz at the end and every --save-every steps (either "
        "package resumes the other's)",
    )
    p.add_argument(
        "--save-every", type=int, default=0, metavar="N",
        help="with --save-state: also checkpoint every N steps",
    )
    p.add_argument(
        "--resume", metavar="PATH",
        help="resume a --save-state checkpoint (params, optimizer, step)",
    )
    p.add_argument(
        "--distill-teacher", metavar="WEIGHTS",
        help="DeiT distillation: train the student's distillation head "
        "against this frozen teacher (any weight source; the teacher "
        "forward runs inside the step).  Requires a distilled --config "
        "(deit_*) and --ops eager, qat or fused_train",
    )
    p.add_argument(
        "--distill-teacher-int8", action="store_true",
        help="run the frozen teacher through the W8A8 quant kernels (the "
        "teacher's targets get the int8 path's labels-preserved/looser-"
        "logits contract).  Requires --ops fused_train",
    )
    p.add_argument(
        "--distill-config", default=None, metavar="NAME",
        help="teacher config name (default: the student config's "
        "non-distilled twin — same geometry, single CLS head)",
    )
    p.add_argument(
        "--distill-alpha", type=float, default=0.5, metavar="A",
        help="distillation mix: (1-A)*CE(cls, labels) + A*KD(dist, teacher)",
    )
    p.add_argument(
        "--distill-soft", action="store_true",
        help="soft KD (temperature-scaled KL) instead of the paper's "
        "default hard distillation (CE against the teacher's argmax)",
    )
    p.add_argument(
        "--distill-tau", type=float, default=1.0, metavar="T",
        help="softmax temperature for --distill-soft",
    )
    p.add_argument(
        "--mae", action="store_true",
        help="MAE self-supervised pretraining (models/mae.py): mask "
        "--mask-ratio of the patches, encode the visible ones, reconstruct "
        "the masked pixels through a lightweight decoder.  No labels are "
        "consumed (any provided are ignored).  Pair with --save-backbone to "
        "produce the fine-tuning checkpoint for --init-weights",
    )
    p.add_argument(
        "--mask-ratio", type=float, default=0.75, metavar="R",
        help="with --mae: fraction of patches hidden from the encoder "
        "(0.75 is the paper's optimum; the encoder then runs on ~25%% of "
        "the tokens)",
    )
    p.add_argument(
        "--mae-decoder", default="512,8,16", metavar="DIM,DEPTH,HEADS",
        help="with --mae: decoder geometry (paper default 512,8,16; the "
        "decoder exists only during pretraining)",
    )
    p.add_argument(
        "--no-norm-pix", action="store_true",
        help="with --mae: reconstruct raw pixels instead of per-patch "
        "normalized pixels (norm-pix is the paper's better default)",
    )
    p.add_argument(
        "--save-backbone", metavar="PATH",
        help="with --mae: save the pretrained encoder as a standard "
        "classifier .npz (decoder dropped, fresh random head) — feed it "
        "to --init-weights [--num-classes K] to fine-tune",
    )
    p.add_argument(
        "--ema-decay", type=float, default=0.0, metavar="D",
        help="track an exponential moving average of the params "
        "(ema = D*ema + (1-D)*params per step); saved via --save-ema",
    )
    p.add_argument(
        "--save-ema", metavar="PATH",
        help="with --ema-decay: save the EMA params to this .npz at the end",
    )
    p.add_argument("--tp", type=int, default=1, help="tensor-parallel size")
    p.add_argument("--dp", type=int, default=None, help="data-parallel size")
    p.add_argument(
        "--pp", type=int, default=1,
        help="pipeline-parallel stages over the layer stack; composes with "
        "--dp/--tp into 3D parallelism (parallel/pipeline.py). Requires "
        "--ops eager (dp x pp) or fused_train (dp x pp x tp)",
    )
    p.add_argument(
        "--microbatches", type=int, default=None,
        help="pipeline microbatches per step (default: 2 x pp)",
    )
    p.add_argument(
        "--sp", type=int, default=1,
        help="sequence-parallel size: tokens shard over an 'sp' ring, "
        "attention runs as ring attention (parallel/sequence.py). Composes "
        "with --dp; requires --ops eager or fused_train; excludes --pp/--tp",
    )
    p.add_argument(
        "--dist-backend", default=None, choices=["nccl", "gloo"],
        help="torch.distributed backend of --tp/--dp/--pp/--sp/--multihost, run under `torchrun "
        "--nproc-per-node N` (default: nccl where every rank has a card of its "
        "own, gloo on the CPU; gloo lets ranks share one card)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--no-remat", action="store_true")
    p.add_argument(
        "--ops", default="auto", choices=["auto", "eager", "fused_train", "qat"],
        help="eager (plain PyTorch autograd), fused_train (CUDA kernels "
        "forward and backward; their plain twins on the CPU), or qat "
        "(fake-int8 forward with straight-through backward — trains weights "
        "for the int8 deployment path). auto = fused_train on cuda, eager "
        "on cpu",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument(
        "--mixed-precision", action="store_true",
        help="bf16 compute with fp32 master weights and optimizer state",
    )
    p.add_argument(
        "--optimizer", default="adamw", choices=["adamw", "fused_adamw"],
        help="adamw (torch.optim.AdamW) or fused_adamw (the in-place fused AdamW "
        "kernel, one launch per step; requires --ops fused_train)",
    )
    p.add_argument(
        "--grad-clip", type=float, default=0.0, metavar="NORM",
        help="clip gradients to this global L2 norm before the update",
    )
    p.add_argument(
        "--skip-nonfinite", action="store_true",
        help="skip optimizer updates when grads are non-finite "
        "(optax.apply_if_finite's rule) instead of aborting on a bad loss",
    )
    p.add_argument(
        "--augment", metavar="LIST", default=None,
        help="comma-separated augmentations applied on the device inside "
        "the train step (runtime/augment.py): any of flip,crop,mixup,"
        "cutmix (e.g. --augment crop,flip,mixup). mixup+cutmix alternate "
        "50/50 per step. dp paths only (not with --pp, --tp>1, or --sp)",
    )
    p.add_argument(
        "--label-smoothing", type=float, default=0.0, metavar="EPS",
        help="label-smoothing epsilon for the cross-entropy loss",
    )
    p.add_argument(
        "--mixup-alpha", type=float, default=0.2,
        help="Beta(a,a) parameter for --augment mixup",
    )
    p.add_argument(
        "--cutmix-alpha", type=float, default=1.0,
        help="Beta(a,a) parameter for --augment cutmix",
    )
    p.add_argument(
        "--grad-accum", type=int, default=1, metavar="K",
        help="accumulate gradients over K microbatches per step (K must "
        "divide the per-dp-shard batch). dp paths only (not with --pp, --tp>1, or --sp)",
    )
    p.add_argument(
        "--dropout", type=float, default=0.0, metavar="P",
        help="training dropout at torchvision's four sites (input + pos "
        "embedding, post-attention, intra-MLP, post-MLP); --ops eager, qat "
        "or fused_train (in-kernel masks)",
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
        "--eval-data-dir", metavar="DIR",
        help="held-out labeled .bin shards (same format as --data-dir) "
        "evaluated every --eval-every steps: top-1 on --eval-batches "
        "batches with the current params (the EMA params when --ema-decay "
        "is on), through the fp32 eager forward (TF32 off)",
    )
    p.add_argument(
        "--eval-every", type=int, default=0, metavar="N",
        help="with --eval-data-dir: evaluate every N steps (and at the end)",
    )
    p.add_argument(
        "--eval-batches", type=int, default=4,
        help="batches of --batch images per held-out evaluation",
    )
    p.add_argument(
        "--log-jsonl", metavar="PATH",
        help="append one JSON line per step (step, loss, ms, images/sec)",
    )
    p.add_argument(
        "--multihost", action="store_true",
        help="pod mode: join every process (one per card) into the process group and "
        "train data-parallel over all of them; --batch is the GLOBAL batch, each "
        "process streams its own rows of each batch of --data-dir (required). Run the "
        "same command in every process",
    )
    p.add_argument("--coordinator", default=None,
                   help="multihost coordinator address (host:port); from torchrun's "
                   "environment when omitted")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    return p
