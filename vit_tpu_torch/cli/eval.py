"""Accuracy evaluation CLI (vit-tpu-torch-eval) — counterpart of
``vit_tpu.cli.eval``, with the same flags, text line and JSON line.

Streams a labeled dataset — a ``--data-dir`` of input-100.bin-format
shards with ``<stem>.labels.bin`` files, one ``--input``/``--labels``
pair, or an ``--image-dir`` of class folders of raw images — through an
``InferenceEngine`` on any op table and reports top-1 / top-5 accuracy and
mean top probability.  The datasets stream through
``runtime.prefetch.prefetch_to_device``: the host reads (or decodes) batch
i+1 and copies it to the card on a side stream while batch i runs.

Usage::

    vit-tpu-torch-eval --weights ./Network --data-dir ./val_shards --ops fused
    vit-tpu-torch-eval --weights ./Network --input input-100.bin --labels y.bin
    vit-tpu-torch-eval --weights ./Network --image-dir ./imagenet_val
    vit-tpu-torch-eval --weights p.npz --data-dir ./val --device cpu --ops eager

``--tp``/``--dp`` run under ``torchrun`` as the classify CLI does (rank 0
prints; every rank exits with the worst rank's code).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="vit-tpu-torch-eval", description="top-1/top-5 accuracy evaluation (PyTorch + CUDA)"
    )
    p.add_argument("--config", default="vit_b_16")
    p.add_argument(
        "--num-classes", type=int, default=None, metavar="K",
        help="override the config's class count (fine-tuned checkpoints)",
    )
    p.add_argument("--weights", required=True)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--data-dir", help="dir of labeled .bin shards")
    src.add_argument("--input", help="input-100.bin-format image batch")
    src.add_argument(
        "--image-dir",
        help="ImageNet-style folder-per-class dataset of raw image files "
        "(root/<class>/*.jpg, classes = sorted subdir names); preprocessed "
        "with the torchvision eval transform (io/preprocess.py)",
    )
    p.add_argument("--labels", help="raw int32 labels matching --input")
    p.add_argument("--batch", type=int, default=64, help="eval batch size")
    p.add_argument("--limit", type=int, default=None, help="evaluate at most N images")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    p.add_argument(
        "--ops", default="auto", choices=["auto", "eager", "per_op", "fused", "quant"],
        help="compute path, as the classify CLI's; auto = fused on cuda or with --tp, "
        "eager otherwise",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--dp", type=int, default=None)
    p.add_argument(
        "--dist-backend", default=None, choices=["nccl", "gloo"],
        help="torch.distributed backend of --tp/--dp (as the classify CLI's)",
    )
    p.add_argument("--gelu", default="exact", choices=["exact", "tanh"])
    p.add_argument(
        "--tome", type=int, default=0, metavar="R",
        help="ToMe token merging (needs --ops fused, quant or eager): measure the "
        "accuracy side of the throughput-vs-r trade",
    )
    p.add_argument("--allow-synth-weights", action="store_true")
    p.add_argument("--json", action="store_true", help="emit one JSON line instead of text")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.input and not args.labels:
        print("error: --input requires --labels", file=sys.stderr)
        return 2

    from vit_tpu_torch.cli.common import MeshError, resolve_mesh
    from vit_tpu_torch.config import resolve_config
    from vit_tpu_torch.io.params import device_or_raise

    cfg = resolve_config(args.config, args.num_classes)
    ops = args.ops
    if ops == "auto":
        ops = "fused" if args.device == "cuda" or args.tp > 1 else "eager"
    if args.tome < 0:
        print("error: --tome must be >= 0", file=sys.stderr)
        return 2
    if args.tome and (ops not in ("fused", "quant", "eager") or args.tp > 1):
        print("error: --tome needs --ops fused/quant/eager on a dp mesh (no --tp)",
              file=sys.stderr)
        return 2
    try:
        device_or_raise(args.device)  # --device cuda without a card: nothing runs elsewhere
        mesh, device = resolve_mesh(args.dp, args.tp, args.device, args.dist_backend,
                                    out=sys.stderr)
    except (MeshError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    lead = mesh is None or mesh.rank == 0
    rc = _evaluate(args, cfg, ops, mesh, device, lead)
    if mesh is not None:  # every rank exits with the worst rank's code
        import torch
        import torch.distributed as dist

        worst = torch.tensor([rc], dtype=torch.int32, device=device)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        rc = int(worst.item())
    return rc


def _evaluate(args, cfg, ops, mesh, device, lead: bool) -> int:
    """Load, stream and score; ``lead`` (rank 0) prints."""
    from vit_tpu_torch.eval import accuracy
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.runtime.engine import InferenceEngine

    ds = None
    if args.image_dir:
        from vit_tpu_torch.io.dataset import ImageFolderDataset

        ds = ImageFolderDataset(args.image_dir, cfg.image_size)
        if len(ds.class_names) > cfg.num_classes:
            print(f"error: {len(ds.class_names)} class folders > {cfg.num_classes} model "
                  f"classes ({cfg.name}) — folder indices would not map to model outputs",
                  file=sys.stderr)
            return 2
        n_total = min(args.limit, len(ds)) if args.limit else len(ds)
        if lead:
            print(f"{n_total} images, {len(ds.class_names)} classes", file=sys.stderr)
    elif args.data_dir:
        from vit_tpu_torch.io.dataset import BinShardDataset

        ds = BinShardDataset(args.data_dir, require_labels=True, num_classes=cfg.num_classes)
        n_total = min(args.limit, len(ds)) if args.limit else len(ds)
    else:
        from vit_tpu_torch.io.images import load_image_bin

        images = load_image_bin(args.input)
        labels = np.fromfile(args.labels, dtype="<i4")
        if len(labels) != len(images):
            print(f"error: {len(labels)} labels != {len(images)} images", file=sys.stderr)
            return 2
        if args.limit:
            images, labels = images[: args.limit], labels[: args.limit]
        n_total = len(images)

    try:
        params = load_params_any(args.weights, cfg, allow_synth=args.allow_synth_weights)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    bs = min(args.batch, n_total)
    engine = InferenceEngine(
        cfg, params, dtype=args.dtype, ops=ops, device=device, mesh=mesh, batch_pad=bs,
        gelu_variant=args.gelu, tome_r=args.tome,
    )
    t0 = time.perf_counter()
    if ds is not None:
        # both dataset kinds stream: the host reads (or decodes) batch i+1
        # and copies it to the card while batch i runs
        from vit_tpu_torch.runtime.prefetch import prefetch_to_device

        all_labels = ds.labels()

        def _stream():
            for i in range(0, n_total, args.batch):
                take = range(i, min(i + args.batch, n_total))
                yield ds.read(take), all_labels[take.start : take.stop]

        stream = prefetch_to_device(_stream(), size=2, device=engine.device)
        try:
            report = accuracy.evaluate_batches(engine, stream)
        finally:
            stream.close()
    else:
        report = accuracy.evaluate(engine, images, labels, batch_size=bs)
    dt = time.perf_counter() - t0
    payload = {
        **report.as_dict(),
        "images_per_sec": round(report.n / dt, 2),
        "model": cfg.name,
        "ops": ops,
        "dtype": args.dtype,
    }
    if not lead:
        return 0
    if args.json:
        print(json.dumps(payload))
    else:
        print(
            f"{cfg.name} ops={ops} dtype={args.dtype}: "
            f"top-1 {report.top1:.4f}  top-5 {report.top5:.4f}  "
            f"mean top-prob {report.mean_top_prob:.4f}  "
            f"({report.n} images, {payload['images_per_sec']} img/s)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
