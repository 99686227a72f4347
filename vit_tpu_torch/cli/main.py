"""Classification CLI — counterpart of ``vit_tpu.cli.main``.

Loads an image batch and weights, runs the model, and writes one
``[%d] label: %d / prob: %.6f`` line per image (the reference result
format); ``--golden`` gates the results against a golden file and the
exit code is the comparator's.  Weights come from a reference-format
Weight_*.bin directory, a ``.npz`` or a torchvision ``.pth``
(``io/load_any.py``); images from ``--input``, ``--synth`` or raw files
(``--images``, ``io/preprocess.py``).

Usage::

    vit-tpu-torch --weights ./Network --input ./Data/input-100.bin \
                  --output ./Data/result.txt --golden ./Data/answer_result.txt
    vit-tpu-torch --weights ./Network --synth 8 --allow-synth-weights --device cpu
    vit-tpu-torch --weights ./Network --synth 8 --allow-synth-weights --ops quant

``--ops quant`` is W8A8 inference: the engine quantizes the QKV and MLP
weights of the loaded fp32 tree to int8 and runs the int8 kernels.
``--ops per_op`` runs one kernel per layer op (the JAX package's ``--ops
pallas``): K3 LayerNorms, K21 attention, K22 MLP.  ``--tome R`` merges R
token pairs per layer (ToMe, ``models/tome.py``) on ``fused``, ``quant`` or
``eager``.  ``--profile`` prints the engine's per-phase timing after the
results (``InferenceEngine.phase_report``).

``--tp N``/``--dp M`` run the CLI over N x M ranks, one process each,
under ``torchrun``::

    torchrun --nproc-per-node 2 -m vit_tpu_torch.cli.main --weights ./Network \
        --synth 8 --allow-synth-weights --tp 2 --device cpu

``--tp`` splits the heads and the MLP hidden axis of ``fused`` and
``quant`` over its ranks, ``--dp`` the batch (``InferenceEngine(mesh=)``).
The backend is NCCL where every rank has its own card, gloo on the CPU or
with ``--dist-backend gloo`` (ranks sharing one card).  Rank 0 prints and
writes the results; every rank exits with the same code.

``--attn-rollout/--interpolate-pos-from`` of the JAX package's CLI wait for
their slices of the port (their ``--tome`` refusals come with them).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

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
        "--ops", default="auto", choices=["auto", "eager", "per_op", "fused", "quant"],
        help="compute path: fused (CUDA kernels), quant (W8A8 int8 CUDA kernels), "
        "per_op (one CUDA kernel per layer op, the JAX package's --ops pallas: a "
        "debugging surface), eager (plain PyTorch); auto = fused on cuda or with --tp, "
        "eager otherwise",
    )
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument(
        "--tp", type=int, default=1,
        help="tensor-parallel size (heads/MLP split over the ranks; run under torchrun)",
    )
    p.add_argument(
        "--dp", type=int, default=None,
        help="data-parallel size (default: ranks/tp when tp>1)",
    )
    p.add_argument(
        "--dist-backend", default=None, choices=["nccl", "gloo"],
        help="torch.distributed backend of --tp/--dp (default: nccl where every rank has a "
        "card of its own, gloo on the CPU; gloo lets ranks share one card)",
    )
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
    p.add_argument(
        "--tome", type=int, default=0, metavar="R",
        help="ToMe token merging: merge the R most similar token pairs "
        "per layer (Bolya et al. 2022) — higher throughput at a "
        "controlled approximation cost; needs --ops fused, quant or eager",
    )
    p.add_argument("--json", action="store_true", help="machine-readable summary")
    p.add_argument(
        "--profile", action="store_true",
        help="print a per-phase timing breakdown (reference's per-encoder "
        "printfs, ViT_opencl.c:745-779, done as an aggregate report)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from vit_tpu_torch.cli.common import MeshError, resolve_mesh
    from vit_tpu_torch.config import resolve_config

    cfg = resolve_config(args.config, args.num_classes)
    ops = args.ops
    if ops == "auto":
        ops = "fused" if args.device == "cuda" or args.tp > 1 else "eager"
    if args.tome < 0:
        print("error: --tome must be >= 0", file=sys.stderr)
        return 2
    if args.tome and ops not in ("fused", "quant", "eager"):
        print("error: --tome (token merging) needs --ops fused, quant, or eager",
              file=sys.stderr)
        return 2
    if args.tome and args.tp > 1:
        print(
            "error: --tome shards data-parallel only (no --tp): the merge "
            "keeps whole tokens per device",
            file=sys.stderr,
        )
        return 2
    if args.profile and args.tp > 1:
        print("error: --profile runs the whole weights, which a --tp rank does not hold "
              "(not ported: ROADMAP.md item 14)", file=sys.stderr)
        return 2
    if args.tome and args.profile:
        print("error: --profile probes the full-token model, which would diverge from "
              "--tome's merged predictions — run it without --tome", file=sys.stderr)
        return 2
    if ops == "quant" and args.profile:
        # knowable now: the probe needs fp weights (the engine raises the
        # same incompatibility, but only after load and inference)
        print("error: --profile needs fp weights; use --ops eager/per_op/fused",
              file=sys.stderr)
        return 2
    try:
        mesh, device = resolve_mesh(args.dp, args.tp, args.device, args.dist_backend)
    except (MeshError, RuntimeError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    rc = _classify(args, cfg, ops, mesh, device, mesh is None or mesh.rank == 0)
    if mesh is not None:  # every rank exits with the worst rank's code
        import torch
        import torch.distributed as dist

        worst = torch.tensor([rc], dtype=torch.int32, device=device)
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
        rc = int(worst.item())
    return rc


def _classify(args, cfg, ops, mesh, device, lead: bool) -> int:
    """Load, classify and report; ``lead`` (rank 0) prints and writes."""
    from vit_tpu_torch.io import images as iio
    from vit_tpu_torch.io import results
    from vit_tpu_torch.io.load_any import load_params_any
    from vit_tpu_torch.runtime.engine import InferenceEngine

    say = print if lead else (lambda *a, **k: None)

    t_load0 = time.perf_counter()
    source_names = None
    if args.input:
        images = iio.load_image_bin(args.input)
    elif args.images:
        from vit_tpu_torch.io.preprocess import load_and_preprocess

        images, source_names = load_and_preprocess(args.images, cfg)
    else:
        images = iio.synth_images(args.synth, cfg, seed=0)
    try:
        params = load_params_any(
            args.weights, cfg, round_to_6dp=not args.no_round6,
            allow_synth=args.allow_synth_weights,
        )
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    t_load = time.perf_counter() - t_load0

    engine = InferenceEngine(
        cfg, params, dtype=args.dtype, ops=ops, device=device,
        batch_pad=args.batch_pad, gelu_variant=args.gelu, tome_r=args.tome, mesh=mesh,
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
        say(line)

    if args.output and lead:
        results.write_result_file(pred, top_prob, args.output)

    n_errors = 0
    if args.golden:
        from vit_tpu_torch.eval import comparator

        got = [
            comparator.ResultLine(i, int(l), float(p))
            for i, (l, p) in enumerate(zip(pred, top_prob))
        ]
        want = comparator.parse_result_file(args.golden)
        mismatches = comparator.compare_results(got, want, count=args.compare_count)
        n_errors = len(mismatches)
        for m in mismatches:
            say(f"MISMATCH {m}", file=sys.stderr)
        n_lines = len(want) if args.compare_count is None else args.compare_count
        say(f"comparator: {n_errors} error(s) over {n_lines} line(s)")

    if args.profile:
        say(engine.phase_report(images))

    say(
        f"model: {cfg.name}  images: {len(pred)}  ops: {ops}  dtype: {args.dtype}  "
        f"device: {engine.device}  load: {t_load:.2f}s  inference: {elapsed:.3f}s "
        f"({len(pred) / elapsed:.1f} img/s incl. first-call kernel build)"
    )
    if args.json:
        say(
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
