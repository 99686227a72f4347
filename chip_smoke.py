"""Drive the PyTorch + CUDA port (``vit_tpu_torch``) once on one NVIDIA card
and check it:  ``python3 chip_smoke.py``

Phases (a failed phase raises; nothing is caught):
  1. require a card; print its name and power limit (nvidia-smi);
  2. build the CUDA kernels from ``vit_tpu_torch/csrc``;
  3. each kernel (K1 ln_qkv_attn, K2 out_ln_mlp_residual, K3 layer_norm)
     against its plain PyTorch twin on the card, bf16 and fp32, at ViT-B/16
     shapes for batch 100 and a ragged batch of 3, with both timed;
  4. the classify CLI in-process on synthetic B/16 reference weights:
     ``--synth 100 --ops fused --dtype bfloat16 --device cuda``, with every
     launch count set to 0 just before and read just after (12 K1, 12 K2,
     1 K3 per forward);
  5. correctness at full width: fp32 fused vs fp32 eager on the card
     (8 images), vs the eager path in float64 on the CPU (2 images), and
     bf16 fused vs fp32 fused over the batch of 100 (decisive labels, top
     probability);
  6. images/s at batch 100 bf16, fused and eager, timed in turns;
  7. the training kernels (K4 out_residual, K5 ln_mlp_residual, K6
     ln_qkv_attn_bwd, K7 ln_mlp_out_residual_bwd) against their plain
     twins, every output (dx, dctx, each weight and bias gradient), bf16 and
     fp32, at B/16 shapes for batch 64 and 3, with both timed;
  8. the train CLI in-process: ``--config vit_b_16 --steps 5 --batch 64
     --ops fused_train --mixed-precision --device cuda``, with every launch
     count set to 0 just before and read just after (12 each of K1, K4, K5,
     K6, K7 per step; no K2 or K3);
  9. training correctness at full width: fused_train vs eager autograd
     gradients for every leaf (fp32, 4 images), bf16 mixed vs fp32 loss, and
     memorization of 32 images through the trainer's step;
 10. train images/s at batch 64 mixed precision, fused_train and eager,
     timed in turns, with the peak device memory of each.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the card's name and power limit, and the one before
that a JSON object with one entry per kernel.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import re
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

# Stated tolerances, relative to the largest |value| of the plain result
# (at least 1): fp32 2^-16 — only fp32 summation order (K <= 3072) and FMA
# contraction differ; bf16 2^-6 — the kernel and its twin round at the
# same points, so they differ where accumulation order flips a bf16
# rounding: one ulp is at most 2^-7 of the value, and two are allowed.
TOLERANCE = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -6}
B16 = dict(d=768, heads=12, f=3072, t=197)
BATCHES = (100, 3)
KERNELS = {
    "ln_qkv_attn": ("K1", "vit_tpu_torch/csrc/ln_qkv_attn.cu",
                    "vit_tpu/ops/pallas/fused_block.py:229"),
    "out_ln_mlp_residual": ("K2", "vit_tpu_torch/csrc/out_ln_mlp_residual.cu",
                            "vit_tpu/ops/pallas/fused_block.py:608"),
    "layer_norm": ("K3", "vit_tpu_torch/csrc/layer_norm.cu",
                   "vit_tpu/ops/pallas/ln_kernel.py:35"),
}


TRAIN_KERNELS = {
    "out_residual": ("K4", "vit_tpu_torch/csrc/out_residual.cu",
                     "vit_tpu/ops/pallas/fused_block.py:329"),
    "ln_mlp_residual": ("K5", "vit_tpu_torch/csrc/ln_mlp_residual.cu",
                        "vit_tpu/ops/pallas/fused_block.py:440"),
    "ln_qkv_attn_bwd": ("K6", "vit_tpu_torch/csrc/ln_qkv_attn_bwd.cu",
                        "vit_tpu/ops/pallas/backward.py:916"),
    "ln_mlp_out_residual_bwd": ("K7", "vit_tpu_torch/csrc/ln_mlp_out_residual_bwd.cu",
                                "vit_tpu/ops/pallas/backward.py:351"),
}
TRAIN_BATCHES = (64, 3)
TRAIN_STEPS = 5
MEMORIZE_LR = 3e-4  # weight decay 1e-4, optax.adamw's default


def synth_params(cfg, seed: int = 0) -> dict:
    """Random weights in the port's params tree, numpy, from ``seed``:
    every GEMM matrix N(0, 1/fan_in), the position embedding N(0, 0.02),
    LayerNorm scales 1, biases and the class token 0 — the statistics of
    the reference checkpoint's synthetic stand-in."""
    from vit_tpu_torch.io.params import params_to_numpy
    from vit_tpu_torch.models import vit

    rng = np.random.default_rng(seed)

    def fill(tree):
        out = {}
        for key, value in tree.items():
            if isinstance(value, dict):
                out[key] = fill(value)
            elif key in ("kernel", "wqkv", "wo", "w1", "w2"):  # [in, out]
                out[key] = rng.normal(0, value.shape[-2] ** -0.5, value.shape).astype(np.float32)
            elif key == "pos_embed":
                out[key] = rng.normal(0, 0.02, value.shape).astype(np.float32)
            else:
                out[key] = (np.ones if "scale" in key else np.zeros)(value.shape, np.float32)
        return out

    return fill(params_to_numpy(vit.init_params(torch.Generator(), cfg)))


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 3, iters: int = 10) -> float:
    """Median device time of ``fn`` in ms over ``iters`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_cases(dev: torch.device):
    """-> {kernel: [(tag, dtype, batch, kernel_fn, plain_fn)]} at B/16 shapes."""
    from vit_tpu_torch.ops.kernels import layer_norm as k3
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.ops.kernels import out_ln_mlp_residual as k2

    d, h, f, t = B16["d"], B16["heads"], B16["f"], B16["t"]
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        x = torch.randn(*shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    cases = {name: [] for name in KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for b in BATCHES:
            rows = b * t
            tag = f"{str(dtype).removeprefix('torch.')} batch {b} (rows {rows})"
            x = rn(rows, d, scale=2.0, dtype=dtype)
            s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5, dtype=dtype), rn(3 * d, scale=0.1, dtype=dtype)
            a1 = (x, s1, b1n, wqkv, bqkv, h, t, 1e-6)
            ctx = k1.ln_qkv_attn_plain(*a1)
            wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
            w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            a2 = (ctx, x, wo, bo, s1, b1n, w1, bb1, w2, bb2, 1e-6, "exact")
            a3 = (x.reshape(b, t, d), s1, b1n, 1e-6)
            cases["ln_qkv_attn"].append(
                (tag, dtype, b, lambda a=a1: k1.ln_qkv_attn(*a), lambda a=a1: k1.ln_qkv_attn_plain(*a)))
            cases["out_ln_mlp_residual"].append(
                (tag, dtype, b, lambda a=a2: k2.out_ln_mlp_residual(*a),
                 lambda a=a2: k2.out_ln_mlp_residual_plain(*a)))
            cases["layer_norm"].append(
                (tag, dtype, b, lambda a=a3: k3.layer_norm(*a), lambda a=a3: k3.layer_norm_plain(*a)))
    return cases


def phase_kernels(cases: dict, labels: dict, summary_batch: int) -> dict:
    """Phases 3 and 7: kernel vs plain twin on every output, each held to
    TOLERANCE[dtype] x max(1, its own largest |value|).  -> {kernel:
    summary at bf16 ``summary_batch``}."""
    summary = {}
    for name, kcases in cases.items():
        for tag, dtype, b, kernel_fn, plain_fn in kcases:
            got, want = kernel_fn(), plain_fn()
            got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
            torch.cuda.synchronize()
            err, worst = 0.0, 0.0  # largest |d|, and largest |d| / tol
            for i, (g, w) in enumerate(zip(got, want)):
                g, w = g.float(), w.float()
                if g.shape != w.shape or not torch.isfinite(g).all():
                    raise RuntimeError(f"{name} {tag}: output {i} non-finite or misshapen")
                e = (g - w).abs().max().item()
                tol = TOLERANCE[dtype] * max(1.0, w.abs().max().item())
                if not e <= tol:
                    raise RuntimeError(f"{name} {tag}: output {i} max|d|={e:.6g} > tol "
                                       f"{tol:.6g}: kernel disagrees with its plain twin")
                err, worst = max(err, e), max(worst, e / tol)
            ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
            log(f"{labels[name][0]} {name} {tag}: {len(got)} output(s), max|d|={err:.6g} "
                f"(at most {worst:.3g} of its tol) kernel {ms:.6g} ms, plain {plain_ms:.6g} ms")
            if dtype == torch.bfloat16 and b == summary_batch:
                summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return summary


def train_kernel_cases(dev: torch.device):
    """-> {kernel: [(tag, dtype, batch, kernel_fn, plain_fn)]} for K4-K7 at
    B/16 training shapes."""
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_bwd as k6
    from vit_tpu_torch.ops.kernels import out_residual as k4

    d, h, f, t = B16["d"], B16["heads"], B16["f"], B16["t"]
    gen = torch.Generator(device=dev).manual_seed(1)

    def rn(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        x = torch.randn(*shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    cases = {name: [] for name in TRAIN_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for b in TRAIN_BATCHES:
            rows = b * t
            tag = f"{str(dtype).removeprefix('torch.')} batch {b} (rows {rows})"
            row = lambda scale=1.0: rn(rows, d, scale=scale, dtype=dtype)  # noqa: E731
            s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5, dtype=dtype), rn(3 * d, scale=0.1, dtype=dtype)
            wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
            w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            x, ctx, x1, dy, dctx = row(2.0), row(), row(2.0), row(), row()
            args = {
                "out_residual": (ctx, x, wo, bo),
                "ln_mlp_residual": (x1, s2, b2n, w1, bb1, w2, bb2, 1e-6, "exact"),
                "ln_qkv_attn_bwd": (dctx, dy, x, s1, b1n, wqkv, bqkv, h, t, 1e-6),
                "ln_mlp_out_residual_bwd": (dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, 1e-6, "exact"),
            }
            mods = {"out_residual": k4, "ln_mlp_residual": k5, "ln_qkv_attn_bwd": k6,
                    "ln_mlp_out_residual_bwd": k7}
            for name, a in args.items():
                fn, plain = getattr(mods[name], name), getattr(mods[name], f"{name}_plain")
                cases[name].append(
                    (tag, dtype, b, lambda fn=fn, a=a: fn(*a), lambda p=plain, a=a: p(*a)))
    return cases


def phase_cli(params, workdir: str) -> dict:
    """Phase 4: the classify CLI on the card, on ``params`` saved as an npz.
    -> launch counts of its run."""
    from vit_tpu_torch.cli.main import main
    from vit_tpu_torch.io import checkpoint, results

    weights = f"{workdir}/params.npz"
    checkpoint.save_npz(params, weights)
    result = f"{workdir}/result.txt"
    wrappers = all_wrappers()
    buf = io.StringIO()
    for fn in wrappers.values():
        fn.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = main([
            "--weights", weights, "--synth", "100", "--ops", "fused", "--dtype", "bfloat16",
            "--device", "cuda", "--batch-pad", "100", "--json", "--output", result,
        ])
    launches = {name: fn.launches for name, fn in wrappers.items()}
    out = buf.getvalue().splitlines()
    log("\n".join(["cli: " + line for line in out[:3] + out[-2:]]))
    log(f"cli: rc {rc}, launches {launches}")
    if rc != 0:
        raise RuntimeError(f"classify CLI exited {rc}")
    fmt = re.compile(r"^\[\d+\] label: \d+ / prob: \d+\.\d{6}")
    if sum(bool(fmt.match(line)) for line in out) != 100:
        raise RuntimeError("classify CLI did not print 100 result lines")
    if [r.index for r in results.parse_result_file(result)] != list(range(100)):
        raise RuntimeError("classify CLI's --output is not 100 well-formed lines")
    want = {name: 0 for name in wrappers}
    want.update(ln_qkv_attn=12, out_ln_mlp_residual=12, layer_norm=1)
    if launches != want:
        raise RuntimeError(f"expected 12/12/1 kernel launches per forward, got {launches}")
    return launches


def _probs(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def phase_correctness(params, images: np.ndarray, dev: torch.device) -> None:
    """Phase 5: fused vs eager (card, fp32), vs eager fp64 (CPU), bf16 vs fp32."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16
    fused32 = InferenceEngine(cfg, params, "float32", "fused", dev, batch_pad=1)
    eager32 = InferenceEngine(cfg, params, "float32", "eager", dev, batch_pad=1)
    f32 = fused32.logits(images[:8]).cpu().numpy()
    e32 = eager32.logits(images[:8]).cpu().numpy()
    del eager32
    if f32.shape != (8, cfg.num_classes) or not np.isfinite(f32).all():
        raise RuntimeError(f"fp32 fused logits: shape {f32.shape} or non-finite")
    dev_eager = float(np.abs(f32 - e32).max())
    log(f"fp32 fused vs fp32 eager (card, TF32 off), 8 images: max|d logit|={dev_eager:.6g} (tol 1e-3)")
    with torch.inference_mode():
        e64 = vit.forward(
            params_from_numpy(params, "cpu", torch.float64),
            torch.from_numpy(images[:2]).double(), cfg,
        ).numpy()
    dev_f64 = float(np.abs(f32[:2] - e64).max())
    log(f"fp32 fused (card) vs eager float64 (CPU), 2 images: max|d logit|={dev_f64:.6g} (tol 1e-3)")
    if not (dev_eager <= 1e-3 and dev_f64 <= 1e-3):
        raise RuntimeError("fp32 fused logits outside 1e-3 of the eager path")

    p32 = _probs(fused32.logits(images).cpu().numpy())
    del fused32
    fused16 = InferenceEngine(cfg, params, "bfloat16", "fused", dev, batch_pad=1)
    p16 = _probs(fused16.logits(images).cpu().numpy())
    l32, l16 = p32.argmax(-1), p16.argmax(-1)
    n = len(l32)
    top2 = np.sort(p32, -1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 0.01
    n_bad = int(((l16 != l32) & decisive).sum())
    prob_dev = float(np.abs(p16[np.arange(n), l16] - p32[np.arange(n), l32]).max())
    log(f"bf16 fused vs fp32 fused, {n} images: {int(decisive.sum())} decisive, "
        f"{n_bad} decisive label mismatches (tol 0), {int((l16 != l32).sum())} mismatches in all, "
        f"top-prob max|d|={prob_dev:.6g} (tol 0.01)")
    if n_bad or not prob_dev <= 0.01:
        raise RuntimeError("bf16 fused path fails the comparator rule against fp32")


def phase_throughput(params, images: np.ndarray, dev: torch.device, card: str) -> dict:
    """Phase 6: images/s at batch 100 bf16, fused and eager timed in turns."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.runtime.engine import InferenceEngine

    engines = {
        ops: InferenceEngine(VIT_B_16, params, "bfloat16", ops, dev, batch_pad=100)
        for ops in ("fused", "eager")
    }
    x = torch.from_numpy(images).to(dev, torch.bfloat16)
    for engine in engines.values():  # warm up
        engine.logits(x)
    torch.cuda.synchronize()
    times = {ops: [] for ops in engines}
    for _ in range(5):
        for ops in ("fused", "eager", "eager", "fused"):
            t0 = time.perf_counter()
            engines[ops].logits(x)
            torch.cuda.synchronize()
            times[ops].append(time.perf_counter() - t0)
    rates = {ops: len(images) / statistics.median(t) for ops, t in times.items()}
    for ops, rate in rates.items():
        log(f"throughput {ops} bf16 batch {len(images)}: {rate:.6g} img/s "
            f"(median of {len(times[ops])}; {card})")
    return rates


def all_wrappers() -> dict:
    """Every kernel wrapper of the port, by name (each carries ``launches``)."""
    from vit_tpu_torch.ops.kernels import layer_norm as k3
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_bwd as k6
    from vit_tpu_torch.ops.kernels import out_ln_mlp_residual as k2
    from vit_tpu_torch.ops.kernels import out_residual as k4

    return {
        "ln_qkv_attn": k1.ln_qkv_attn, "out_ln_mlp_residual": k2.out_ln_mlp_residual,
        "layer_norm": k3.layer_norm, "out_residual": k4.out_residual,
        "ln_mlp_residual": k5.ln_mlp_residual, "ln_qkv_attn_bwd": k6.ln_qkv_attn_bwd,
        "ln_mlp_out_residual_bwd": k7.ln_mlp_out_residual_bwd,
    }


def phase_train_cli(workdir: str) -> dict:
    """Phase 8: the train CLI on the card.  -> launch counts of its run."""
    from vit_tpu_torch.cli.train import main

    log_path = f"{workdir}/train.jsonl"
    wrappers = all_wrappers()
    buf = io.StringIO()
    for fn in wrappers.values():
        fn.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = main([
            "--config", "vit_b_16", "--steps", str(TRAIN_STEPS), "--batch", "64",
            "--ops", "fused_train", "--mixed-precision", "--device", "cuda",
            "--log-jsonl", log_path,
        ])
    launches = {name: fn.launches for name, fn in wrappers.items()}
    log("\n".join("train cli: " + line for line in buf.getvalue().splitlines()))
    log(f"train cli: rc {rc}, launches {launches}")
    if rc != 0:
        raise RuntimeError(f"train CLI exited {rc}")
    with open(log_path) as fh:
        losses = [json.loads(line)["loss"] for line in fh]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise RuntimeError(f"train CLI logged {losses}, expected {TRAIN_STEPS} finite losses")
    per_step = 12 * TRAIN_STEPS
    want = {name: per_step for name in ("ln_qkv_attn", *TRAIN_KERNELS)}
    want.update(out_ln_mlp_residual=0, layer_norm=0)
    if launches != want:
        raise RuntimeError(f"expected {want} kernel launches over {TRAIN_STEPS} steps, "
                           f"got {launches}")
    return launches


def _paths(tree, prefix=""):
    """(leaf path, tensor) of a nested params dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _grads(cfg, tree, x, y, ops_name: str, compute_dtype, dev):
    """-> (loss, {leaf path: grad}) of one cross-entropy backward."""
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    params = trainer.as_trainable(tree, dev, torch.float32)
    loss_fn = trainer._make_loss_fn(cfg, get_ops(ops_name), False, compute_dtype)
    loss = loss_fn(params, x, y)
    loss.backward()
    return loss.item(), {path: t.grad for path, t in _paths(params)}


def phase_train_correctness(dev: torch.device) -> None:
    """Phase 9: fused_train vs eager gradients (fp32, every leaf), bf16 mixed
    vs fp32 loss, and memorization through the trainer's step."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    cfg = VIT_B_16
    tree = params_from_numpy(synth_params(cfg, 0))
    x = torch.from_numpy(synth_images(4, cfg, seed=3)).to(dev)
    y = torch.tensor([3, 141, 592, 653], device=dev)
    lf, gf = _grads(cfg, tree, x, y, "fused_train", None, dev)
    le, ge = _grads(cfg, tree, x, y, "eager", None, dev)
    worst, worst_leaf = 0.0, None
    for leaf, g in ge.items():
        bound = 1e-3 * max(1.0, g.abs().max().item())
        r = (gf[leaf] - g).abs().max().item() / bound
        if r > worst:
            worst, worst_leaf = r, leaf
    log(f"train grads fp32 fused_train vs eager autograd (card, TF32 off), B/16, 4 images: "
        f"loss {lf:.6g} vs {le:.6g}; {len(ge)} leaves, worst {worst_leaf} at {worst:.3g} of "
        f"its bound (bound 1e-3 x max(1, max|g|), the JAX package's oracle bar)")
    if worst > 1.0 or set(gf) != set(ge) or not np.isfinite(lf):
        raise RuntimeError("fused_train gradients outside 1e-3 of eager autograd")
    del gf, ge
    lb, _ = _grads(cfg, tree, x, y, "fused_train", torch.bfloat16, dev)
    log(f"train loss bf16 mixed vs fp32 fused_train: {lb:.6g} vs {lf:.6g}, |d|={abs(lb - lf):.6g} "
        f"(tol 2e-2, the reference's bf16 spread)")
    if not abs(lb - lf) <= 2e-2:
        raise RuntimeError("bf16 mixed-precision loss outside 2e-2 of fp32")

    # memorization (tests/test_convergence.py): 32 images, classes i % 11.
    # The tiny-config test's AdamW 3e-3 is too hot at B/16 width: there
    # eager and fused_train alike (same losses to 3 decimals) stall at 0.66
    # top-1 after 40 steps; 3e-4 memorizes within 20 (PERF.md).  A head
    # alone could memorize 32 images, so every leaf must also have moved by
    # at least one step's worth (an AdamW step moves an element by up to
    # ~lr; weight decay alone moves it by lr * 1e-4 * |p|).
    cfg11 = dataclasses.replace(cfg, num_classes=11)
    rng = np.random.default_rng(0)
    xm = torch.from_numpy(rng.normal(size=(32, 3, cfg.image_size, cfg.image_size))
                          .astype(np.float32)).to(dev)
    ym = torch.arange(32, device=dev) % 11
    params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg11), dev)
    opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=MEMORIZE_LR, weight_decay=1e-4)
    ops = get_ops("fused_train")
    step = trainer.make_train_step(cfg11, opt, ops, remat=False, compute_dtype=torch.bfloat16)
    start = {path: t.detach().clone() for path, t in _paths(params)}
    best, losses = 0.0, []
    for i in range(40):
        losses.append(float(step(params, xm, ym)))
        if (i + 1) % 10 == 0:
            with torch.no_grad():
                logits = vit.forward(vit.cast_params(params, torch.bfloat16),
                                     xm.to(torch.bfloat16), cfg11, ops)
            best = max(best, (logits.argmax(-1) == ym).float().mean().item())
            if best >= 0.95:
                break
    moved = {path: (t.detach() - start[path]).abs().max().item() for path, t in _paths(params)}
    least = min(moved, key=moved.get)
    log(f"memorization B/16, 32 images, 11 classes, AdamW {MEMORIZE_LR:g}, bf16 mixed: train top-1 "
        f"{best:.6g} after {len(losses)} steps (gate 0.95); losses {[round(v, 4) for v in losses]}; "
        f"least-moved leaf {least}: max|d|={moved[least]:.6g} (gate >= lr)")
    if not (best >= 0.95 and np.isfinite(losses).all()):
        raise RuntimeError("fused_train did not memorize 32 images")
    if not moved[least] >= MEMORIZE_LR:
        raise RuntimeError(f"memorization left {least} (nearly) unchanged: its gradient is lost")


def phase_train_throughput(dev: torch.device, card: str) -> dict:
    """Phase 10: train img/s at B/16 batch 64 bf16 mixed precision,
    fused_train and eager (no remat), timed in turns; peak memory of each."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    cfg, b = VIT_B_16, 64
    x = torch.from_numpy(synth_images(b, cfg, seed=4)).to(dev)
    y = torch.arange(b, device=dev) * 7 % cfg.num_classes

    def make(ops):
        params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg), dev)
        opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-4)
        step = trainer.make_train_step(cfg, opt, get_ops(ops), remat=False,
                                       compute_dtype=torch.bfloat16)
        return lambda: float(step(params, x, y))

    peak = {}
    for ops in ("fused_train", "eager"):  # alone on the card, for its peak
        run = make(ops)
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        peak[ops] = torch.cuda.max_memory_allocated() / 2 ** 30
        del run
        torch.cuda.empty_cache()
    steps = {ops: make(ops) for ops in ("fused_train", "eager")}
    for run in steps.values():  # warm up
        run()
        run()
    times = {ops: [] for ops in steps}
    for _ in range(4):
        for ops in ("fused_train", "eager", "eager", "fused_train"):
            t0 = time.perf_counter()
            steps[ops]()  # float(loss) waits for the device
            times[ops].append(time.perf_counter() - t0)
    rates = {ops: b / statistics.median(t) for ops, t in times.items()}
    for ops, rate in rates.items():
        log(f"train throughput {ops} B/16 batch {b} bf16 mixed: {rate:.6g} img/s "
            f"(median of {len(times[ops])}, step {statistics.median(times[ops]) * 1e3:.6g} ms); "
            f"peak device memory {peak[ops]:.4g} GiB; {card}")
    return rates


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs an NVIDIA card")
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.ops.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = gpu_name_and_power()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    t0 = time.perf_counter()
    reused = _build.library_path().exists()
    _build.load_library()
    log(f"kernel build: {time.perf_counter() - t0:.3f} s "
        f"({'reused' if reused else 'built'} {_build.library_path().name})")

    summary = phase_kernels(kernel_cases(dev), KERNELS, 100)
    params = synth_params(VIT_B_16, 0)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches = phase_cli(params, workdir)

    images = synth_images(100, VIT_B_16, seed=1)
    phase_correctness(params, images, dev)
    phase_throughput(params, images, dev, card)
    del params, images
    torch.cuda.empty_cache()

    summary.update(phase_kernels(train_kernel_cases(dev), TRAIN_KERNELS, 64))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        train_launches = phase_train_cli(workdir)
    phase_train_correctness(dev)
    torch.cuda.empty_cache()
    phase_train_throughput(dev, card)

    # launches: the classify CLI's run for K1-K3, the train CLI's for K4-K7;
    # "paths" has both readings
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": (launches if name in KERNELS else train_launches)[name],
         "paths": {"classify": launches[name], "train": train_launches[name]}, **summary[name]}
        for name, (_, src, replaces) in {**KERNELS, **TRAIN_KERNELS}.items()
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
