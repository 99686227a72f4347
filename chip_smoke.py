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
     timed in turns, with the peak device memory of each;
 11. the regularized kernels (K10 out_residual_train, K11
     ln_mlp_residual_train, K12a ln_mlp_out_residual_bwd_train) against
     their plain twins at dropout 0.1 and drop-path 0.1, every output, bf16
     and fp32, batch 64 and 3, timed beside K4, K5 and K7; K10's exact zeros
     against the twin's (the mask pattern); K10/K11/K12a at zero rates bit
     for bit equal to K4/K5/K7; the kept fraction of each dropout site, read
     off the kernels' outputs, within 4 sigma of 1 - p;
 12. the train CLI with ``--dropout 0.1 --drop-path 0.1`` (otherwise as in
     8), with the counts set to 0 just before and read just after (12 each
     of K1, K10, K11, K12a, K6 per step; none of K2-K5, K7);
 13. regularized training correctness at full width: fp32 fused_train
     gradients against autograd through the regularized block's plain twin
     (``train_block_reference_2d``) under the same seeds, every leaf, 4
     images; bf16 mixed vs fp32 loss;
 14. train images/s at batch 64 mixed precision, timed in turns:
     regularized fused_train, unregularized fused_train, regularized eager,
     with the peak device memory of each (no mask is stored, so the
     regularized step's peak is within 1% of the unregularized one's);
 15. the long-sequence kernels (K13 flash_attention_fwd, K14
     flash_attention_bwd, K8 ln_mlp_residual_bwd, K9 out_residual_bwd)
     against their plain twins, every output, bf16 and fp32, at ViT-B/16
     @512 shapes (T = 1,025; batch 16, and a ragged batch of 3), K13/K14
     also at T = 2,048 batch 4; K13/K14 through strided views of the
     packed QKV, as the path calls them, each timed beside
     ``F.scaled_dot_product_attention`` (its forward for K13, its backward
     as forward + backward less forward for K14);
 16. the long classify path: ``InferenceEngine`` at B/16 @512, batch 16,
     bf16, ``fused``, with every count set to 0 just before and read just
     after (13 K3, 12 K13, 12 K2, no K1 per forward); fp32 fused vs fp32
     eager (4 images, <= 1e-3) and bf16 vs fp32 (comparator rule);
 17. the long train path: the trainer's step at @512 batch 16, bf16 mixed,
     ``fused_train``, counts set to 0 just before and read just after (12
     each of K13, K14, K4, K5, K8, K9 per step; no K1, K6, K7); fp32
     fused_train vs eager autograd gradients on every leaf (2 images), bf16
     mixed vs fp32 loss;
 18. images/s and peak device memory of the long classify forward and the
     long train step, fused against eager, timed in turns;
 19. where the 1,024-token switch sits: the K1 + K2 block against the
     K3 + QKV GEMM + K13 + K2 block at T = 577 and T = 1,025 (batch 16,
     bf16), timed in turns.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is the card's name and power limit, and the one before
that a JSON object with one entry per kernel: its time, its plain twin's,
the least time the card could take for the same work (bytes over 3.35 TB/s
or operations over the dtype's peak, whichever is larger), one PyTorch
call's time where one computes the same function, and its launches on the
main path.  Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
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

REG_KERNELS = {
    "out_residual_train": ("K10", "vit_tpu_torch/csrc/out_residual_train.cu",
                           "vit_tpu/ops/pallas/fused_block.py:377"),
    "ln_mlp_residual_train": ("K11", "vit_tpu_torch/csrc/ln_mlp_residual_train.cu",
                              "vit_tpu/ops/pallas/fused_block.py:531"),
    "ln_mlp_out_residual_bwd_train": ("K12a",
                                      "vit_tpu_torch/csrc/ln_mlp_out_residual_bwd_train.cu",
                                      "vit_tpu/ops/pallas/backward.py:502"),
}
LONG_KERNELS = {
    "flash_attention_fwd": ("K13", "vit_tpu_torch/csrc/flash_attention.cu",
                            "vit_tpu/ops/pallas/flash_attention.py:94"),
    "flash_attention_bwd": ("K14", "vit_tpu_torch/csrc/flash_attention_bwd.cu",
                            "vit_tpu/ops/pallas/flash_attention.py:271"),
    "ln_mlp_residual_bwd": ("K8", "vit_tpu_torch/csrc/ln_mlp_residual_bwd.cu",
                            "vit_tpu/ops/pallas/backward.py:218"),
    "out_residual_bwd": ("K9", "vit_tpu_torch/csrc/out_residual_bwd.cu",
                         "vit_tpu/ops/pallas/backward.py:779"),
}
LONG_IMAGE = 512  # ViT-B/16 @512: T = 1,025, past the 1,024-token switch
LONG_BATCHES = (16, 3)
LONG_T = 2048  # the flash cases' longest sequence, at batch LONG_T_BATCH
LONG_T_BATCH = 4
SWITCH_T = (577, 1025)  # where the switch phase times both blocks

REG_P = 0.1  # dropout, and the drop-path rate of the kernel cases
REG_SEED = 0x9E3779B9  # >= 2^31: the full uint32 range reaches the kernels
REG_FLAGS = ["--dropout", str(REG_P), "--drop-path", str(REG_P)]

# the card's peaks (H100 SXM data sheet): dense tensor-core bf16 and fp32
# FMA outside the tensor cores, and HBM3 bandwidth
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
HBM_BYTES_PER_S = 3.35e12


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


def case(tag, dtype, batch, fn, plain, args, flops, library=None, library_ms=None) -> dict:
    """One kernel-vs-twin case: the kernel and its twin on ``args``, the
    operations its function needs, and one PyTorch call computing the same
    function, where there is one (``library``, timed here; or
    ``library_ms``, a function that times it)."""
    return dict(tag=tag, dtype=dtype, batch=batch, kernel=lambda: fn(*args),
                plain=lambda: plain(*args), inputs=[a for a in args if torch.is_tensor(a)],
                flops=flops, library=library, library_ms=library_ms)


def _tag(dtype, b, rows):
    return f"{str(dtype).removeprefix('torch.')} batch {b} (rows {rows})"


def _rand(dev, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rn(*shape, scale=1.0, shift=0.0, dtype=torch.float32):
        x = torch.randn(*shape, generator=gen, device=dev) * scale + shift
        return x.to(dtype)

    return rn


def kernel_cases(dev: torch.device):
    """-> {kernel: [case]} for K1-K3 at B/16 shapes."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops.kernels import layer_norm as k3
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.ops.kernels import out_ln_mlp_residual as k2

    d, h, f, t = B16["d"], B16["heads"], B16["f"], B16["t"]
    rn = _rand(dev, 0)
    cases = {name: [] for name in KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for b in BATCHES:
            rows = b * t
            tag = _tag(dtype, b, rows)
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
            cases["ln_qkv_attn"].append(case(tag, dtype, b, k1.ln_qkv_attn, k1.ln_qkv_attn_plain,
                                             a1, 2 * rows * d * 3 * d + 4 * b * t * t * d))
            cases["out_ln_mlp_residual"].append(case(
                tag, dtype, b, k2.out_ln_mlp_residual, k2.out_ln_mlp_residual_plain, a2,
                2 * rows * d * d + 4 * rows * d * f))
            cases["layer_norm"].append(case(
                tag, dtype, b, k3.layer_norm, k3.layer_norm_plain, a3, 0,
                library=lambda a=a3: F.layer_norm(a[0], (d,), a[1], a[2], a[3])))
    return cases


def bound(flops: float, nbytes: float, dtype) -> tuple:
    """(ms, 'bytes' or 'operations'): the least time the card could take to
    move ``nbytes`` once and do ``flops`` at the dtype's peak."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_kernels(cases: dict, labels: dict, summary_batch: int) -> dict:
    """Phases 3, 7 and 11: kernel vs plain twin on every output, each held to
    TOLERANCE[dtype] x max(1, its own largest |value|).  -> {kernel:
    summary at bf16 ``summary_batch``}: error, kernel, twin and library
    times, and the bound from this case's inputs and outputs."""
    summary = {}
    for name, kcases in cases.items():
        for c in kcases:
            tag, dtype = c["tag"], c["dtype"]
            got, want = c["kernel"](), c["plain"]()
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
            ms, plain_ms = cuda_ms(c["kernel"]), cuda_ms(c["plain"])
            lib_ms = (cuda_ms(c["library"]) if c["library"]
                      else c["library_ms"]() if c["library_ms"] else None)
            bound_ms, bound_by = bound(c["flops"], _nbytes(c["inputs"]) + _nbytes(got), dtype)
            log(f"{labels[name][0]} {name} {tag}: {len(got)} output(s), max|d|={err:.6g} "
                f"(at most {worst:.3g} of its tol) kernel {ms:.6g} ms, plain {plain_ms:.6g} ms, "
                f"library {'none' if lib_ms is None else f'{lib_ms:.6g} ms'}, bound "
                f"{bound_ms:.6g} ms ({bound_by})")
            if dtype == torch.bfloat16 and c["batch"] == summary_batch:
                summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}
            del got, want
    return summary


def train_kernel_cases(dev: torch.device):
    """-> {kernel: [case]} for K4-K7 at B/16 training shapes."""
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_qkv_attn_bwd as k6
    from vit_tpu_torch.ops.kernels import out_residual as k4

    d, h, f, t = B16["d"], B16["heads"], B16["f"], B16["t"]
    rn = _rand(dev, 1)
    cases = {name: [] for name in TRAIN_KERNELS}
    mods = {"out_residual": k4, "ln_mlp_residual": k5, "ln_qkv_attn_bwd": k6,
            "ln_mlp_out_residual_bwd": k7}
    for dtype in (torch.bfloat16, torch.float32):
        for b in TRAIN_BATCHES:
            rows = b * t
            row = lambda scale=1.0: rn(rows, d, scale=scale, dtype=dtype)  # noqa: E731
            s1, b1n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5, dtype=dtype), rn(3 * d, scale=0.1, dtype=dtype)
            wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
            w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            x, ctx, x1, dy, dctx = row(2.0), row(), row(2.0), row(), row()
            args = {
                "out_residual": ((ctx, x, wo, bo), 2 * rows * d * d),
                "ln_mlp_residual": ((x1, s2, b2n, w1, bb1, w2, bb2, 1e-6, "exact"),
                                    4 * rows * d * f),
                "ln_qkv_attn_bwd": ((dctx, dy, x, s1, b1n, wqkv, bqkv, h, t, 1e-6),
                                    6 * rows * d * 3 * d + 10 * b * t * t * d),
                "ln_mlp_out_residual_bwd": ((dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, 1e-6, "exact"),
                                            10 * rows * d * f + 4 * rows * d * d),
            }
            for name, (a, flops) in args.items():
                cases[name].append(case(_tag(dtype, b, rows), dtype, b, getattr(mods[name], name),
                                        getattr(mods[name], f"{name}_plain"), a, flops))
    return cases


def reg_kernel_cases(dev: torch.device):
    """-> {kernel: [case]} for K10-K12a at B/16 training shapes, dropout and
    drop-path REG_P.  A row whose drop-path scale is 0 needs no GEMM work
    (its branch is dropped), so each bound counts the kept rows only."""
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd_train as k12
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_train as k11
    from vit_tpu_torch.ops.kernels import out_residual_train as k10

    d, f, t = B16["d"], B16["f"], B16["t"]
    rn = _rand(dev, 2)
    cases = {name: [] for name in REG_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        for b in TRAIN_BATCHES:
            rows = b * t
            tag = _tag(dtype, b, rows)
            row = lambda scale=1.0: rn(rows, d, scale=scale, dtype=dtype)  # noqa: E731
            s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
            w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
            x, ctx, x1, dy = row(2.0), row(), row(2.0), row()
            dp_a = drop_path_scale_rows(REG_SEED, 4, b, t, REG_P, device=dev)
            dp_m = drop_path_scale_rows(REG_SEED, 5, b, t, REG_P, device=dev)
            kept_a, kept_m = (int((dp != 0).sum()) for dp in (dp_a, dp_m))
            reg = (REG_SEED, REG_P)
            cases["out_residual_train"].append(case(
                tag, dtype, b, k10.out_residual_train, k10.out_residual_train_plain,
                (ctx, x, wo, bo, dp_a, *reg), 2 * kept_a * d * d))
            cases["ln_mlp_residual_train"].append(case(
                tag, dtype, b, k11.ln_mlp_residual_train, k11.ln_mlp_residual_train_plain,
                (x1, s2, b2n, w1, bb1, w2, bb2, dp_m, *reg, 1e-6, "exact"), 4 * kept_m * d * f))
            cases["ln_mlp_out_residual_bwd_train"].append(case(
                tag, dtype, b, k12.ln_mlp_out_residual_bwd_train,
                k12.ln_mlp_out_residual_bwd_train_plain,
                (dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, dp_m, dp_a, *reg, 1e-6, "exact"),
                10 * kept_m * d * f + 4 * kept_a * d * d))
    return cases


def _sdpa_bwd_ms(q, k, v, do) -> float:
    """K14's library time: ``F.scaled_dot_product_attention``'s forward +
    backward on copies of the same inputs, less its forward."""
    import torch.nn.functional as F

    qg, kg, vg = (t.detach().clone().requires_grad_(True) for t in (q, k, v))
    fwd = lambda: F.scaled_dot_product_attention(qg, kg, vg)  # noqa: E731
    both = lambda: torch.autograd.grad(fwd(), (qg, kg, vg), do)  # noqa: E731
    return cuda_ms(both) - cuda_ms(fwd)


def long_kernel_cases(dev: torch.device):
    """-> {kernel: [case]} for K13, K14, K8, K9 at B/16 @512 shapes (T =
    1,025; batch 16 and 3), and K13/K14 at T = 2,048 batch 4.  K13/K14 take
    strided (B, H, T, dh) views of a packed (B*T, 3D) QKV, as the path
    gives them."""
    import torch.nn.functional as F

    from vit_tpu_torch.ops.flash_attention import packed_views
    from vit_tpu_torch.ops.kernels import flash_attention as k13
    from vit_tpu_torch.ops.kernels import flash_attention_bwd as k14
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd as k8
    from vit_tpu_torch.ops.kernels import out_residual_bwd as k9

    d, h, f = B16["d"], B16["heads"], B16["f"]
    t512 = (LONG_IMAGE // 16) ** 2 + 1
    rn = _rand(dev, 4)
    cases = {name: [] for name in LONG_KERNELS}
    for dtype in (torch.bfloat16, torch.float32):
        shapes = [(b, t512) for b in LONG_BATCHES] + [(LONG_T_BATCH, LONG_T)]
        for b, t in shapes:
            rows, dh = b * t, d // h
            tag = _tag(dtype, b, rows) + f" T {t}"
            q, k, v = packed_views(rn(rows, 3 * d, dtype=dtype), b, t, h, 3)
            out, lse = k13.flash_attention_fwd_plain(q, k, v, True)
            do = rn(b, h, t, dh, dtype=dtype)
            cases["flash_attention_fwd"].append(case(
                tag, dtype, b, lambda *a: k13.flash_attention_fwd(*a, return_lse=True),
                lambda *a: k13.flash_attention_fwd_plain(*a, True), (q, k, v),
                4 * b * h * t * t * dh,
                library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(q, k, v)))
            cases["flash_attention_bwd"].append(case(
                tag, dtype, b, k14.flash_attention_bwd, k14.flash_attention_bwd_plain,
                (q, k, v, out, lse, do), 10 * b * h * t * t * dh,
                library_ms=lambda q=q, k=k, v=v, do=do: _sdpa_bwd_ms(q, k, v, do)))
            if t == LONG_T:
                continue
            row = lambda scale=1.0: rn(rows, d, scale=scale, dtype=dtype)  # noqa: E731
            s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
            w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
            w2 = rn(f, d, scale=f ** -0.5, dtype=dtype)
            wo = rn(d, d, scale=d ** -0.5, dtype=dtype)
            dy, x1, ctx = row(), row(2.0), row()
            cases["ln_mlp_residual_bwd"].append(case(
                tag, dtype, b, k8.ln_mlp_residual_bwd, k8.ln_mlp_residual_bwd_plain,
                (dy, x1, s2, b2n, w1, bb1, w2, 1e-6, "exact"), 10 * rows * d * f))
            cases["out_residual_bwd"].append(case(
                tag, dtype, b, k9.out_residual_bwd, k9.out_residual_bwd_plain,
                (dy, ctx, wo), 4 * rows * d * d))
    return cases


def _kept(frac: float, n: int, p: float, site: str) -> str:
    """Check a kept fraction against 1 - p within 4 sigma of n Bernoulli draws."""
    sigma = math.sqrt(p * (1 - p) / n)
    z = (frac - (1 - p)) / sigma
    if not abs(z) <= 4:
        raise RuntimeError(f"{site}: kept fraction {frac:.6g} is {z:.3g} sigma from {1 - p}")
    return f"{site} {frac:.6g} ({z:+.3g} sigma of {n})"


def phase_regularizer_checks(dev: torch.device) -> None:
    """Phase 11's exact checks at B/16 batch 64: K10's zeros are the twin's;
    at zero rates K10/K11/K12a equal K4/K5/K7 bit for bit; each dropout
    site's kept fraction, read off a kernel output, is within 4 sigma of
    1 - p (the drop-path sites from the row scales the kernels read)."""
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd_train as k12
    from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_train as k11
    from vit_tpu_torch.ops.kernels import out_residual as k4
    from vit_tpu_torch.ops.kernels import out_residual_train as k10

    d, f, t, b = B16["d"], B16["f"], B16["t"], 64
    rows, p, reg = b * t, REG_P, (REG_SEED, REG_P)
    rn = _rand(dev, 3)
    ones = torch.ones(rows, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).removeprefix("torch.")
        ctx, x1, dy = rn(rows, d, dtype=dtype), rn(rows, d, scale=2.0, dtype=dtype), rn(rows, d, dtype=dtype)
        wo, bo = rn(d, d, scale=d ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
        s2, b2n = rn(d, scale=0.2, shift=1.0, dtype=dtype), rn(d, scale=0.2, dtype=dtype)
        w1, bb1 = rn(d, f, scale=d ** -0.5, dtype=dtype), rn(f, scale=0.1, dtype=dtype)
        w2, bb2 = rn(f, d, scale=f ** -0.5, dtype=dtype), rn(d, scale=0.1, dtype=dtype)
        zero = torch.zeros(rows, d, dtype=dtype, device=dev)

        # the attention-out mask: K10 with a zero residual and no drop-path
        out = k10.out_residual_train(ctx, zero, wo, bo, ones, *reg)
        want = k10.out_residual_train_plain(ctx, zero, wo, bo, ones, *reg)
        if not torch.equal(out == 0, want == 0):
            raise RuntimeError(f"K10 {name}: its zeros differ from the twin's (the mask pattern)")
        sites = [_kept((out != 0).float().mean().item(), out.numel(), p, "attention-out")]

        # the MLP sites: K11 with x = 0, W1 = 0, b1 = 3 (so gelu(u) is one
        # constant), W2 = [I; 0], b2 = 0 -> out = round(gelu(3) m_in) m_out
        # on the first D inner columns; with W2 = 0, b2 = 1 -> out = m_out
        eye = torch.zeros(f, d, dtype=dtype, device=dev)
        eye[:d] = torch.eye(d, dtype=dtype, device=dev)
        zf = torch.zeros(d, f, dtype=dtype, device=dev)
        threes, zd = torch.full((f,), 3.0, dtype=dtype, device=dev), torch.zeros(d, dtype=dtype, device=dev)
        m_out = k11.ln_mlp_residual_train(zero, s2, b2n, zf, threes, torch.zeros_like(eye),
                                          torch.ones_like(zd), ones, *reg, 1e-6) != 0
        both = k11.ln_mlp_residual_train(zero, s2, b2n, zf, threes, eye, zd, ones, *reg, 1e-6) != 0
        if (both & ~m_out).any():
            raise RuntimeError(f"K11 {name}: an output the MLP-out mask drops is not zero")
        sites.append(_kept(m_out.float().mean().item(), m_out.numel(), p, "mlp-out"))
        n_out = int(m_out.sum())
        sites.append(_kept(int(both.sum()) / n_out, n_out, p, "mlp-inner"))
        for site in (4, 5):
            dp = drop_path_scale_rows(REG_SEED, site, b, t, p, device=dev)[::t]
            sites.append(_kept((dp != 0).float().mean().item(), b, p, f"drop-path site {site}"))
        log(f"K10/K11 {name} batch {b}: K10's zeros equal the twin's; kept fractions: "
            + ", ".join(sites))

        # zero rates: the gates compile out and dp multiplies by 1
        same = [
            torch.equal(k10.out_residual_train(ctx, x1, wo, bo, ones, REG_SEED, 0.0),
                        k4.out_residual(ctx, x1, wo, bo)),
            torch.equal(k11.ln_mlp_residual_train(x1, s2, b2n, w1, bb1, w2, bb2, ones, REG_SEED,
                                                  0.0, 1e-6),
                        k5.ln_mlp_residual(x1, s2, b2n, w1, bb1, w2, bb2, 1e-6)),
            all(torch.equal(a, c) for a, c in zip(
                k12.ln_mlp_out_residual_bwd_train(dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, ones,
                                                  ones, REG_SEED, 0.0, 1e-6),
                k7.ln_mlp_out_residual_bwd(dy, x1, ctx, s2, b2n, w1, bb1, w2, wo, 1e-6))),
        ]
        log(f"zero rates {name} batch {b}: K10 == K4 {same[0]}, K11 == K5 {same[1]}, "
            f"K12a == K7 {same[2]} (bit for bit)")
        if not all(same):
            raise RuntimeError("a regularized kernel at zero rates differs from its plain kernel")


def phase_cli(params, workdir: str) -> dict:
    """Phase 4: the classify CLI on the card, on ``params`` saved as an npz.
    -> launch counts of its run."""
    from vit_tpu_torch.cli.main import main
    from vit_tpu_torch.eval import comparator
    from vit_tpu_torch.io import checkpoint

    weights = f"{workdir}/params.npz"
    checkpoint.save_npz(params, weights)
    result = f"{workdir}/result.txt"
    buf = io.StringIO()
    wrappers = _reset_counts()
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
    if [r.index for r in comparator.parse_result_file(result)] != list(range(100)):
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
    from vit_tpu_torch.ops.kernels import wrapper

    return {name: wrapper(name) for name in (*KERNELS, *TRAIN_KERNELS, *REG_KERNELS, *LONG_KERNELS)}


def _reset_counts() -> dict:
    """Every wrapper by name, its launch count set to 0."""
    wrappers = all_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    return wrappers


def _expect_counts(wrappers: dict, want: dict, what: str) -> dict:
    """Read every count; fail unless ``want`` (the rest 0)."""
    launches = {name: fn.launches for name, fn in wrappers.items()}
    expected = {name: 0 for name in wrappers}
    expected.update(want)
    log(f"{what}: launches {launches}")
    if launches != expected:
        raise RuntimeError(f"{what}: expected launches {expected}, got {launches}")
    return launches


def _train_cli(workdir: str, extra) -> tuple:
    """The train CLI on the card (B/16, 5 steps, batch 64, fused_train, bf16
    mixed) with ``extra`` flags; every count set to 0 just before and read
    just after.  -> (launch counts, losses)."""
    from vit_tpu_torch.cli.train import main

    log_path = f"{workdir}/train{len(extra)}.jsonl"
    buf = io.StringIO()
    wrappers = _reset_counts()
    with contextlib.redirect_stdout(buf):
        rc = main([
            "--config", "vit_b_16", "--steps", str(TRAIN_STEPS), "--batch", "64",
            "--ops", "fused_train", "--mixed-precision", "--device", "cuda",
            "--log-jsonl", log_path, *extra,
        ])
    launches = {name: fn.launches for name, fn in wrappers.items()}
    tag = "train cli" + (" " + " ".join(extra) if extra else "")
    log("\n".join(f"{tag}: " + line for line in buf.getvalue().splitlines()))
    log(f"{tag}: rc {rc}, launches {launches}")
    if rc != 0:
        raise RuntimeError(f"train CLI {extra} exited {rc}")
    with open(log_path) as fh:
        losses = [json.loads(line)["loss"] for line in fh]
    if len(losses) != TRAIN_STEPS or not np.isfinite(losses).all():
        raise RuntimeError(f"train CLI {extra} logged {losses}, expected {TRAIN_STEPS} finite losses")
    return launches, losses


def phase_train_cli(workdir: str, extra=(), kernels=("ln_qkv_attn", *TRAIN_KERNELS)) -> dict:
    """Phases 8 and 12: 12 launches per step of each of ``kernels``, none of
    any other.  -> launch counts of the run."""
    launches, _ = _train_cli(workdir, list(extra))
    want = {name: 0 for name in launches}
    want.update({name: 12 * TRAIN_STEPS for name in kernels})
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


def _grads(cfg, tree, x, y, ops, compute_dtype, dev, rng_seed=None):
    """-> (loss, {leaf path: grad}) of one cross-entropy backward; with
    ``rng_seed``, dropout and drop-path draw from a generator of that seed."""
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    params = trainer.as_trainable(tree, dev, torch.float32)
    ops = get_ops(ops) if isinstance(ops, str) else ops
    loss_fn = trainer._make_loss_fn(cfg, ops, False, compute_dtype)
    rng = None if rng_seed is None else torch.Generator().manual_seed(rng_seed)
    loss = loss_fn(params, x, y, rng)
    loss.backward()
    return loss.item(), {path: t.grad for path, t in _paths(params)}


def _worst_leaf(got: dict, want: dict) -> tuple:
    """(worst ratio of max|d| to 1e-3 x max(1, max|g|), its leaf)."""
    worst, worst_leaf = 0.0, None
    for leaf, g in want.items():
        r = (got[leaf] - g).abs().max().item() / (1e-3 * max(1.0, g.abs().max().item()))
        if r > worst:
            worst, worst_leaf = r, leaf
    return worst, worst_leaf


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
    tree = params_from_numpy(synth_params(cfg, 0), "cpu")
    x = torch.from_numpy(synth_images(4, cfg, seed=3)).to(dev)
    y = torch.tensor([3, 141, 592, 653], device=dev)
    lf, gf = _grads(cfg, tree, x, y, "fused_train", None, dev)
    le, ge = _grads(cfg, tree, x, y, "eager", None, dev)
    worst, worst_leaf = _worst_leaf(gf, ge)
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


def phase_reg_correctness(dev: torch.device) -> None:
    """Phase 13: the regularized fused_train gradients (fp32, every leaf)
    against autograd through ``train_block_reference_2d`` — the same model
    with the kernels' block replaced by its plain twin, the same seeds, so
    the same masks — and the bf16 mixed loss against fp32."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.ops import trainable
    from vit_tpu_torch.ops.dispatch import get_ops

    cfg = dataclasses.replace(VIT_B_16, dropout=REG_P, drop_path=REG_P)
    fused = get_ops("fused_train")
    twin = dataclasses.replace(fused, name="fused_train_twin",
                               encoder_block_train=trainable.train_block_reference_2d)
    tree = params_from_numpy(synth_params(cfg, 0), "cpu")
    x = torch.from_numpy(synth_images(4, cfg, seed=3)).to(dev)
    y = torch.tensor([3, 141, 592, 653], device=dev)
    lf, gf = _grads(cfg, tree, x, y, fused, None, dev, rng_seed=5)
    lr_, gr = _grads(cfg, tree, x, y, twin, None, dev, rng_seed=5)
    worst, worst_leaf = _worst_leaf(gf, gr)
    log(f"regularized train grads fp32 fused_train vs autograd through the block's plain twin "
        f"(dropout {REG_P}, drop-path {REG_P}, same seeds), B/16, 4 images: loss {lf:.6g} vs "
        f"{lr_:.6g}; {len(gr)} leaves, worst {worst_leaf} at {worst:.3g} of its bound "
        f"(1e-3 x max(1, max|g|))")
    if worst > 1.0 or set(gf) != set(gr) or not np.isfinite(lf):
        raise RuntimeError("regularized fused_train gradients outside 1e-3 of the twin's autograd")
    del gf, gr
    lb, _ = _grads(cfg, tree, x, y, fused, torch.bfloat16, dev, rng_seed=5)
    log(f"regularized train loss bf16 mixed vs fp32: {lb:.6g} vs {lf:.6g}, |d|={abs(lb - lf):.6g} "
        f"(tol 2e-2)")
    if not abs(lb - lf) <= 2e-2:
        raise RuntimeError("regularized bf16 mixed-precision loss outside 2e-2 of fp32")


def _train_rates(dev, card: str, runs: dict, phase: str, base=None, b: int = 64) -> dict:
    """Train img/s at ``base`` (default B/16 @224) batch ``b`` bf16 mixed
    (no remat) of each run ``label: (ops, regularized)``, timed in turns,
    and the peak device memory of each alone on the card."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    base = base or VIT_B_16
    x = torch.from_numpy(synth_images(b, base, seed=4)).to(dev)
    y = torch.arange(b, device=dev) * 7 % base.num_classes

    def make(ops, regularized):
        cfg = (dataclasses.replace(base, dropout=REG_P, drop_path=REG_P) if regularized
               else base)
        params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg), dev)
        opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-4)
        step = trainer.make_train_step(cfg, opt, get_ops(ops), remat=False,
                                       compute_dtype=torch.bfloat16, use_dropout=regularized,
                                       rng=torch.Generator().manual_seed(0))
        return lambda: float(step(params, x, y))

    peak = {}
    for label, spec in runs.items():  # alone on the card, for its peak
        run = make(*spec)
        run()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run()
        peak[label] = torch.cuda.max_memory_allocated() / 2 ** 30
        del run
        torch.cuda.empty_cache()
    steps = {label: make(*spec) for label, spec in runs.items()}
    for run in steps.values():  # warm up
        run()
        run()
    times = {label: [] for label in steps}
    order = list(steps)
    for _ in range(4):
        for label in order + order[::-1]:
            t0 = time.perf_counter()
            steps[label]()  # float(loss) waits for the device
            times[label].append(time.perf_counter() - t0)
    rates = {label: b / statistics.median(t) for label, t in times.items()}
    for label, rate in rates.items():
        log(f"{phase} {label} {base.name} batch {b} bf16 mixed: {rate:.6g} img/s "
            f"(median of {len(times[label])}, step {statistics.median(times[label]) * 1e3:.6g} ms); "
            f"peak device memory {peak[label]:.6g} GiB; {card}")
    return rates, peak


def phase_train_throughput(dev: torch.device, card: str) -> dict:
    """Phase 10: fused_train and eager, unregularized."""
    return _train_rates(dev, card, {"fused_train": ("fused_train", False),
                                    "eager": ("eager", False)}, "train throughput")[0]


def phase_reg_throughput(dev: torch.device, card: str) -> dict:
    """Phase 14: regularized fused_train, unregularized fused_train and
    regularized eager; the regularized kernels store no mask, so their
    step's peak memory stays within 1% of the unregularized one's."""
    rates, peak = _train_rates(dev, card, {
        "fused_train regularized": ("fused_train", True),
        "fused_train": ("fused_train", False),
        "eager regularized": ("eager", True),
    }, "regularized train throughput")
    ratio = peak["fused_train regularized"] / peak["fused_train"]
    log(f"peak memory regularized / unregularized fused_train: {ratio:.6g} (gate <= 1.01)")
    if not ratio <= 1.01:
        raise RuntimeError("the regularized step's peak memory exceeds the unregularized one's by > 1%")
    return rates


def phase_long_inference(dev: torch.device) -> dict:
    """Phase 16: the long classify path through ``InferenceEngine``.
    -> launch counts of one bf16 forward of 16 images."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    params = synth_params(cfg, 0)
    images = synth_images(16, cfg, seed=5)
    fused16 = InferenceEngine(cfg, params, "bfloat16", "fused", dev, batch_pad=16)
    wrappers = _reset_counts()
    l16 = fused16.logits(images).cpu().numpy()
    torch.cuda.synchronize()
    launches = _expect_counts(
        wrappers, {"layer_norm": 13, "flash_attention_fwd": 12, "out_ln_mlp_residual": 12},
        f"long classify {cfg.name} (T {cfg.seq_len}) batch 16 bf16 fused, one forward")
    del fused16
    if l16.shape != (16, cfg.num_classes) or not np.isfinite(l16).all():
        raise RuntimeError(f"long bf16 logits: shape {l16.shape} or non-finite")

    fused32 = InferenceEngine(cfg, params, "float32", "fused", dev, batch_pad=1)
    f32 = fused32.logits(images).cpu().numpy()
    del fused32
    eager32 = InferenceEngine(cfg, params, "float32", "eager", dev, batch_pad=1)
    e32 = eager32.logits(images[:4]).cpu().numpy()
    del eager32
    torch.cuda.empty_cache()
    dev_eager = float(np.abs(f32[:4] - e32).max())
    log(f"long fp32 fused vs fp32 eager (card, TF32 off), {cfg.name}, 4 images: "
        f"max|d logit|={dev_eager:.6g} (tol 1e-3)")
    if not dev_eager <= 1e-3:
        raise RuntimeError("long fp32 fused logits outside 1e-3 of the eager path")
    p32, p16 = _probs(f32), _probs(l16)
    l32, lb = p32.argmax(-1), p16.argmax(-1)
    n = len(l32)
    top2 = np.sort(p32, -1)[:, -2:]
    decisive = (top2[:, 1] - top2[:, 0]) > 0.01
    n_bad = int(((lb != l32) & decisive).sum())
    prob_dev = float(np.abs(p16[np.arange(n), lb] - p32[np.arange(n), l32]).max())
    log(f"long bf16 fused vs fp32 fused, {n} images: {int(decisive.sum())} decisive, {n_bad} "
        f"decisive label mismatches (tol 0), top-prob max|d|={prob_dev:.6g} (tol 0.01)")
    if n_bad or not prob_dev <= 0.01:
        raise RuntimeError("long bf16 fused path fails the comparator rule against fp32")
    return launches


def phase_long_train(dev: torch.device) -> dict:
    """Phase 17: the trainer's step on the long path, its launches, and
    its gradients against eager autograd.  -> launch counts of one step."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    b = 16
    x = torch.from_numpy(synth_images(b, cfg, seed=6)).to(dev)
    y = torch.arange(b, device=dev) * 13 % cfg.num_classes
    params = trainer.as_trainable(vit.init_params(torch.Generator().manual_seed(0), cfg), dev)
    opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-4)
    step = trainer.make_train_step(cfg, opt, get_ops("fused_train"), remat=False,
                                   compute_dtype=torch.bfloat16)
    step(params, x, y)  # warm up
    torch.cuda.synchronize()
    wrappers = _reset_counts()
    loss = float(step(params, x, y))
    launches = _expect_counts(
        wrappers, {name: 12 for name in ("flash_attention_fwd", "flash_attention_bwd",
                                         "out_residual", "ln_mlp_residual",
                                         "ln_mlp_residual_bwd", "out_residual_bwd")},
        f"long train {cfg.name} (T {cfg.seq_len}) batch {b} bf16 mixed fused_train, one step")
    if not np.isfinite(loss):
        raise RuntimeError(f"long train step loss {loss}")
    del params, opt, step
    torch.cuda.empty_cache()

    tree = params_from_numpy(synth_params(cfg, 0), "cpu")
    x2 = torch.from_numpy(synth_images(2, cfg, seed=7)).to(dev)
    y2 = torch.tensor([3, 141], device=dev) % cfg.num_classes
    lf, gf = _grads(cfg, tree, x2, y2, "fused_train", None, dev)
    le, ge = _grads(cfg, tree, x2, y2, "eager", None, dev)
    worst, worst_leaf = _worst_leaf(gf, ge)
    log(f"long train grads fp32 fused_train vs eager autograd (card, TF32 off), {cfg.name}, "
        f"2 images: loss {lf:.6g} vs {le:.6g}; {len(ge)} leaves, worst {worst_leaf} at "
        f"{worst:.3g} of its bound (1e-3 x max(1, max|g|))")
    if worst > 1.0 or set(gf) != set(ge) or not np.isfinite(lf):
        raise RuntimeError("long fused_train gradients outside 1e-3 of eager autograd")
    del gf, ge
    lb, _ = _grads(cfg, tree, x2, y2, "fused_train", torch.bfloat16, dev)
    log(f"long train loss bf16 mixed vs fp32 fused_train: {lb:.6g} vs {lf:.6g}, "
        f"|d|={abs(lb - lf):.6g} (tol 2e-2)")
    if not abs(lb - lf) <= 2e-2:
        raise RuntimeError("long bf16 mixed-precision loss outside 2e-2 of fp32")
    return launches


def phase_long_throughput(dev: torch.device, card: str) -> None:
    """Phase 18: long classify img/s and peak memory (fused vs eager, batch
    16 bf16, in turns), then the long train step's (fused_train vs eager)."""
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = VIT_B_16.with_image_size(LONG_IMAGE)
    params = synth_params(cfg, 0)
    x = torch.from_numpy(synth_images(16, cfg, seed=8)).to(dev, torch.bfloat16)
    engines, peak = {}, {}
    for ops in ("fused", "eager"):
        engines[ops] = InferenceEngine(cfg, params, "bfloat16", ops, dev, batch_pad=16)
        engines[ops].logits(x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engines[ops].logits(x)
        peak[ops] = torch.cuda.max_memory_allocated() / 2 ** 30
    times = {ops: [] for ops in engines}
    for _ in range(4):
        for ops in ("fused", "eager", "eager", "fused"):
            t0 = time.perf_counter()
            engines[ops].logits(x)
            torch.cuda.synchronize()
            times[ops].append(time.perf_counter() - t0)
    for ops, ts in times.items():
        log(f"long classify throughput {ops} {cfg.name} batch 16 bf16: "
            f"{16 / statistics.median(ts):.6g} img/s (median of {len(ts)}, forward "
            f"{statistics.median(ts) * 1e3:.6g} ms); peak device memory {peak[ops]:.6g} GiB; {card}")
    del engines
    torch.cuda.empty_cache()
    _train_rates(dev, card, {"fused_train": ("fused_train", False), "eager": ("eager", False)},
                 "long train throughput", base=cfg, b=16)


def phase_switch(dev: torch.device, card: str) -> None:
    """Phase 19: the K1 + K2 block against the long block (K3 + QKV GEMM +
    K13 + K2) at T = 577 and 1,025, B/16 width, batch 16, bf16, in turns.
    The switch stays at 1,024, so that both packages route alike."""
    from vit_tpu_torch.ops import fused_block
    from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn
    from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import out_ln_mlp_residual

    d, h, f = B16["d"], B16["heads"], B16["f"]
    rn = _rand(dev, 9)
    dt = torch.bfloat16
    blk = {"ln1_scale": rn(d, scale=0.2, shift=1.0, dtype=dt), "ln1_bias": rn(d, scale=0.2, dtype=dt),
           "wqkv": rn(d, 3 * d, scale=d ** -0.5, dtype=dt), "bqkv": rn(3 * d, scale=0.1, dtype=dt),
           "wo": rn(d, d, scale=d ** -0.5, dtype=dt), "bo": rn(d, scale=0.1, dtype=dt),
           "ln2_scale": rn(d, scale=0.2, shift=1.0, dtype=dt), "ln2_bias": rn(d, scale=0.2, dtype=dt),
           "w1": rn(d, f, scale=d ** -0.5, dtype=dt), "b1": rn(f, scale=0.1, dtype=dt),
           "w2": rn(f, d, scale=f ** -0.5, dtype=dt), "b2": rn(d, scale=0.1, dtype=dt)}

    def k1k2(x, t):  # what fused_encoder_block runs up to the switch
        ctx = ln_qkv_attn(x, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["bqkv"], h, t,
                          1e-6)
        return out_ln_mlp_residual(ctx, x, blk["wo"], blk["bo"], blk["ln2_scale"],
                                   blk["ln2_bias"], blk["w1"], blk["b1"], blk["w2"], blk["b2"],
                                   1e-6)

    for t in SWITCH_T:
        x = rn(16 * t, d, scale=2.0, dtype=dt)
        short = lambda: k1k2(x, t)  # noqa: E731
        long = lambda: fused_block._long_seq_block(x, blk, h, t, 1e-6, "exact")  # noqa: E731
        err = (short().float() - long().float()).abs().max().item()
        ms = {"K1+K2": [], "K3+GEMM+K13+K2": []}
        for _ in range(3):
            for label, fn in (("K1+K2", short), ("K3+GEMM+K13+K2", long),
                              ("K3+GEMM+K13+K2", long), ("K1+K2", short)):
                ms[label].append(cuda_ms(fn, warmup=1, iters=5))
        a, b = (statistics.median(v) for v in ms.values())
        log(f"switch at T {t}, B/16 batch 16 bf16: K1+K2 block {a:.6g} ms, K3+GEMM+K13+K2 "
            f"block {b:.6g} ms (ratio {b / a:.6g}); outputs max|d|={err:.6g}; {card}")


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
        launches = {"classify": phase_cli(params, workdir)}

    images = synth_images(100, VIT_B_16, seed=1)
    phase_correctness(params, images, dev)
    phase_throughput(params, images, dev, card)
    del params, images
    torch.cuda.empty_cache()

    summary.update(phase_kernels(train_kernel_cases(dev), TRAIN_KERNELS, 64))
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["train"] = phase_train_cli(workdir)
    phase_train_correctness(dev)
    torch.cuda.empty_cache()
    phase_train_throughput(dev, card)
    torch.cuda.empty_cache()

    summary.update(phase_kernels(reg_kernel_cases(dev), REG_KERNELS, 64))
    phase_regularizer_checks(dev)
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches["train_regularized"] = phase_train_cli(
            workdir, REG_FLAGS, ("ln_qkv_attn", "ln_qkv_attn_bwd", *REG_KERNELS))
    phase_reg_correctness(dev)
    torch.cuda.empty_cache()
    phase_reg_throughput(dev, card)
    torch.cuda.empty_cache()

    summary.update(phase_kernels(long_kernel_cases(dev), LONG_KERNELS, LONG_BATCHES[0]))
    torch.cuda.empty_cache()
    launches["classify_long"] = phase_long_inference(dev)
    torch.cuda.empty_cache()
    launches["train_long"] = phase_long_train(dev)
    torch.cuda.empty_cache()
    phase_long_throughput(dev, card)
    torch.cuda.empty_cache()
    phase_switch(dev, card)

    # launches: the classify CLI's run for K1-K3, the train CLI's for K4-K7,
    # the regularized train CLI's for K10-K12a, the long classify forward's
    # for K13, the long train step's for K14, K8, K9; "paths" has every
    # reading
    path_of = {**{k: "classify" for k in KERNELS}, **{k: "train" for k in TRAIN_KERNELS},
               **{k: "train_regularized" for k in REG_KERNELS},
               **{k: "train_long" for k in LONG_KERNELS}, "flash_attention_fwd": "classify_long"}
    all_kernels = {**KERNELS, **TRAIN_KERNELS, **REG_KERNELS, **LONG_KERNELS}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[path_of[name]][name],
         "paths": {path: counts[name] for path, counts in launches.items()}, **summary[name]}
        for name, (_, src, replaces) in all_kernels.items()
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
