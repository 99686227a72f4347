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
  6. images/s at batch 100 bf16, fused and eager, timed in turns.

The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it is a JSON object with one entry per kernel.  Imports
nothing of JAX.
"""

from __future__ import annotations

import contextlib
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


def phase_kernels(dev: torch.device) -> dict:
    """Phase 3: kernel vs plain twin.  -> {kernel: summary at bf16 batch 100}."""
    summary = {}
    for name, cases in kernel_cases(dev).items():
        for tag, dtype, b, kernel_fn, plain_fn in cases:
            got, want = kernel_fn().float(), plain_fn().float()
            torch.cuda.synchronize()
            if not torch.isfinite(got).all():
                raise RuntimeError(f"{name} {tag}: non-finite kernel output")
            err = (got - want).abs().max().item()
            tol = TOLERANCE[dtype] * max(1.0, want.abs().max().item())
            ms, plain_ms = cuda_ms(kernel_fn), cuda_ms(plain_fn)
            log(f"{KERNELS[name][0]} {name} {tag}: max|d|={err:.6g} (tol {tol:.6g}) "
                f"kernel {ms:.6g} ms, plain {plain_ms:.6g} ms")
            if not err <= tol:
                raise RuntimeError(f"{name} {tag}: kernel disagrees with its plain twin")
            if dtype == torch.bfloat16 and b == 100:
                summary[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    return summary


def phase_cli(workdir: str) -> dict:
    """Phase 4: the classify CLI on the card.  -> launch counts of its run."""
    from vit_tpu.config import VIT_B_16
    from vit_tpu.eval import comparator
    from vit_tpu.io.weights import save_reference_weights, synth_reference_tensors
    from vit_tpu_torch.cli.main import main
    from vit_tpu_torch.ops.kernels import layer_norm as k3
    from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
    from vit_tpu_torch.ops.kernels import out_ln_mlp_residual as k2

    wdir = f"{workdir}/Network"
    save_reference_weights(synth_reference_tensors(VIT_B_16, 0), wdir)
    result = f"{workdir}/result.txt"
    wrappers = {
        "ln_qkv_attn": k1.ln_qkv_attn,
        "out_ln_mlp_residual": k2.out_ln_mlp_residual,
        "layer_norm": k3.layer_norm,
    }
    buf = io.StringIO()
    for fn in wrappers.values():
        fn.launches = 0
    with contextlib.redirect_stdout(buf):
        rc = main([
            "--weights", wdir, "--synth", "100", "--ops", "fused", "--dtype", "bfloat16",
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
    if launches != {"ln_qkv_attn": 12, "out_ln_mlp_residual": 12, "layer_norm": 1}:
        raise RuntimeError(f"expected 12/12/1 kernel launches per forward, got {launches}")
    return launches


def _probs(logits: np.ndarray) -> np.ndarray:
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def phase_correctness(params, images: np.ndarray, dev: torch.device) -> None:
    """Phase 5: fused vs eager (card, fp32), vs eager fp64 (CPU), bf16 vs fp32."""
    from vit_tpu.config import VIT_B_16
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
    from vit_tpu.config import VIT_B_16
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


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: chip_smoke needs an NVIDIA card")
    from vit_tpu.config import VIT_B_16
    from vit_tpu.io.images import synth_images
    from vit_tpu.io.weights import params_from_tensors, synth_reference_tensors
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

    summary = phase_kernels(dev)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        launches = phase_cli(workdir)

    params = params_from_tensors(synth_reference_tensors(VIT_B_16, 0), VIT_B_16)
    images = synth_images(100, VIT_B_16, seed=1)
    phase_correctness(params, images, dev)
    phase_throughput(params, images, dev, card)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **summary[name]}
        for name, (_, src, replaces) in KERNELS.items()
    ]
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
