"""Time the port's kernels in two checkouts of the repo, each in its own
process, in turns, on one card:

    python3 -m vit_tpu_torch.cli.compare_kernels PARENT_DIR . [--rounds 2]

runs PARENT_DIR, ., ., PARENT_DIR per round (each checkout builds its own
kernels into its own ``build/``) and prints each process's times, then the
median per checkout.  K1 and K2 run at B/16 batch 100 (the classify path),
K3 at 19,700 and 16,400 rows (the final LayerNorm @224 batch 100 and @512
batch 16; also as device time),
and K5's partial form there too at rank 0's shard of tp 2 (F/2 hidden
columns) where the checkout has it; K4, K5, K7 and K6 at batch 64 (the train step; K6 also with token merging's
bias and no residual join at batch 64 T 171), K10, K11 and K12a too where the
checkout has them (dropout and drop-path 0.1), K8 at @512 batch 16 (16,400
rows, the long train step's) and K12b at batch 64 T 171 (the regularized
ToMe step's first merged layer, dropout and drop-path 0.1) where it has
those, K9 at @512 batch 16 and at batch 64 T 171 (the long and the ToMe
steps' out_proj backward) and K12c at batch 64 T 171 (dropout and
drop-path 0.1), the W8A8 K15, K16 and K17 at
batch 100 where it has those, K19 (the kernel study's int8-attention
kernel) there with int8 p·v and with p·v in bf16, K18a (bf16, the tanh-form erf) and K18b at
rank 0's shard of batch 100 for tp 2 and 4 (these seven also as device
time, the kernels' durations in a profiler trace), K21 and K22 (the per-op attention and MLP) at
batch 100 T 197,
and K14 and K13 (the flash-attention backward and forward) at @512 batch 16
(T 1,025), on strided views of a packed QKV as their paths give them, K13
beside ``F.scaled_dot_product_attention``'s forward, and K20 (the fused
AdamW) as one step over ViT-B/16's 20 fp32 leaves beside
``torch.optim.AdamW(fused=True).step()``, where it has those; bf16, CUDA
events, median of 20 launches after 5; K1 also with token merging's hooks at
batch 100 T 158 where the checkout has them.  The two optimizer steps also
report their device time (the kernels' durations in a torch.profiler
trace) and their host time per call.  ``--steps`` times the paths instead
of the kernels, each checkout's own code end to end: the bf16 ``fused``
and ``quant`` forwards at B/16 @224 batch 100 (``InferenceEngine.logits``),
the same at ToMe r = 13, and the bf16 mixed
``fused_train`` steps at @224 batch 64 plain and at dropout and drop-path
0.1, at ToMe r = 13 plain and at dropout and drop-path 0.1, and at @512
batch 16, each as its host wall time (median of 12 after 3, ending in a
synchronize) and its device kernels' time (a profiler trace of 3), the
latter steadier where the host is shared.  ``--sass SOURCE ...``
first compares the machine code each checkout compiles from those sources,
kernel by kernel: those of A that B compiles to the same instructions,
those it compiles differently, those it no longer has (a redesigned
kernel's old form), and those it adds (a new template instance, a hook's
variant, a redesigned kernel).  ``--rounds 0`` compares the machine code
only.  Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

# run with the checkout as the working directory, so that its
# vit_tpu_torch is the one imported; uses only wrapper signatures that every
# checkout since the training slice shares
TIMER = r"""
import importlib, inspect, json, statistics, time, torch
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
gen = torch.Generator(device=dev).manual_seed(0)
d, h, f, t, eps = 768, 12, 3072, 197, 1e-6

def rn(*shape, scale=1.0, shift=0.0):
    return (torch.randn(*shape, generator=gen, device=dev) * scale + shift).to(torch.bfloat16)

def ms(fn):
    for _ in range(5):
        fn()
    out = []
    for _ in range(20):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record(); fn(); b.record(); b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)

def device_ms(fn, steps=10):
    # the kernels' own durations in a profiler trace, per call (annotations
    # such as Optimizer.step's also sit on the device timeline: not counted)
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(); torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events()
          if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    return sum(e.time_range.elapsed_us() for e in ks) / 1e3 / steps

def host_ms(fn, n=50):
    # the host's time per call, enqueueing without waiting for the device
    fn(); torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e3

def k(name, module=None):
    try:
        return getattr(importlib.import_module(f"vit_tpu_torch.ops.kernels.{module or name}"), name)
    except (ModuleNotFoundError, AttributeError):
        return None

s, bb = rn(d, scale=0.2, shift=1.0), rn(d, scale=0.2)
wqkv, bqkv = rn(d, 3 * d, scale=d ** -0.5), rn(3 * d, scale=0.1)
wo, bo = rn(d, d, scale=d ** -0.5), rn(d, scale=0.1)
w1, b1 = rn(d, f, scale=d ** -0.5), rn(f, scale=0.1)
w2, b2 = rn(f, d, scale=f ** -0.5), rn(d, scale=0.1)
times = {}
rows = 100 * t
x, ctx = rn(rows, d, scale=2.0), rn(rows, d)
times["K1"] = ms(lambda: k("ln_qkv_attn")(x, s, bb, wqkv, bqkv, h, t, eps))
times["K2"] = ms(lambda: k("out_ln_mlp_residual")(ctx, x, wo, bo, s, bb, w1, b1, w2, b2, eps, "exact"))
k3 = k("layer_norm")
for rows_ln in (100 * t, 16 * 1025):  # the final LayerNorm @224 batch 100 and @512 batch 16
    xl = rn(rows_ln, d, scale=2.0)
    times[f"K3 rows {rows_ln}"] = ms(lambda: k3(xl, s, bb, eps))
    times[f"K3 rows {rows_ln} device"] = device_ms(lambda: k3(xl, s, bb, eps))
    del xl
k5 = k("ln_mlp_residual")
if "partial" in inspect.signature(k5).parameters:  # rank 0's shard at tp 2
    sh = (w1[:, :f // 2].contiguous(), b1[:f // 2].contiguous(), w2[:f // 2].contiguous())
    times["K5 partial tp2"] = ms(lambda: k5(x, s, bb, *sh, None, eps, "exact", partial=True))
if k("kmean_plain", "ln_qkv_attn") is not None:  # the ToMe hooks, at a merged T
    tm = 158
    xm = rn(100 * tm, d, scale=2.0)
    ls = torch.log(torch.randint(1, 6, (100, tm), generator=gen, device=dev).float())
    times["K1 hooked"] = ms(lambda: k("ln_qkv_attn")(xm, s, bb, wqkv, bqkv, h, tm, eps,
                                                    log_size=ls, return_kmean=True))
rows = 64 * t
x, ctx, dy = rn(rows, d, scale=2.0), rn(rows, d), rn(rows, d)
times["K4"] = ms(lambda: k("out_residual")(ctx, x, wo, bo))
times["K5"] = ms(lambda: k("ln_mlp_residual")(x, s, bb, w1, b1, w2, b2, eps, "exact"))
times["K7"] = ms(lambda: k("ln_mlp_out_residual_bwd")(dy, x, ctx, s, bb, w1, b1, w2, wo, eps, "exact"))
k6 = k("ln_qkv_attn_bwd")
times["K6"] = ms(lambda: k6(ctx, dy, x, s, bb, wqkv, bqkv, h, t, eps))
tm = 171  # the ToMe train step's first merged layer: the bias, no residual join
xm, dm = rn(64 * tm, d, scale=2.0), rn(64 * tm, d)
ls = torch.log(torch.randint(1, 6, (64, tm), generator=gen, device=dev).float())
times["K6 hooked"] = ms(lambda: k6(dm, None, xm, s, bb, wqkv, bqkv, h, tm, eps, log_size=ls))
del xm, dm
if k("out_residual_train") is not None:
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    dpa, dpm = (drop_path_scale_rows(7, site, 64, t, 0.1, device=dev) for site in (4, 5))
    times["K10"] = ms(lambda: k("out_residual_train")(ctx, x, wo, bo, dpa, 7, 0.1))
    times["K11"] = ms(lambda: k("ln_mlp_residual_train")(x, s, bb, w1, b1, w2, b2, dpm, 7, 0.1, eps))
    times["K12a"] = ms(lambda: k("ln_mlp_out_residual_bwd_train")(
        dy, x, ctx, s, bb, w1, b1, w2, wo, dpm, dpa, 7, 0.1, eps))
k8, k12b = k("ln_mlp_residual_bwd"), k("ln_mlp_residual_bwd_train")
if k8 is not None:
    x8, dy8 = rn(16 * 1025, d, scale=2.0), rn(16 * 1025, d)
    times["K8"] = ms(lambda: k8(dy8, x8, s, bb, w1, b1, w2, eps, "exact"))
    del x8, dy8
if k12b is not None:
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    xm, dym = rn(64 * 171, d, scale=2.0), rn(64 * 171, d)
    dpm = drop_path_scale_rows(7, 5, 64, 171, 0.1, device=dev)
    times["K12b"] = ms(lambda: k12b(dym, xm, s, bb, w1, b1, w2, dpm, 7, 0.1, eps))
    del xm, dym
k9, k12c = k("out_residual_bwd"), k("out_residual_bwd_train")
if k9 is not None:  # dx1 and ctx at the long step's and the ToMe step's rows
    for b9, t9 in ((16, 1025), (64, 171)):
        dx9, ctx9 = rn(b9 * t9, d), rn(b9 * t9, d)
        times[f"K9 b{b9} T {t9}"] = ms(lambda: k9(dx9, ctx9, wo))
    if k12c is not None:
        from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
        dpa = drop_path_scale_rows(7, 4, 64, 171, 0.1, device=dev)
        times["K12c b64 T 171"] = ms(lambda: k12c(dx9, ctx9, wo, dpa, 7, 0.1))
    del dx9, ctx9
if k("ln_qkv_attn_q8") is not None:
    from vit_tpu_torch.ops.quant import quantize_weight
    rows = 100 * t
    x, ctx = rn(rows, d, scale=2.0), rn(rows, d)
    (wq, ws), (w1q, w1s), (w2q, w2s) = (quantize_weight(w) for w in (wqkv, w1, w2))
    mlp = (s, bb, w1q, w1s, b1, w2q, w2s, b2, eps, "exact")
    for name, fn in (("K15", lambda: k("ln_qkv_attn_q8")(x, s, bb, wq, ws, bqkv, h, t, eps)),
                     ("K16", lambda: k("out_ln_mlp_residual_q8")(ctx, x, wo, bo, *mlp)),
                     ("K17", lambda: k("ln_mlp_residual_q8")(x, *mlp))):
        times[name] = ms(fn)
        times[f"{name} device"] = device_ms(fn)
    k19 = k("ln_qkv_attn_q8a", "ln_qkv_attn_q8")
    for name, qpv in (("K19", True), ("K19 q.k only", False)):
        fn = lambda: k19(x, s, bb, wq, ws, bqkv, h, t, eps, quant_pv=qpv)
        times[name] = ms(fn)
        times[f"{name} device"] = device_ms(fn)
k18a, k18b = k("ln_fc1_gelu_q8"), k("fc2_q8_partial")
if k18a is not None and k18b is not None:  # rank 0's shard of the tp W8A8 MLP
    from vit_tpu_torch.ops.quant import quantize_weight
    x = rn(100 * t, d, scale=2.0)
    (w1q, w1s), (w2q, _) = quantize_weight(w1), quantize_weight(w2)
    for tp in (2, 4):
        c = slice(0, f // tp)
        a18 = (x, s, bb, w1q[:, c].contiguous(), w1s[c].contiguous(), b1[c].contiguous(), eps,
               "exact", True)
        mid = k18a(*a18)
        mmax = mid.abs().amax(-1, keepdim=True)
        mscale = torch.clamp(mmax / torch.full_like(mmax, 127.0), min=1e-12)
        w2c = w2q[c].contiguous()
        for name, fn in ((f"K18a tp{tp}", lambda: k18a(*a18)),
                         (f"K18b tp{tp}", lambda: k18b(mid, mscale, w2c))):
            times[name] = ms(fn)
            times[f"{name} device"] = device_ms(fn)
        del mid
k21, k14 = k("scaled_dot_product_attention", "attention"), k("flash_attention_bwd")
k13, k20 = k("flash_attention_fwd", "flash_attention"), k("adamw_update", "adamw")
if k21 is not None or k14 is not None or k13 is not None:
    import torch.nn.functional as F
    from vit_tpu_torch.ops.flash_attention import packed_views
if k21 is not None:
    b = 100
    q, kk, v = packed_views(rn(b * t, 3 * d), b, t, h, 3)
    o = packed_views(torch.empty(b * t, d, dtype=torch.bfloat16, device=dev), b, t, h, 1)[0]
    times["K21"] = ms(lambda: k21(q, kk, v, out=o))
    del q, kk, v, o
k22 = k("mlp")
if k22 is not None:  # the per-op MLP on the LN2 output, (batch, T, D)
    x = rn(100, t, d, scale=2.0)
    times["K22"] = ms(lambda: k22(x, w1, b1, w2, b2))
if k14 is not None:
    b, t = 16, 1025
    qkv, g = rn(b * t, 3 * d), rn(b * t, d)
    q, kk, v = packed_views(qkv, b, t, h, 3)
    o = packed_views(torch.empty(b * t, d, dtype=torch.bfloat16, device=dev), b, t, h, 1)[0]
    _, lse = k("flash_attention_fwd", "flash_attention")(q, kk, v, out=o, return_lse=True)
    (do,) = packed_views(g, b, t, h, 1)
    grads = packed_views(torch.empty_like(qkv), b, t, h, 3)
    times["K14"] = ms(lambda: k14(q, kk, v, o, lse, do, *grads))
if k13 is not None:
    b, t = 16, 1025
    q, kk, v = packed_views(rn(b * t, 3 * d), b, t, h, 3)
    o = packed_views(torch.empty(b * t, d, dtype=torch.bfloat16, device=dev), b, t, h, 1)[0]
    times["K13"] = ms(lambda: k13(q, kk, v, out=o, return_lse=True))
    times["SDPA fwd"] = ms(lambda: F.scaled_dot_product_attention(q, kk, v))
if k20 is not None:
    import dataclasses
    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.models.vit import init_params
    from vit_tpu_torch.runtime.trainer import leaves
    one = init_params(torch.Generator().manual_seed(0), dataclasses.replace(VIT_B_16, depth=1))
    one["blocks"] = {n: x.expand(VIT_B_16.depth, *x.shape[1:]) for n, x in one["blocks"].items()}
    ps = [x.to(dev).contiguous() for x in leaves(one)]  # B/16's 20 fp32 leaves
    gs = [torch.randn(x.shape, generator=gen, device=dev) * 1e-2 for x in ps]
    mu, nu = ([torch.zeros_like(x) for x in ps] for _ in range(2))
    ref = [x.clone().requires_grad_(True) for x in ps]
    for x, gx in zip(ref, gs):
        x.grad = gx
    steps = {"K20": lambda: k20(gs, ps, mu, nu, 1, 1e-3, weight_decay=0.05),
             "AdamW fused": torch.optim.AdamW(ref, lr=1e-3, weight_decay=0.05, fused=True).step}
    for name, step in steps.items():
        times[name] = ms(step)
        times[f"{name} device"] = device_ms(step)
        times[f"{name} host"] = host_ms(step)
print(json.dumps(times))
"""


# --steps: one process's end-to-end times (public entry points only)
STEPS = r"""
import dataclasses, json, statistics, time, torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile
from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.io.images import synth_images
from vit_tpu_torch.io.params import params_to_numpy
from vit_tpu_torch.models import tome, vit
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.runtime import trainer
from vit_tpu_torch.runtime.engine import InferenceEngine
torch.backends.cuda.matmul.allow_tf32 = False
dev = torch.device("cuda", 0)
times = {}

def wall_and_device(name, fn):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(12):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
    ks = [e for e in prof.events()
          if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    times[name] = statistics.median(walls)
    times[name + " device"] = sum(e.time_range.elapsed_us() for e in ks) / 3e3

def init(cfg):
    return vit.init_params(torch.Generator().manual_seed(0), cfg)

x = torch.from_numpy(synth_images(100, VIT_B_16, seed=1)).to(dev, torch.bfloat16)
weights = params_to_numpy(init(VIT_B_16))
for ops, tome_r in (("fused", 0), ("quant", 0), ("fused", 13), ("quant", 13)):
    eng = InferenceEngine(VIT_B_16, weights, "bfloat16", ops, dev, batch_pad=100, tome_r=tome_r)
    wall_and_device(f"{ops} b100 forward" + (f" ToMe r={tome_r}" if tome_r else ""),
                    lambda: eng.logits(x))
    del eng
    torch.cuda.empty_cache()
del x, weights

def train(name, cfg, b, regularized=False, tome_r=0):
    if regularized:
        cfg = dataclasses.replace(cfg, dropout=0.1, drop_path=0.1)
    x = torch.from_numpy(synth_images(b, cfg, seed=4)).to(dev)
    y = torch.arange(b, device=dev) * 7 % cfg.num_classes
    params = trainer.as_trainable(init(cfg), dev)
    fwd = None
    if tome_r:
        counts = tome.schedule(cfg, tome_r, tome.TRAIN_MERGE_CHUNK)
        fwd = lambda p, xb, rng: tome.forward_train(p, xb, cfg, tome_r, counts=counts,
                                                     dropout_rng=rng)
    opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-4)
    step = trainer.make_train_step(cfg, opt, get_ops("fused_train"), remat=False,
                                   compute_dtype=torch.bfloat16, use_dropout=regularized,
                                   rng=torch.Generator().manual_seed(0), forward_fn=fwd)
    wall_and_device(name, lambda: float(step(params, x, y)))
    torch.cuda.empty_cache()

train("b64 step", VIT_B_16, 64)
train("b64 regularized step", VIT_B_16, 64, True)
train("b64 ToMe r=13 step", VIT_B_16, 64, tome_r=13)
train("b64 ToMe r=13 regularized step", VIT_B_16, 64, True, 13)
train("@512 b16 step", VIT_B_16.with_image_size(512), 16)
print(json.dumps(times))
"""


def _functions(dump: str) -> dict:
    """``cuobjdump -sass`` output -> {kernel name: its instructions}, each
    line with its runs of blanks collapsed: cuobjdump pads every line of a
    cubin to the width of its longest instruction, so a kernel's lines move
    when another kernel joins its source."""
    out, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None and "/*" in line:
            out[name].append(" ".join(line.split()))
    return out


def same_sass(a: str, b: str, sources) -> dict:
    """{source: (kernels of A whose machine code differs in B, kernels of A
    missing in B, kernels B adds)} — nvcc with the build's flags to a
    cubin, then ``cuobjdump -sass``, compared kernel by kernel (each with
    the same instructions, in whatever order the cubin lists them)."""
    import tempfile
    from pathlib import Path

    from vit_tpu_torch.ops.kernels import _build

    nvcc = _build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    out = {}
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        # a source one checkout lacks (a new kernel's) has no kernels there
        cubins = {(src, i): f"{tmp}/{i}_{Path(src).stem}.cubin"
                  for src in sources for i in range(2) if (Path((a, b)[i]) / src).is_file()}
        procs = [subprocess.Popen([nvcc, *flags, "-cubin", "-o", cubin,
                                   str(Path((a, b)[i]) / src)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
                 for (src, i), cubin in cubins.items()]  # all compiles at once
        for p in procs:
            log = p.communicate()[0]
            if p.returncode:
                raise RuntimeError(f"{' '.join(p.args)} failed:\n{log.decode()}")
        for src in sources:
            old, new = (_functions(subprocess.run([cuobjdump, "-sass", cubins[src, i]],
                                                  check=True, capture_output=True,
                                                  text=True).stdout)
                        if (src, i) in cubins else {} for i in range(2))
            out[src] = ([k for k in old if k in new and new[k] != old[k]],
                        [k for k in old if k not in new], [k for k in new if k not in old])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vit-tpu-torch-compare-kernels",
                                description=__doc__.split("\n")[0])
    p.add_argument("roots", nargs=2, metavar="DIR", help="two checkouts: A B (timed A B B A)")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--steps", action="store_true",
                   help="time the fused forward and the train steps instead of the kernels")
    p.add_argument("--sass", nargs="*", default=[], metavar="SOURCE",
                   help="also compare the machine code of these sources "
                   "(e.g. vit_tpu_torch/csrc/out_residual.cu) between the two checkouts")
    args = p.parse_args(argv)
    if args.sass:
        for src, (changed, removed, added) in same_sass(*args.roots, args.sass).items():
            verdict = f"DIFFERENT {changed}" if changed else "every kept kernel identical"
            print(f"sass {src}: {verdict}; removed {removed}; added {added}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    a, b = args.roots
    readings = {a: [], b: []}
    for r in range(args.rounds):
        for root in (a, b, b, a):
            out = subprocess.run([sys.executable, "-c", STEPS if args.steps else TIMER], cwd=root,
                                 capture_output=True,
                                 text=True, timeout=900)
            if out.returncode != 0:
                raise RuntimeError(f"timing {root} failed:\n{out.stderr[-4000:]}")
            times = json.loads(out.stdout.strip().splitlines()[-1])
            readings[root].append(times)
            print(f"round {r} {root}: " + ", ".join(f"{n} {v:.6g} ms" for n, v in times.items()),
                  flush=True)
    for root, runs in readings.items():
        if not runs:
            continue
        med = {n: statistics.median(run[n] for run in runs) for n in runs[0]}
        print(f"median {root} ({len(runs)} processes; {card}): "
              + ", ".join(f"{n} {v:.6g} ms" for n, v in med.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
