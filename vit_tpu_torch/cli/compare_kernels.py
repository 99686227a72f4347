"""Time the kernels that share ``csrc/gemm.cuh`` in several checkouts of the
repo, each in its own process, in turns, on one card:

    python3 -m vit_tpu_torch.cli.compare_kernels PARENT_DIR . [--rounds 2]

runs PARENT_DIR, ., ., PARENT_DIR per round (each checkout builds its own
kernels into its own ``build/``) and prints each process's times, then the
median per checkout.  K1 and K2 run at B/16 batch 100 (the classify path),
K4, K5 and K7 at batch 64 (the train step), K10, K11 and K12a too where the
checkout has them (dropout and drop-path 0.1), and the W8A8 K15, K16 and
K17 at batch 100 where it has those; bf16, CUDA events, median of
20 launches after 5.  ``--sass SOURCE ...`` first compares the machine
code each checkout compiles from those sources: every kernel of A must
compile to the same instructions in B, and B may add kernels of its own (a
new template instance, a hook's variant).  ``--rounds 0`` compares the
machine code only.  Needs a card.
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
import importlib, json, statistics, torch
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

def k(name):
    try:
        return getattr(importlib.import_module(f"vit_tpu_torch.ops.kernels.{name}"), name)
    except ModuleNotFoundError:
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
rows = 64 * t
x, ctx, dy = rn(rows, d, scale=2.0), rn(rows, d), rn(rows, d)
times["K4"] = ms(lambda: k("out_residual")(ctx, x, wo, bo))
times["K5"] = ms(lambda: k("ln_mlp_residual")(x, s, bb, w1, b1, w2, b2, eps, "exact"))
times["K7"] = ms(lambda: k("ln_mlp_out_residual_bwd")(dy, x, ctx, s, bb, w1, b1, w2, wo, eps, "exact"))
if k("out_residual_train") is not None:
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
    dpa, dpm = (drop_path_scale_rows(7, site, 64, t, 0.1, device=dev) for site in (4, 5))
    times["K10"] = ms(lambda: k("out_residual_train")(ctx, x, wo, bo, dpa, 7, 0.1))
    times["K11"] = ms(lambda: k("ln_mlp_residual_train")(x, s, bb, w1, b1, w2, b2, dpm, 7, 0.1, eps))
    times["K12a"] = ms(lambda: k("ln_mlp_out_residual_bwd_train")(
        dy, x, ctx, s, bb, w1, b1, w2, wo, dpm, dpa, 7, 0.1, eps))
if k("ln_qkv_attn_q8") is not None:
    from vit_tpu_torch.ops.quant import quantize_weight
    rows = 100 * t
    x, ctx = rn(rows, d, scale=2.0), rn(rows, d)
    (wq, ws), (w1q, w1s), (w2q, w2s) = (quantize_weight(w) for w in (wqkv, w1, w2))
    mlp = (s, bb, w1q, w1s, b1, w2q, w2s, b2, eps, "exact")
    times["K15"] = ms(lambda: k("ln_qkv_attn_q8")(x, s, bb, wq, ws, bqkv, h, t, eps))
    times["K16"] = ms(lambda: k("out_ln_mlp_residual_q8")(ctx, x, wo, bo, *mlp))
    times["K17"] = ms(lambda: k("ln_mlp_residual_q8")(x, *mlp))
print(json.dumps(times))
"""


def _functions(dump: str) -> dict:
    """``cuobjdump -sass`` output -> {kernel name: its instructions}."""
    out, name = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = []
        elif name is not None and "/*" in line:
            out[name].append(line)
    return out


def same_sass(a: str, b: str, sources) -> dict:
    """{source: (kernels of A whose machine code differs in B or is missing
    there, kernels B adds)} — nvcc with the build's flags to a cubin, then
    ``cuobjdump -sass``, compared kernel by kernel (each with the same
    instructions, in whatever order the cubin lists them)."""
    import tempfile
    from pathlib import Path

    from vit_tpu_torch.ops.kernels import _build

    nvcc = _build.find_nvcc()
    cuobjdump = str(Path(nvcc).with_name("cuobjdump"))
    out = {}
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory() as tmp:
        cubins = {(src, i): f"{tmp}/{i}_{Path(src).stem}.cubin"
                  for src in sources for i in range(2)}
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
                                                  text=True).stdout) for i in range(2))
            out[src] = ([k for k in old if new.get(k) != old[k]], [k for k in new if k not in old])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="vit-tpu-torch-compare-kernels",
                                description=__doc__.split("\n")[0])
    p.add_argument("roots", nargs=2, metavar="DIR", help="two checkouts: A B (timed A B B A)")
    p.add_argument("--rounds", type=int, default=2)
    p.add_argument("--sass", nargs="*", default=[], metavar="SOURCE",
                   help="also compare the machine code of these sources "
                   "(e.g. vit_tpu_torch/csrc/out_residual.cu) between the two checkouts")
    args = p.parse_args(argv)
    if args.sass:
        for src, (changed, added) in same_sass(*args.roots, args.sass).items():
            verdict = f"DIFFERENT {changed}" if changed else "identical"
            print(f"sass {src}: {verdict}; {len(added)} kernel(s) added", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    a, b = args.roots
    readings = {a: [], b: []}
    for r in range(args.rounds):
        for root in (a, b, b, a):
            out = subprocess.run([sys.executable, "-c", TIMER], cwd=root, capture_output=True,
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
