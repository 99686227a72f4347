"""Per-kernel timings of the fused-block forward kernels (bf16 vs int8) on the
card — counterpart of the JAX package's ``scripts/bench_kernels.py``.

Each kernel runs over a 12-layer stack of weights (the output of one layer
the input of the next, as in the model), timed with CUDA events around the
whole stack; the lines give ms per layer and TFLOP/s (the model's FLOPs of
the kernel's function, int8 operations counted as FLOPs).  ViT-B/16 shapes
(T = 197, D = 768, F = 3,072, 12 heads), bf16, weights from a seed.

    python3 -m vit_tpu_torch.cli.bench_kernels [--batch 100] \\
        [--which a,b,c,a8,c8,a8qk,a8a,awide]

  a     K1 ln_qkv_attn                     a8    K15 ln_qkv_attn_q8
  a8qk  K19 ln_qkv_attn_q8a, int8 q·kᵀ     a8a   K19 with int8 p·v too
  awide K1 at 6 heads of 128               b     K4 out_residual
  c     K5 ln_mlp_residual                 c8    K16 out_ln_mlp_residual_q8

This is K19's path: the kernel study is the only caller of the
int8-attention kernel.  Needs a card.
"""

from __future__ import annotations

import argparse
import statistics

import torch

L = 12
WHICH = ("a", "b", "c", "a8", "c8", "a8qk", "a8a", "awide")
WARMUP, ITERS = 3, 10  # stacks per kernel: 12 launches each


def time_layers(body, x, weights) -> float:
    """ms per layer of ``body(c, w) -> c`` over the stack ``weights`` (one
    tuple per layer): the median of ITERS timed stacks after WARMUP
    warm-up stacks, by CUDA events."""
    def stack():
        c = x
        for w in weights:
            c = body(c, w)
        return c

    for _ in range(WARMUP):
        stack()
    times = []
    for _ in range(ITERS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        stack()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / L


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m vit_tpu_torch.cli.bench_kernels",
        description="Per-layer times of the fused-block kernels on the card.")
    ap.add_argument("--batch", type=int, default=100)
    ap.add_argument("--which", default="a,b,c,a8,c8",
                    help=f"comma-separated kernels of {','.join(WHICH)}")
    args = ap.parse_args(argv)
    which = set(args.which.split(","))
    if not which <= set(WHICH):
        ap.error(f"--which takes {','.join(WHICH)}; got {args.which}")

    from vit_tpu_torch.io.params import device_or_raise
    from vit_tpu_torch.ops import quant
    from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual
    from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn
    from vit_tpu_torch.ops.kernels.ln_qkv_attn_q8 import ln_qkv_attn_q8, ln_qkv_attn_q8a
    from vit_tpu_torch.ops.kernels.out_ln_mlp_residual_q8 import out_ln_mlp_residual_q8
    from vit_tpu_torch.ops.kernels.out_residual import out_residual

    dev = device_or_raise("cuda")
    b, t, d, f, nh = args.batch, 197, 768, 3072, 12
    rows, eps, bf = b * t, 1e-6, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(0)

    def rn(*shape, scale=0.03):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(bf)

    x = rn(rows, d, scale=1.0)
    s1, b1ln = torch.ones(L, d, dtype=bf, device=dev), torch.zeros(L, d, dtype=bf, device=dev)
    wqkv, bqkv = rn(L, d, 3 * d), torch.zeros(L, 3 * d, dtype=bf, device=dev)
    wo, bo = rn(L, d, d), torch.zeros(L, d, dtype=bf, device=dev)
    w1, b1 = rn(L, d, f), torch.zeros(L, f, dtype=bf, device=dev)
    w2, b2 = rn(L, f, d), torch.zeros(L, d, dtype=bf, device=dev)
    (wqkv_q, wqkv_s), (w1_q, w1_s), (w2_q, w2_s) = (
        quant.quantize_weight_stacked(w) for w in (wqkv, w1, w2))

    def layers(*stacked):
        return list(zip(*(a.unbind(0) for a in stacked)))

    fl_a = 2 * rows * d * 3 * d + 4 * b * t * t * d
    fl_b = 2 * rows * d * d
    fl_c = 4 * rows * d * f
    q8 = layers(s1, b1ln, wqkv_q, wqkv_s, bqkv)
    runs = {
        "a": ("A  bf16 ln_qkv_attn: ", fl_a, layers(s1, b1ln, wqkv, bqkv),
              lambda c, w: ln_qkv_attn(c, *w, nh, t, eps)),
        "a8": ("A  int8 ln_qkv_attn: ", fl_a, q8, lambda c, w: ln_qkv_attn_q8(c, *w, nh, t, eps)),
        "a8qk": ("A  int8+q8(QK^T):    ", fl_a, q8,
                 lambda c, w: ln_qkv_attn_q8a(c, *w, nh, t, eps, quant_pv=False)),
        "a8a": ("A  int8+q8(attn):    ", fl_a, q8,
                lambda c, w: ln_qkv_attn_q8a(c, *w, nh, t, eps, quant_pv=True)),
        # the same shapes and FLOPs as A, at 6 heads of 128
        "awide": ("A  bf16 dh=128 (6h): ", fl_a, layers(s1, b1ln, wqkv, bqkv),
                  lambda c, w: ln_qkv_attn(c, *w, 6, t, eps)),
        "b": ("B  bf16 out_residual:", fl_b, layers(wo, bo), lambda c, w: out_residual(c, c, *w)),
        "c": ("C  bf16 ln_mlp:      ", fl_c, layers(s1, b1ln, w1, b1, w2, b2),
              lambda c, w: ln_mlp_residual(c, *w, eps)),
        "c8": ("BC int8 merged:      ", fl_b + fl_c,
               layers(wo, bo, s1, b1ln, w1_q, w1_s, b1, w2_q, w2_s, b2),
               lambda c, w: out_ln_mlp_residual_q8(c, c, *w, eps)),
    }
    with torch.inference_mode():
        for key in WHICH:
            if key in which:
                label, flops, weights, body = runs[key]
                dt = time_layers(body, x, weights) / 1e3
                print(f"{label} {dt * 1e3:7.3f} ms/layer  {flops / dt / 1e12:6.1f} TF/s",
                      flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
