"""Where the time goes in one train step on the card: CUDA events around
every kernel wrapper (ms per step and per call, achieved TFLOP/s), the
step's wall time, and a ``torch.profiler`` pass for device time and the
top device kernels.  Random weights and images from ``--seed``; AdamW,
mixed precision unless ``--fp32``, no remat; ``--dropout``/``--drop-path``
profile the regularized step; ``--image-size 512`` the long-sequence step
(T = 1,025, past the 1,024-token switch: flash attention and the split
backward).

    python3 -m vit_tpu_torch.cli.profile_train [--config vit_b_16] [--batch 64] \\
        [--ops fused_train eager] [--steps 3] [--dropout 0.1 --drop-path 0.1] \\
        [--image-size 512]

Needs a card.  The timing wrappers replace the kernel wrappers for the
life of the process.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import statistics
import sys
import time

import torch

_KERNELS = ("ln_qkv_attn", "out_residual", "ln_mlp_residual", "ln_qkv_attn_bwd",
            "ln_mlp_out_residual_bwd", "out_residual_train", "ln_mlp_residual_train",
            "ln_mlp_out_residual_bwd_train", "flash_attention_fwd", "flash_attention_bwd",
            "ln_mlp_residual_bwd", "out_residual_bwd")


def layer_flop(cfg, batch: int) -> dict:
    """Multiply-add x 2 of each training kernel for one layer: the GEMMs,
    with K1 and K6's attention products (4 and 10 of T^2 x D per image;
    K13 and K14, the long-sequence forward and backward, the same)."""
    t, d, f = cfg.seq_len, cfg.embed_dim, cfg.mlp_dim
    rows = batch * t
    attn = batch * t * t * d
    flop = {
        "ln_qkv_attn": 2 * rows * d * 3 * d + 4 * attn,
        "out_residual": 2 * rows * d * d,
        "ln_mlp_residual": 4 * rows * d * f,
        "ln_mlp_out_residual_bwd": 10 * rows * d * f + 4 * rows * d * d,
        "ln_qkv_attn_bwd": 6 * rows * d * 3 * d + 10 * attn,
        "flash_attention_fwd": 4 * attn,
        "flash_attention_bwd": 10 * attn,
        "ln_mlp_residual_bwd": 10 * rows * d * f,
        "out_residual_bwd": 4 * rows * d * d,
    }
    # the regularized kernels run their unregularized twins' GEMMs in full
    flop.update(out_residual_train=flop["out_residual"],
                ln_mlp_residual_train=flop["ln_mlp_residual"],
                ln_mlp_out_residual_bwd_train=flop["ln_mlp_out_residual_bwd"])
    return flop


def device_kernel_us(rows, key: str) -> float:
    """The device time of the kernels among ``key_averages()`` rows, in us:
    the rows with no CPU time (op and autograd rows repeat their kernels'
    device time), less the user annotations the trace also places on the
    device timeline (torch's ``Optimizer.step`` record_function spans the
    optimizer's kernels), as ``chip_smoke._device_ms`` counts."""
    return sum(getattr(e, key) for e in rows
               if e.self_cpu_time_total == 0 and not getattr(e, "is_user_annotation", False))


def _time_wrappers(events: dict) -> None:
    """Replace each kernel wrapper by one that records CUDA events around it."""
    import sys

    from vit_tpu_torch.ops.kernels import wrapper

    for name in _KERNELS:
        real = wrapper(name)
        mod = sys.modules[real.__module__]

        def timed(*args, _real=real, _name=name, **kwargs):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = _real(*args, **kwargs)
            end.record()
            events[_name].append((start, end))
            return out

        timed.launches = real.launches  # the wrapper counts on its module's name
        setattr(mod, name, timed)


def main(argv=None) -> int:
    from vit_tpu_torch.config import resolve_config
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.runtime import trainer

    p = argparse.ArgumentParser(prog="vit-tpu-torch-profile-train", description=__doc__.split("\n")[0])
    p.add_argument("--config", default="vit_b_16")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--steps", type=int, default=3, help="timed steps (after 2 warm-up steps)")
    p.add_argument("--ops", nargs="+", default=["fused_train", "eager"],
                   choices=["fused_train", "eager"])
    p.add_argument("--fp32", action="store_true", help="fp32 compute instead of bf16 mixed")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dropout", type=float, default=0.0)
    p.add_argument("--drop-path", type=float, default=0.0)
    p.add_argument("--image-size", type=int, default=0,
                   help="override the config's image size (512: the long-sequence step)")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_train needs a card: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    cfg, b = resolve_config(args.config), args.batch
    if args.image_size:
        cfg = cfg.with_image_size(args.image_size)
    regularized = bool(args.dropout or args.drop_path)
    cfg = dataclasses.replace(cfg, dropout=args.dropout, drop_path=args.drop_path)
    x = torch.from_numpy(synth_images(b, cfg, seed=args.seed)).to(dev)
    y = torch.arange(b, device=dev) * 7 % cfg.num_classes
    events = collections.defaultdict(list)
    _time_wrappers(events)
    flop = layer_flop(cfg, b)
    print(f"{cfg.name} batch {b} {'fp32' if args.fp32 else 'bf16 mixed'}"
          f"{f'; dropout {args.dropout}, drop-path {args.drop_path}' if regularized else ''}; "
          f"{torch.cuda.get_device_name(0)}")

    for ops in args.ops:
        params = trainer.as_trainable(
            vit.init_params(torch.Generator().manual_seed(args.seed), cfg), dev)
        opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-4)
        step = trainer.make_train_step(cfg, opt, get_ops(ops), remat=False,
                                       compute_dtype=None if args.fp32 else torch.bfloat16,
                                       use_dropout=regularized,
                                       rng=torch.Generator().manual_seed(args.seed))
        for _ in range(2):
            float(step(params, x, y))
        events.clear()
        walls = []
        for _ in range(args.steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            float(step(params, x, y))  # waits for the device
            walls.append(time.perf_counter() - t0)
        wall = statistics.median(walls) * 1e3
        print(f"== {ops}: step wall {wall:.6g} ms (median of {args.steps}, CUDA events on)")
        total = 0.0
        for name, evs in events.items():
            ms = sum(s.elapsed_time(e) for s, e in evs) / args.steps
            calls = len(evs) // args.steps
            total += ms
            print(f"  {name}: {calls} calls/step, {ms:.6g} ms/step, {ms / calls:.6g} ms/call, "
                  f"{flop[name] * calls / (ms * 1e-3) / 1e12:.4g} TFLOP/s")
        if events:
            print(f"  kernels {total:.6g} ms/step; rest of the step {wall - total:.6g} ms")
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            float(step(params, x, y))
            torch.cuda.synchronize()
        averages = prof.key_averages()
        key = ("self_device_time_total" if hasattr(averages[0], "self_device_time_total")
               else "self_cuda_time_total")
        device_us = device_kernel_us(averages, key)
        print(f"  profiler: device kernels {device_us / 1e3:.6g} ms in one step, "
              f"{device_us / 1e3 / wall:.1%} of the step's wall")
        print(averages.table(sort_by=key, row_limit=18, max_name_column_width=70))
        del params, opt, step
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
