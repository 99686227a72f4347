#!/usr/bin/env python
"""Run one model over several ranks with the port's library API, the
counterpart of ``examples/parallel.py``.  Where the JAX example places
arrays on a mesh of devices inside one process, the port runs one process
per rank: this script starts them with ``torch.distributed.run`` over gloo
and each rank checks data parallelism, dp x tp through the fused kernels,
pipeline parallelism over the layer stack, and a data-parallel train step
against one rank's own results (the single-device logits and the
single-device step's losses).  The ranks share one card (gloo lets them),
or run on the CPU with ``--device cpu``.

    python examples/torch_parallel.py                      # 2 ranks on the card
    python examples/torch_parallel.py --device cpu --ranks 4
"""

import argparse
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def rank_main(device: str) -> int:
    """One rank: every parallel form against this rank's single-device run."""
    import dataclasses

    import numpy as np
    import torch

    from vit_tpu_torch.config import VIT_B_16
    from vit_tpu_torch.io import weights as wio
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.parallel.pipeline import shard_forward_pp
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.runtime import distributed, trainer
    from vit_tpu_torch.runtime.engine import InferenceEngine

    distributed.initialize(backend="gloo", device_type=device)
    import torch.distributed as dist

    n, rank = dist.get_world_size(), dist.get_rank()
    dev = torch.device(device, distributed.local_rank() % torch.cuda.device_count()) \
        if device == "cuda" else torch.device("cpu")
    say = print if rank == 0 else (lambda *a, **k: None)
    cfg = dataclasses.replace(VIT_B_16, depth=2, embed_dim=64, num_heads=4, image_size=32,
                              patch_size=16, num_classes=10, name="vit_parallel_example")
    params = wio.params_from_tensors(wio.synth_reference_tensors(cfg, 0), cfg)
    images = synth_images(2 * n, cfg, seed=0)
    worst = 0.0

    def engine(ops, mesh=None):
        return InferenceEngine(cfg, params, dtype="float32", ops=ops, device=dev, mesh=mesh,
                               batch_pad=4)

    # the single-device logits every sharded form must give
    want = engine("eager").logits(images).cpu().numpy()

    # 1) data parallelism: the batch splits over 'dp', the params replicate
    dp_mesh = make_mesh({"dp": n})
    got = engine("eager", dp_mesh).logits(images).cpu().numpy()
    worst = max(worst, float(np.abs(got - want).max()))
    say(f"dp={n} (eager): max |d| vs single {np.abs(got - want).max():.2e}")

    # 2) dp x tp: heads and the MLP hidden axis split over 'tp' inside the
    #    fused kernels (their plain twins on the CPU), all-reduces after
    tp_mesh = make_mesh({"dp": n // 2, "tp": 2})
    got = engine("fused", tp_mesh).logits(images).cpu().numpy()
    worst = max(worst, float(np.abs(got - want).max()))
    say(f"dp={n // 2} x tp=2 (fused kernels): max |d| vs single {np.abs(got - want).max():.2e}")

    # 3) pipeline parallelism: the layer stack splits into pp stages and two
    #    microbatches ride the shift from stage to stage (GPipe)
    pp_mesh = make_mesh({"dp": n // 2, "pp": 2})
    fwd = shard_forward_pp(cfg, pp_mesh, 2, ops_name="eager")
    local = shard_params(params_from_numpy(params, dev), pp_mesh)  # this stage's layers
    got = fwd(local, torch.from_numpy(images).to(dev)).cpu().numpy()
    worst = max(worst, float(np.abs(got - want).max()))
    say(f"pp=2 (GPipe, 2 microbatches): max |d| vs single {np.abs(got - want).max():.2e}")

    # 4) a data-parallel train step: each rank's gradients on its half of
    #    the batch, averaged over 'dp' (what vit-tpu-torch-train --dp wires
    #    from flags), against the single-device step on the whole batch
    x = torch.from_numpy(images).to(dev)
    y = torch.from_numpy(np.arange(len(images)) % cfg.num_classes).to(dev)
    eager = get_ops("eager")

    def run(mesh, xs, ys):
        p, opt = trainer.init_train_state(
            torch.Generator().manual_seed(0), cfg,
            lambda q: torch.optim.SGD(trainer.leaves(q), lr=0.1), device=dev)
        step = trainer.make_train_step_dp(cfg, opt, mesh, eager, remat=False)
        return [float(step(p, xs, ys)) for _ in range(3)]

    per_rank = len(images) // n
    mine = slice(dp_mesh.index("dp") * per_rank, (dp_mesh.index("dp") + 1) * per_rank)
    losses = run(dp_mesh, x[mine], y[mine])
    single = run(None, x, y)
    loss_dev = max(abs(a - b) for a, b in zip(losses, single))
    say(f"dp={n} train: loss {losses[0]:.4f} -> {losses[-1]:.4f}  "
        f"(max |d| vs single {loss_dev:.2e})")

    ok = worst < 1e-4 and loss_dev < 1e-5 and losses[-1] < losses[0]
    say("parallel example:", "OK" if ok else "FAILED")
    return 0 if ok else 1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=2, help="processes (an even count)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rank-worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_worker:
        return rank_main(args.device)
    if args.ranks < 2 or args.ranks % 2:
        ap.error("--ranks must be an even count of at least 2")
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("error: --device cuda, but torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(REPO), os.environ.get("PYTHONPATH")) if p))
    for key in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(key, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(args.ranks), str(Path(__file__).resolve()), "--rank-worker", "--device",
           args.device]
    return subprocess.run(cmd, env=env).returncode


if __name__ == "__main__":
    raise SystemExit(main())
