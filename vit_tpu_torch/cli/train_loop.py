"""The vit-tpu-torch-train step loop: per-step dispatch, the ``step N  loss
L  T s`` lines and ``--log-jsonl`` records of ``vit_tpu.cli.train_loop``,
the held-out evaluation (``--eval-data-dir``: every ``--eval-every`` steps
and at the end), and the final ``--save`` and ``--save-backbone``.  On a
mesh each rank steps on its dp slice of the global batch, and rank 0 alone
writes."""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# the staged batches' bound, as the JAX package's loop has it (per rank)
STAGED_BYTES = int(512e6)


def run(args, st) -> int:
    """Drive ``st`` (a train_setup.TrainSetup) for args.steps steps."""
    from vit_tpu_torch.io import checkpoint as ckpt
    from vit_tpu_torch.io.params import params_to_numpy

    mesh = st.mesh
    lead = mesh is None or mesh.rank == 0

    def log_jsonl(record: dict) -> None:
        if args.log_jsonl and lead:
            with open(args.log_jsonl, "a") as fh:
                fh.write(json.dumps(record) + "\n")

    def evaluate(s: int, final: bool = False) -> None:
        acc = st.run_eval(st.params)  # under --tp every rank takes part
        print(f"{'final' if final else f'step {s:4d} '} eval top-1 {acc:.4f} (params)")
        log_jsonl({"step": s, "eval_top1": round(acc, 6), **({"final": True} if final else {})})

    # every rank draws the same global batch and keeps its dp slice
    local = args.batch // (mesh.size("dp") if mesh is not None else 1)
    lo = mesh.index("dp") * local if mesh is not None else 0
    # static data cycles a few aligned batches: upload each once, up to
    # STAGED_BYTES of them, so a large static set cannot crowd training out
    # of device memory (the rest are uploaded at every use)
    staged = {}
    if st.stream is None:
        batch_bytes = st.images[:local].nbytes + st.labels[:local].nbytes
        max_staged = max(1, STAGED_BYTES // max(batch_bytes, 1))
    last_step, last_eval_step = st.start_step, None
    try:
        for s in range(st.start_step, st.start_step + args.steps):
            if st.stream is not None:
                xb, yb = next(st.stream)
            else:
                i0 = (s * args.batch) % st.n_static + lo
                if i0 in staged:
                    xb, yb = staged[i0]
                else:
                    xb = torch.from_numpy(st.images[i0 : i0 + local]).to(st.device)
                    yb = torch.from_numpy(st.labels[i0 : i0 + local]).to(st.device)
                    if len(staged) < max_staged:
                        staged[i0] = (xb, yb)
            if st.lr_at is not None:
                for group in st.optimizer.param_groups:
                    group["lr"] = st.lr_at(s)
            t0 = time.perf_counter()
            loss = float(st.step(st.params, xb, yb))  # waits for the device
            dt = time.perf_counter() - t0
            print(f"step {s:4d}  loss {loss:.4f}  {dt:.2f}s")
            log_jsonl({"step": s, "loss": round(loss, 6), "ms": round(dt * 1e3, 2),
                       "images_per_sec": round(args.batch / dt, 2)})
            if not np.isfinite(loss):  # the same dp-averaged loss on every rank
                print("non-finite loss; aborting", file=sys.stderr)
                return 1  # the stream is closed below
            if st.run_eval is not None and (s + 1) % args.eval_every == 0:
                last_eval_step = s + 1
                evaluate(s)
            last_step = s + 1
    finally:
        if st.stream is not None:
            st.stream.close()  # stops the prefetch producer, also when a step raises
    # the final held-out evaluation, unless the last step already ran it
    if st.run_eval is not None and last_eval_step != last_step:
        evaluate(last_step, final=True)
    params = st.params
    if mesh is not None and mesh.size("tp") > 1:
        from vit_tpu_torch.parallel.sharding import unshard_params

        params = unshard_params(params, mesh)  # every rank takes part
    if args.save and lead:
        ckpt.save_npz(params_to_numpy(params), args.save)
        print(f"saved params to {args.save}")
    if args.save_backbone and lead:
        from vit_tpu_torch.models import mae

        bb = mae.extract_backbone(params, torch.Generator().manual_seed(args.seed ^ 0xBB), st.cfg)
        ckpt.save_npz(params_to_numpy(bb), args.save_backbone)
        print(f"saved pretrained backbone (fresh {st.cfg.embed_dim} x {st.cfg.num_classes} "
              f"head) to {args.save_backbone}")
    return 0
