"""The vit-tpu-torch-train step loop: per-step dispatch, the ``step N  loss
L  T s`` lines and ``--log-jsonl`` records of ``vit_tpu.cli.train_loop``,
and the final ``--save``."""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

# the staged batches' bound, as the JAX package's loop has it
STAGED_BYTES = int(512e6)


def run(args, st) -> int:
    """Drive ``st`` (a train_setup.TrainSetup) for args.steps steps."""
    from vit_tpu_torch.io import checkpoint as ckpt
    from vit_tpu_torch.io.params import params_to_numpy

    # static data cycles a few aligned batches: upload each once, up to
    # STAGED_BYTES of them, so a large static set cannot crowd training out
    # of device memory (the rest are uploaded at every use)
    staged = {}
    batch_bytes = st.images[: args.batch].nbytes + st.labels[: args.batch].nbytes
    max_staged = max(1, STAGED_BYTES // max(batch_bytes, 1))
    for s in range(args.steps):
        i0 = (s * args.batch) % st.n_static
        if i0 in staged:
            xb, yb = staged[i0]
        else:
            xb = torch.from_numpy(st.images[i0 : i0 + args.batch]).to(st.device)
            yb = torch.from_numpy(st.labels[i0 : i0 + args.batch]).to(st.device)
            if len(staged) < max_staged:
                staged[i0] = (xb, yb)
        if st.lr_at is not None:
            for group in st.optimizer.param_groups:
                group["lr"] = st.lr_at(s)
        t0 = time.perf_counter()
        loss = float(st.step(st.params, xb, yb))  # waits for the device
        dt = time.perf_counter() - t0
        print(f"step {s:4d}  loss {loss:.4f}  {dt:.2f}s")
        if args.log_jsonl:
            with open(args.log_jsonl, "a") as fh:
                fh.write(json.dumps({
                    "step": s, "loss": round(loss, 6), "ms": round(dt * 1e3, 2),
                    "images_per_sec": round(args.batch / dt, 2),
                }) + "\n")
        if not np.isfinite(loss):
            print("non-finite loss; aborting", file=sys.stderr)
            return 1
    if args.save:
        ckpt.save_npz(params_to_numpy(st.params), args.save)
        print(f"saved params to {args.save}")
    return 0
