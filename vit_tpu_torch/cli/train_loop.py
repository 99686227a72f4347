"""The vit-tpu-torch-train step loop — counterpart of
``vit_tpu.cli.train_loop``: per-step dispatch, the ``step N  loss L  T s``
lines and ``--log-jsonl`` records, the EMA update, the held-out evaluation
(``--eval-data-dir``: every ``--eval-every`` steps and at the end, on the
EMA params when ``--ema-decay`` is on), ``--save-state`` every
``--save-every`` steps and at the end, checkpointing on SIGTERM, and the
final ``--save``, ``--save-backbone``, ``--save-ema`` and
``--save-reference``.  On a mesh each rank steps on its dp slice of the
global batch, and rank 0 alone writes, the whole tree (under ``--tp`` or
``--pp`` every rank gathers it first: a collective; a pipelined run's
archives are one-card archives)."""

from __future__ import annotations

import json
import signal
import sys
import time
from pathlib import Path

import numpy as np
import torch

# the staged batches' bound, as the JAX package's loop has it (per rank)
STAGED_BYTES = int(512e6)


def ema_sidecar(state_path) -> Path:
    """The EMA's file beside a ``--save-state`` archive."""
    return Path(state_path).with_suffix(".ema.npz")


def run(args, st) -> int:
    """Drive ``st`` (a train_setup.TrainSetup) for args.steps steps."""
    from vit_tpu_torch.io import checkpoint as ckpt
    from vit_tpu_torch.io import weights as wio
    from vit_tpu_torch.io.params import params_to_numpy
    from vit_tpu_torch.parallel.sharding import splits_params, unshard_params
    from vit_tpu_torch.runtime import trainer

    mesh = st.mesh
    lead = mesh is None or mesh.rank == 0

    def whole(tree):
        if not splits_params(mesh):
            return tree
        return unshard_params(tree, mesh)  # every rank takes part

    def log_jsonl(record: dict) -> None:
        if args.log_jsonl and lead:
            with open(args.log_jsonl, "a") as fh:
                fh.write(json.dumps(record) + "\n")

    def evaluate(s: int, final: bool = False) -> None:
        # under --tp or --pp every rank takes part
        acc = st.run_eval(st.ema if st.ema is not None else st.params)
        which = "ema" if st.ema is not None else "params"
        print(f"{'final' if final else f'step {s:4d} '} eval top-1 {acc:.4f} ({which})")
        log_jsonl({"step": s, "eval_top1": round(acc, 6), **({"final": True} if final else {})})

    def save_state(s: int, params=None) -> None:
        params = whole(st.params) if params is None else params
        opt = trainer.opt_state_leaves(st.optimizer, st.trained, mesh, st.schedule, st.guard)
        ema = whole(st.ema) if st.ema is not None else None
        if not lead:
            return
        ckpt.save_train_state(params_to_numpy(params), opt, s, args.save_state)
        if ema is not None:
            # the EMA is training state too: a resume without it would
            # restart the average from the params
            ckpt.save_npz(params_to_numpy(ema), ema_sidecar(args.save_state))
        print(f"saved training state (step {s}) to {args.save_state}")

    # preemption: on SIGTERM finish the step, checkpoint the whole state and
    # exit cleanly, so --resume continues the run
    preempted = {"flag": False}

    def _on_term(signum, frame):
        preempted["flag"] = True

    # signal.signal returns None where the previous handler was installed
    # outside Python: restore SIG_DFL then, so the handler never outlives
    # this function
    handler_installed, prev_handler = False, None
    try:
        prev_handler = signal.signal(signal.SIGTERM, _on_term)
        handler_installed = True
    except ValueError:  # not the main thread (embedded use)
        pass

    def stop_now() -> bool:
        """Whether any rank was sent SIGTERM (one all-reduce on a mesh, so
        every rank leaves the loop at the same step)."""
        if mesh is None:
            return preempted["flag"]
        import torch.distributed as dist

        flag = torch.tensor([int(preempted["flag"])], dtype=torch.int32, device=st.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        return bool(flag.item())

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
    last_step, last_eval_step, stopped = st.start_step, None, False
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
                # a schedule reads the applied updates (optax's count), which
                # a skipped step does not move
                lr = st.lr_at(trainer.applied_updates(st.optimizer))
                for group in st.optimizer.param_groups:
                    group["lr"] = lr
            t0 = time.perf_counter()
            loss = st.step(st.params, xb, yb, step=s)
            if st.ema_update is not None:
                st.ema_update(st.ema, st.params)
            loss = float(loss)  # waits for the device
            dt = time.perf_counter() - t0
            print(f"step {s:4d}  loss {loss:.4f}  {dt:.2f}s")
            log_jsonl({"step": s, "loss": round(loss, 6), "ms": round(dt * 1e3, 2),
                       "images_per_sec": round(args.batch / dt, 2)})
            if not np.isfinite(loss):  # the same dp-averaged loss on every rank
                if args.skip_nonfinite:
                    print(f"step {s}: non-finite loss; update skipped", file=sys.stderr)
                else:
                    print("non-finite loss; aborting", file=sys.stderr)
                    return 1  # the stream is closed below
            if st.run_eval is not None and (s + 1) % args.eval_every == 0:
                last_eval_step = s + 1
                evaluate(s)
            if args.save_state and args.save_every and (s + 1) % args.save_every == 0:
                save_state(s + 1)
            last_step = s + 1
            if handler_installed and stop_now():
                stopped = True
                if args.save_state:
                    print(f"SIGTERM: checkpointing at step {last_step} and exiting (resume "
                          "with --resume)", file=sys.stderr)
                else:
                    print(f"SIGTERM: exiting at step {last_step} (no --save-state given; "
                          "nothing checkpointed)", file=sys.stderr)
                break
    finally:
        if handler_installed:
            signal.signal(signal.SIGTERM,
                          prev_handler if prev_handler is not None else signal.SIG_DFL)
        if st.stream is not None:
            st.stream.close()  # stops the prefetch producer, also when a step raises
    # the final held-out evaluation, unless the last step already ran it
    # (none after SIGTERM: its grace period is for the checkpoint)
    if st.run_eval is not None and last_eval_step != last_step and not stopped:
        evaluate(last_step, final=True)
    params = whole(st.params)
    if args.save_state:
        save_state(last_step, params)
    if args.save and lead:
        ckpt.save_npz(params_to_numpy(params), args.save)
        print(f"saved params to {args.save}")
    if args.save_backbone and lead:
        from vit_tpu_torch.models import mae

        bb = mae.extract_backbone(params, torch.Generator().manual_seed(args.seed ^ 0xBB), st.cfg)
        ckpt.save_npz(params_to_numpy(bb), args.save_backbone)
        print(f"saved pretrained backbone (fresh {st.cfg.embed_dim} x {st.cfg.num_classes} "
              f"head) to {args.save_backbone}")
    if args.save_ema and st.ema is not None:
        ema = whole(st.ema)
        if lead:
            ckpt.save_npz(params_to_numpy(ema), args.save_ema)
            print(f"saved EMA params to {args.save_ema}")
    if args.save_reference and lead:
        wio.save_reference_weights(wio.tensors_from_params(params_to_numpy(params), st.cfg),
                                   args.save_reference, st.cfg)
        print(f"exported reference-format weights to {args.save_reference}")
    return 0
