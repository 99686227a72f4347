"""One rank of the 4-rank gloo group that ``test_torch_zero.py`` starts:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        tests/torch_zero_worker.py IN.npz OUT

Reads the tiny config's fp32 params, images and labels from ``IN.npz``
(made by the test), runs ZeRO-1 (``trainer.Zero1``) and FSDP
(``sharding.DpShards``) against the plain steps on the CPU — at dp 2 (each
tp column of the {'dp': 2, 'tp': 2} mesh is a dp 2 group of its own) and at
dp 2 x tp 2 — then the ``eager`` engine on dp 2 x tp 2 and the train CLI
with ``--zero1``/``--fsdp`` over the four ranks, and writes every result to
``OUT.<rank>.npz`` (the CLI's archives and logs beside it).  Imports
nothing of JAX.
"""

import contextlib
import io
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from torch_parallel_train_worker import TINY, flatten, unflatten
from vit_tpu_torch import config
from vit_tpu_torch.cli.train_setup import adamw_param_groups
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.parallel import make_mesh
from vit_tpu_torch.parallel.mesh import Mesh
from vit_tpu_torch.parallel.sharding import DpShards, shard_params, splits_params, unshard_params
from vit_tpu_torch.parallel.tp_forward import plain_tp_ops
from vit_tpu_torch.runtime import distributed, trainer
from vit_tpu_torch.runtime.engine import InferenceEngine

LR, WD, STEPS = 1e-3, 0.05, 3


def local(arr, mesh):
    n = len(arr) // mesh.size("dp")
    return torch.from_numpy(arr[mesh.index("dp") * n:(mesh.index("dp") + 1) * n])


def train(res, name, data, mesh, ops_name, zero="", freeze=False, guard=False, **kw):
    """STEPS AdamW steps of ``make_train_step_dp`` (``make_train_step_kernel_tp``
    on ``fused_train`` over tp) on this rank's part; ``zero`` '', 'zero1' or
    'fsdp'.  The losses, the whole params and optimizer state after them,
    and this rank's param, moment and per-leaf moment sizes go into
    ``res`` under ``name``."""
    tree = params_from_numpy(unflatten(data, "params/"), "cpu")
    if splits_params(mesh):
        tree = shard_params(tree, mesh)
    fsdp = None
    if zero == "fsdp":
        fsdp = DpShards(tree, mesh)
        tree = fsdp.slice(tree)
    params = trainer.as_trainable(tree, "cpu")
    trained = {"head": params["head"]} if freeze else params
    zero1 = trainer.Zero1(trained, mesh) if zero == "zero1" else None
    opt_tree = trained if zero1 is None else zero1.slices
    opt = torch.optim.AdamW(adamw_param_groups(opt_tree, WD, True), lr=LR)
    g = trainer.NonFiniteGuard() if guard else None
    tp = mesh.size("tp") > 1
    if ops_name == "fused_train" and tp:
        step = trainer.make_train_step_kernel_tp(TINY, opt, mesh, guard=g, trained=trained,
                                                 zero1=zero1, **kw)
    else:
        ops = get_ops(ops_name)
        step = trainer.make_train_step_dp(
            TINY, opt, mesh, plain_tp_ops(ops, mesh) if tp else ops,
            remat=ops_name != "fused_train", guard=g, trained=trained, zero1=zero1, fsdp=fsdp,
            **kw)
    x, y = local(data["images"], mesh), local(data["labels"], mesh)
    res[f"{name}/losses"] = np.array([float(step(params, x, y, step=s)) for s in range(STEPS)],
                                     np.float32)
    res[f"{name}/param_bytes"] = np.int64(sum(t.numel() * t.element_size()
                                              for t in trainer.leaves(params)))
    whole = fsdp.unshard(params) if fsdp else (
        unshard_params(params, mesh) if splits_params(mesh) else params)
    res.update(flatten(params_to_numpy(whole), f"{name}/params/"))
    shards = fsdp if zero1 is None else zero1.layout
    for i, leaf in enumerate(trainer.opt_state_leaves(opt, opt_tree, mesh, guard=g,
                                                      shards=shards)):
        res[f"{name}/opt/{i}"] = leaf
    res[f"{name}/moment_bytes"] = np.int64(trainer.moment_bytes(opt))
    res[f"{name}/moment_numel"] = np.array([opt.state[t]["exp_avg"].numel()
                                            for t in trainer.leaves(opt_tree)])


def library_cases(res, data, mesh, dp):
    for zero in ("", "zero1"):
        train(res, f"dp_fused_bf16{zero}", data, dp, "fused_train", zero,
              compute_dtype=torch.bfloat16)
        train(res, f"dp_eager{zero}", data, dp, "eager", zero, guard=True, grad_accum=2,
              grad_clip=0.05)
        train(res, f"dp_freeze{zero}", data, dp, "eager", zero, freeze=True)
        train(res, f"tp_fused{zero}", data, mesh, "fused_train", zero,
              compute_dtype=torch.bfloat16)
    for zero in ("", "fsdp"):
        for ops_name in ("eager", "qat"):
            train(res, f"dp_{ops_name}_f{zero}", data, dp, ops_name, zero)
            train(res, f"tp_{ops_name}_f{zero}", data, mesh, ops_name, zero, guard=True)


def cli_cases(res, init: Path, out: Path, rank: int):
    """The train CLI over the four ranks: pairs of runs that differ by
    --zero1 or --fsdp alone, and resumes across them."""
    from vit_tpu_torch.cli.train import main

    config.CONFIGS[TINY.name] = TINY
    base = ["--config", TINY.name, "--batch", "4", "--device", "cpu", "--dist-backend", "gloo",
            "--lr", str(LR), "--weight-decay", str(WD)]
    dp2tp2 = ["--dp", "2", "--tp", "2"]
    recipe = ["--wd-exempt-norm-bias", "--grad-clip", "0.05", "--skip-nonfinite",
              "--ema-decay", "0.9"]
    runs = {
        "eager": [*dp2tp2, "--ops", "eager", "--steps", "3", *recipe],
        "eager_zero1": [*dp2tp2, "--ops", "eager", "--steps", "3", "--zero1", *recipe],
        "eager_fsdp": [*dp2tp2, "--ops", "eager", "--steps", "3", "--fsdp", *recipe],
        # both flags: FSDP's placement, as in the JAX package
        "eager_zero1_fsdp": [*dp2tp2, "--ops", "eager", "--steps", "3", "--zero1", "--fsdp",
                             *recipe],
        "qat": [*dp2tp2, "--ops", "qat", "--steps", "3"],
        "qat_fsdp": [*dp2tp2, "--ops", "qat", "--steps", "3", "--fsdp"],
        "fused": [*dp2tp2, "--ops", "fused_train", "--mixed-precision", "--steps", "3",
                  "--freeze-backbone"],
        "fused_zero1": [*dp2tp2, "--ops", "fused_train", "--mixed-precision", "--steps", "3",
                        "--freeze-backbone", "--zero1"],
        "mae": ["--dp", "4", "--ops", "fused_train", "--mae", "--mae-decoder", "32,1,2",
                "--steps", "2"],
        "mae_zero1": ["--dp", "4", "--ops", "fused_train", "--mae", "--mae-decoder", "32,1,2",
                      "--steps", "2", "--zero1"],
        # one more step from the plain and the ZeRO archives, each way
        "resume_plain": [*dp2tp2, "--ops", "eager", "--steps", "1", *recipe,
                         "--resume", str(out / "eager.state.npz")],
        "resume_plain_zero1": [*dp2tp2, "--ops", "eager", "--steps", "1", *recipe, "--zero1",
                               "--resume", str(out / "eager.state.npz")],
        "resume_zero1_plain": [*dp2tp2, "--ops", "eager", "--steps", "1", *recipe,
                               "--resume", str(out / "eager_zero1.state.npz")],
        "resume_plain_fsdp": [*dp2tp2, "--ops", "eager", "--steps", "1", *recipe, "--fsdp",
                              "--resume", str(out / "eager.state.npz")],
        "resume_fsdp_plain": [*dp2tp2, "--ops", "eager", "--steps", "1", *recipe,
                              "--resume", str(out / "eager_fsdp.state.npz")],
    }
    for name, flags in runs.items():
        init_flags = [] if name.startswith("mae") else ["--init-weights", str(init)]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([*base, *init_flags, *flags, "--log-jsonl", str(out / f"{name}.jsonl"),
                       "--save-state", str(out / f"{name}.state.npz")])
        res[f"cli_{name}/rc"] = np.int32(rc)
        if rank == 0:
            res[f"cli_{name}/stdout"] = np.array(buf.getvalue())


def main(inp: str, out: str) -> None:
    data = dict(np.load(inp))
    assert distributed.initialize(backend="gloo", device_type="cpu") == "gloo"
    rank = dist.get_rank()
    mesh = make_mesh({"dp": 2, "tp": 2})
    # each tp column's two ranks: a dp 2 group of its own
    dp = Mesh({"dp": 2}, mesh.index("dp"), {"dp": mesh.groups["dp"]})
    res = {}
    library_cases(res, data, mesh, dp)
    eng = InferenceEngine(TINY, unflatten(data, "params/"), dtype="float32", ops="eager",
                          device="cpu", mesh=mesh, batch_pad=4)
    res["eager_dp2tp2_logits"] = eng.logits(data["images"]).numpy()
    cli_cases(res, Path(inp).parent / "init.npz", Path(out).parent, rank)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("vit_tpu", "jax", "jaxlib"))
    assert not loaded, loaded
    np.savez(f"{out}.{rank}.npz", **res)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
