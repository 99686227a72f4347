"""One rank of the 2-rank gloo group that ``test_torch_parallel_train.py``
starts:

    python -m torch.distributed.run --standalone --nproc-per-node 2 \
        tests/torch_parallel_train_worker.py IN.npz OUT

Reads the params, images and labels of every case from ``IN.npz`` (made
with numpy and the JAX package's initializers by the test, which hands the
same arrays to the JAX package), runs the port's tensor- and
data-parallel train steps and the train CLI (``--tp 2`` on ``fused_train``
and on the plain tiers, ``--dp 2``) on the CPU, and writes every result to
``OUT.<rank>.npz``.  With ``--cli ARGS... [--and ARGS...]`` it
is one rank of the train CLI on the tiny test configs instead, one run
after another (the 4-rank run, the data runs).
Imports nothing of JAX.
"""

import contextlib
import dataclasses
import io
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from vit_tpu_torch import config
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.models import mae, tome, vit
from vit_tpu_torch.ops import fused_block
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.parallel import make_mesh
from vit_tpu_torch.parallel.sharding import shard_params, unshard_params
from vit_tpu_torch.runtime import distributed, trainer

TINY = config.ViTConfig(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                        num_classes=11, name="vit_tiny_test")
TOME = dataclasses.replace(TINY, depth=3, image_size=64, patch_size=8, name="vit_tome_test")
DEIT = config.ViTConfig(image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
                        num_classes=11, distilled=True, name="deit_tiny_test")
TEACHER = dataclasses.replace(DEIT, distilled=False, name="teacher_tiny")
MAE = mae.MAEConfig(mask_ratio=0.5, decoder_dim=32, decoder_depth=2, decoder_heads=2)
SGD_LR, ADAMW_LR, WD = 0.05, 1e-3, 0.05


def unflatten(flat: dict, prefix: str) -> dict:
    tree = {}
    for key, value in flat.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].split("/")
        at = tree
        for p in parts[:-1]:
            at = at.setdefault(p, {})
        at[parts[-1]] = value
    return tree


def flatten(tree, prefix: str) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def sgd(params):
    return torch.optim.SGD(list(trainer.leaves(params)), lr=SGD_LR)


def adamw(params):
    return torch.optim.AdamW(list(trainer.leaves(params)), lr=ADAMW_LR, weight_decay=WD)


def fused_adamw(params):
    return trainer.FusedAdamW(list(trainer.leaves(params)), lr=ADAMW_LR, weight_decay=WD)


def local(arr, mesh):
    """This rank's dp slice of a global batch."""
    n = len(arr) // mesh.size("dp")
    return torch.from_numpy(arr[mesh.index("dp") * n:(mesh.index("dp") + 1) * n])


def run_case(res, name, data, mesh, make_step, shard=False):
    """One step of ``make_step(params) -> step`` on this rank's part of the
    case's params and batch; the loss and the whole params after it go into
    ``res`` under ``name``."""
    tree = params_from_numpy(unflatten(data, f"{name}/params/"), "cpu")
    if shard:
        tree = shard_params(tree, mesh)
    params = trainer.as_trainable(tree, "cpu")
    step = make_step(params)
    loss = step(params, local(data[f"{name}/images"], mesh), local(data[f"{name}/labels"], mesh))
    whole = unshard_params(params, mesh) if shard else params
    res[f"{name}/loss"] = np.float32(float(loss))
    res.update(flatten(params_to_numpy(whole), f"{name}/params/"))


def tp_cases(res, data, tp2):
    def kernel_tp(opt, **kw):
        return lambda p: trainer.make_train_step_kernel_tp(TINY, opt(p), tp2, **kw)

    run_case(res, "tp", data, tp2, kernel_tp(sgd), shard=True)
    run_case(res, "tp_bf16", data, tp2, kernel_tp(sgd, compute_dtype=torch.bfloat16),
             shard=True)
    run_case(res, "tp_clip", data, tp2, kernel_tp(sgd, grad_clip=0.05), shard=True)
    run_case(res, "tp_adamw", data, tp2, kernel_tp(adamw), shard=True)
    fused_block.VMEM_ATTENTION_MAX_T = 4  # past the switch (the tiny config has 5 tokens)
    run_case(res, "tp_long", data, tp2, kernel_tp(sgd), shard=True)
    fused_block.VMEM_ATTENTION_MAX_T = 1024
    # the shard and gather are inverses, and each rank holds its own part
    tree = params_from_numpy(unflatten(data, "tp/params/"), "cpu")
    part = shard_params(tree, tp2)
    res["tp_roundtrip"] = np.array(all(
        torch.equal(a, b) for a, b in zip(trainer.leaves(unshard_params(part, tp2)),
                                          trainer.leaves(tree))))
    res["tp_local_w1_shape"] = np.array(part["blocks"]["w1"].shape)


def dp_cases(res, data, dp2):
    fused_train, eager = get_ops("fused_train"), get_ops("eager")

    def dp(cfg, opt, ops, **kw):
        return lambda p: trainer.make_train_step_dp(cfg, opt(p), dp2, ops, **kw)

    run_case(res, "dp_adamw", data, dp2, dp(TINY, adamw, fused_train, remat=False))
    run_case(res, "dp_fused_adamw", data, dp2, dp(TINY, fused_adamw, fused_train, remat=False))
    run_case(res, "dp_accum", data, dp2, dp(TINY, sgd, fused_train, remat=False, grad_accum=2))
    run_case(res, "dp_eager", data, dp2, dp(TINY, sgd, eager))
    run_case(res, "dp_smooth", data, dp2, dp(TINY, sgd, fused_train, remat=False,
                                             label_smoothing=0.1))
    run_case(res, "dp_tome", data, dp2, dp(
        TOME, sgd, fused_train, remat=False,
        forward_fn=lambda p, x, rng: tome.forward_train(p, x, TOME, 4, dropout_rng=rng)))
    teacher = params_from_numpy(unflatten(data, "teacher/"), "cpu")
    run_case(res, "dp_distill", data, dp2, lambda p: trainer.make_distill_train_step(
        DEIT, sgd(p), lambda x: vit.forward(teacher, x, TEACHER, get_ops("fused")),
        fused_train, remat=False, mesh=dp2))

    # dropout: the step's seed folded with the dp index, each rank its own
    # masks; the params still equal on every rank after the step
    reg = dataclasses.replace(TINY, dropout=0.1, drop_path=0.1)
    seeds = []

    def spy(p, x, rng):
        seeds.append(rng.initial_seed())
        return vit.forward(p, x, reg, fused_train, dropout_rng=rng)

    run_case(res, "dp_dropout", data, dp2, dp(
        reg, sgd, fused_train, remat=False, use_dropout=True,
        rng=torch.Generator().manual_seed(0), forward_fn=spy))
    res["dp_dropout_seed"] = np.array(seeds, dtype=np.uint64)


def mae_case(res, data, dp2, monkey):
    """MAE over dp 2 on the masks of one noise tensor (``masks_from_noise``),
    and the single-rank MAE step on the same masks."""
    noise = torch.from_numpy(data["mae/noise"])
    n = len(noise) // 2
    for name, mesh, rows in (("mae_dp", dp2, noise[dp2.index("dp") * n:(dp2.index("dp") + 1) * n]),
                             ("mae_single", None, noise)):
        monkey(mae, "random_mask", lambda gen, b, npatch, k, _r=rows: mae.masks_from_noise(_r, k))
        tree = trainer.as_trainable(params_from_numpy(unflatten(data, "mae/params/"), "cpu"),
                                    "cpu")
        step = trainer.make_mae_train_step(TINY, MAE, sgd(tree), torch.Generator(),
                                           get_ops("fused_train"), mesh=mesh)
        images = data["mae/images"]
        x = local(images, dp2) if mesh is not None else torch.from_numpy(images)
        res[f"{name}/loss"] = np.float32(float(step(tree, x)))
        res.update(flatten(params_to_numpy(tree), f"{name}/params/"))


def cli_cases(res, init: Path, out: Path, rank: int, data: dict, monkey):
    """The train CLI over the group, ``--tp 2`` and ``--dp 2`` on
    ``fused_train``, and ``--tp 2`` on the plain tiers (``eager``, ``qat``,
    MAE on ``eager`` resumed from the test's archive, with its masks from
    the test's noise, and distillation on ``eager``): the same arguments on
    both ranks; rank 0 alone prints and writes."""
    from vit_tpu_torch.cli.train import main

    config.CONFIGS[TINY.name] = TINY
    config.CONFIGS[DEIT.name] = DEIT
    d = init.parent
    noise = torch.from_numpy(data["mae/noise"])
    monkey(mae, "random_mask", lambda gen, b, npatch, k: mae.masks_from_noise(noise, k))
    common = ["--steps", "3", "--batch", "4", "--device", "cpu", "--dist-backend", "gloo"]
    base = ["--config", TINY.name, "--init-weights", str(init), *common, "--ops", "fused_train"]
    plain_tp = {
        "cli_tp_eager": ["--config", TINY.name, "--init-weights", str(init), "--ops", "eager"],
        "cli_tp_qat": ["--config", TINY.name, "--init-weights", str(init), "--ops", "qat"],
        "cli_tp_mae": ["--config", TINY.name, "--ops", "eager", "--mae", "--mask-ratio", "0.5",
                       "--mae-decoder", "32,2,2", "--resume", str(d / "mae_state.npz")],
        "cli_tp_distill": ["--config", DEIT.name, "--init-weights", str(d / "deit.npz"),
                           "--ops", "eager", "--distill-teacher", str(d / "teacher.npz")],
    }
    runs = [("cli_tp", [*base, "--tp", "2"]), ("cli_dp", [*base, "--dp", "2"])]
    runs += [(name, [*flags, *common, "--tp", "2"]) for name, flags in plain_tp.items()]
    for name, flags in runs:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([*flags, "--log-jsonl", str(out / f"{name}.jsonl"),
                       "--save", str(out / f"{name}.npz")])
        res[f"{name}/rc"] = np.int32(rc)
        res[f"{name}/stdout_lines"] = np.int32(len(buf.getvalue().splitlines()))
        if rank == 0:
            res[f"{name}/stdout"] = np.array(buf.getvalue())


def main(inp: str, out: str) -> None:
    data = dict(np.load(inp))
    assert distributed.initialize(backend="gloo", device_type="cpu") == "gloo"
    rank = dist.get_rank()
    res = {}
    tp2 = make_mesh({"dp": 1, "tp": 2})
    dp2 = make_mesh({"dp": 2, "tp": 1})
    tp_cases(res, data, tp2)
    dp_cases(res, data, dp2)
    patched = []

    def monkey(mod, name, value):
        patched.append((mod, name, getattr(mod, name)))
        setattr(mod, name, value)

    mae_case(res, data, dp2, monkey)
    cli_cases(res, Path(inp).parent / "init.npz", Path(out).parent, rank, data, monkey)
    for mod, name, value in reversed(patched):
        setattr(mod, name, value)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("vit_tpu", "jax", "jaxlib"))
    assert not loaded, loaded
    np.savez(f"{out}.{rank}.npz", **res)


def cli(argv) -> int:
    """One rank of the train CLI with the tiny test configs registered;
    ``--and`` separates runs made in turn (-> the worst exit code)."""
    from vit_tpu_torch.cli.train import main as train_main

    config.CONFIGS[TINY.name] = TINY
    runs, rc = [[]], 0
    for arg in argv:
        if arg == "--and":
            runs.append([])
        else:
            runs[-1].append(arg)
    for run in runs:
        rc = max(rc, train_main(run))
    return rc


if __name__ == "__main__":
    if sys.argv[1] == "--cli":
        sys.exit(cli(sys.argv[2:]))
    main(sys.argv[1], sys.argv[2])
