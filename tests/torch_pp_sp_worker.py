"""One rank of the 4-rank gloo group that ``test_torch_pipeline.py`` (``pp``)
or ``test_torch_sequence.py`` (``sp``) starts:

    python -m torch.distributed.run --standalone --nproc-per-node 4 \
        tests/torch_pp_sp_worker.py {pp,sp} IN.npz OUT

Reads the params and batches from ``IN.npz`` (made with numpy and the JAX
package's initializers by the test, which hands the same arrays to the JAX
package), runs the port's pipelined or sequence-parallel forwards, train
steps and train CLI on the CPU, and writes every result to
``OUT.<rank>.npz``.  The meshes: pp 2 (two pipelines, ranks 0-1 and 2-3),
pp 4, dp 2 x pp 2 and pp 2 x tp 2; sp 2 (two rings), sp 4 and dp 2 x sp 2.
Imports nothing of JAX.
"""

import contextlib
import dataclasses
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from vit_tpu_torch import config
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.ops import quant
from vit_tpu_torch.parallel import make_mesh
from vit_tpu_torch.parallel.mesh import BroadcastFrom, Mesh, Shift, shift
from vit_tpu_torch.parallel.pipeline import make_pp_train_step, shard_forward_pp
from vit_tpu_torch.parallel.sequence import attention_sp, make_sp_train_step, shard_forward_sp
from vit_tpu_torch.parallel.sharding import shard_params, unshard_params
from vit_tpu_torch.runtime import distributed, trainer

# depth 4 divides pp 2 and 4 (tests/test_pipeline.py's config)
PP = config.ViTConfig(image_size=32, patch_size=16, embed_dim=64, depth=4, num_heads=4,
                      num_classes=11, name="vit_tiny_pp")
REG = dataclasses.replace(PP, dropout=0.2, drop_path=0.3)
# 5 tokens over sp 4: the last shard all padding (tests/test_sequence_parallel.py's)
SP = config.ViTConfig(image_size=32, patch_size=16, embed_dim=64, depth=3, num_heads=4,
                      num_classes=13, name="vit_tiny_sp")
SP_CONFIGS = {"sp64": dataclasses.replace(SP, image_size=64, name="vit_tiny_sp64"),
              "sp96": dataclasses.replace(SP, image_size=96, name="vit_tiny_sp96"),
              "sp_long": dataclasses.replace(SP, image_size=1024, depth=2,
                                             name="vit_tiny_sp_long"),
              "deit": config.ViTConfig(image_size=32, patch_size=8, embed_dim=64, depth=2,
                                       num_heads=4, num_classes=11, distilled=True,
                                       name="deit_tiny_sp")}
SGD_LR = 0.05


def unflatten(flat: dict, prefix: str = "") -> dict:
    tree = {}
    for key, value in flat.items():
        if key.startswith(prefix):
            *parts, leaf = key[len(prefix):].split("/")
            at = tree
            for p in parts:
                at = at.setdefault(p, {})
            at[leaf] = value
    return tree


def flatten(tree, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def res_tree(res: dict, name: str) -> dict:
    """The flat params tree a case put into a rank's results."""
    return {k[len(name) + len("/params/"):]: v for k, v in res.items()
            if k.startswith(f"{name}/params/")}


def leaf_close(got: dict, want: dict, cfg, atol: float, rtol: float = 0.0,
               adam_steps: int = 0, lr: float = 1e-3) -> None:
    """Every leaf of two flat trees within ``atol`` + ``rtol`` x |want|.
    ``adam_steps``: the key bias's columns within that many Adam steps of
    ``lr`` instead (its gradient is rounding noise around an exact zero)."""
    assert got.keys() == want.keys()
    keys = (np.arange(3 * cfg.embed_dim) // cfg.head_dim) % 3 == 1
    for k in want:
        g, w = got[k], want[k]
        if adam_steps and k.endswith("blocks/bqkv"):
            bound = adam_steps * lr + 1e-6
            assert np.abs(g[..., keys]).max() <= bound and np.abs(w[..., keys]).max() <= bound
            g, w = g[..., ~keys], w[..., ~keys]
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=k)


def sgd(params, lr=SGD_LR):
    return torch.optim.SGD(list(trainer.leaves(params)), lr=lr)


def local(arr: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    n = len(arr) // mesh.size("dp")
    return arr[mesh.index("dp") * n:(mesh.index("dp") + 1) * n]


def step_case(res, name, step_fn, tree, mesh, x, y, shard: bool):
    """One step on this rank's part of ``tree`` and its dp slice of (x, y):
    the loss and the whole params after it into ``res``."""
    params = trainer.as_trainable(shard_params(tree, mesh) if shard else tree, "cpu")
    loss = step_fn(params)(params, local(x, mesh), local(y, mesh))
    res[f"{name}/loss"] = np.float32(float(loss))
    whole = unshard_params(params, mesh) if shard else params
    res.update(flatten(params_to_numpy(whole), f"{name}/params/"))


def pp_cases(res, data):
    tree = params_from_numpy(unflatten(data, "params/"), "cpu")
    x, y = torch.from_numpy(data["images"]), torch.from_numpy(data["labels"])
    dppp = make_mesh({"dp": 2, "pp": 2})
    pp2 = Mesh({"pp": 2}, dppp.index("pp"), {"pp": dppp.groups["pp"]})
    pp4 = make_mesh({"pp": 4})
    pptp = make_mesh({"pp": 2, "tp": 2})
    meshes = {"pp2": pp2, "pp4": pp4, "dp2pp2": dppp, "pp2tp2": pptp}

    # forwards: whole batch in, whole logits out on every rank
    for name, mesh, m, ops in (("eager_pp2", "pp2", 4, "eager"), ("eager_pp4", "pp4", 4, "eager"),
                               ("fused_pp2", "pp2", 4, "fused"), ("fused_pp4", "pp4", 4, "fused"),
                               ("eager_pp2_m2", "pp2", 2, "eager"),
                               ("eager_pp2_m8", "pp2", 8, "eager"),
                               ("eager_dp2pp2", "dp2pp2", 2, "eager"),
                               ("fused_pp2tp2", "pp2tp2", 2, "fused"),
                               ("fused_train_pp2tp2", "pp2tp2", 2, "fused_train")):
        mesh = meshes[mesh]
        fwd = shard_forward_pp(PP, mesh, m, ops_name=ops)
        res[f"{name}/logits"] = fwd(shard_params(tree, mesh), x).numpy()
    qtree = quant.cast_quantized_params(quant.quantize_params(tree), torch.float32)
    res["quant_pp2tp2/logits"] = shard_forward_pp(PP, pptp, 2, ops_name="quant")(
        shard_params(qtree, pptp), x).numpy()

    # train steps (SGD), params gathered whole after one step
    def pp_step(cfg, mesh, m, ops, **kw):
        return lambda p: make_pp_train_step(cfg, sgd(p), mesh, m, ops_name=ops, **kw)

    for name, mesh, m, ops in (("train_eager_pp2", pp2, 4, "eager"),
                               ("train_fused_pp2", pp2, 4, "fused_train"),
                               ("train_fused_dp2pp2", dppp, 2, "fused_train"),
                               ("train_fused_pp2tp2", pptp, 2, "fused_train")):
        step_case(res, name, pp_step(PP, mesh, m, ops), tree, mesh, x, y, True)
    step_case(res, "train_clip_pp2", pp_step(PP, pp2, 4, "eager", grad_clip=0.05), tree, pp2,
              x, y, True)
    for ops in ("eager", "fused_train"):
        step_case(res, f"drop_{ops}_m1", pp_step(REG, pp2, 1, ops, use_dropout=True,
                                                 rng=torch.Generator().manual_seed(21)),
                  tree, pp2, x, y, True)
    for name, cfg, drop in (("drop_m2", REG, True), ("drop_m2_again", REG, True),
                            ("zero_rates_m2", PP, True), ("plain_m2", PP, False)):
        kw = {"use_dropout": True, "rng": torch.Generator().manual_seed(33)} if drop else {}
        step_case(res, name, pp_step(cfg, pp2, 2, "fused_train", **kw), tree, pp2, x, y, True)

    for name, mesh in (("pp4", pp4), ("pp2tp2", pptp)):
        part = shard_params(tree, mesh)
        res[f"roundtrip_{name}"] = np.array(all(
            torch.equal(a, b) for a, b in zip(trainer.leaves(unshard_params(part, mesh)),
                                              trainer.leaves(tree))))
        res[f"local_wqkv_{name}"] = np.array(part["blocks"]["wqkv"].shape)


def sp_cases(res, data):
    sp4 = make_mesh({"sp": 4})
    dpsp = make_mesh({"dp": 2, "sp": 2})
    sp2 = Mesh({"sp": 2}, dpsp.index("sp"), {"sp": dpsp.groups["sp"]})
    r = sp4.index("sp")

    # ring attention on 22 tokens padded to 24, 6 a shard
    ring = unflatten(data, "ring/")
    w = {k: torch.from_numpy(v) for k, v in ring.items()}
    xp = torch.cat([w["x"], torch.zeros(2, 2, 64)], dim=1)
    valid = (torch.arange(24) < 22).reshape(4, 6)
    res["ring/out"] = attention_sp(xp[:, 6 * r:6 * (r + 1)], w["wqkv"], w["bqkv"], w["wo"],
                                   w["bo"], 4, valid, sp4).numpy()

    # the cyclic shift bit for bit, and its transpose; the broadcast's
    # gradient on its source alone
    t = torch.from_numpy(data["shift/f32"][r].copy())
    res["shift/f32"] = shift(t, sp4, "sp").view(torch.int32).numpy()
    tb = t.to(torch.bfloat16)
    res["shift/bf16"] = shift(tb, sp4, "sp", -1).view(torch.int16).numpy()
    res["shift/sent_bf16"] = tb.view(torch.int16).numpy()
    xg = torch.full((4,), float(r + 1), requires_grad=True)
    (Shift.apply(xg, sp4, "sp") * torch.arange(4.0) * (r + 1)).sum().backward()
    res["shift/grad"] = xg.grad.numpy()
    xb = torch.full((3,), float(r + 1), requires_grad=True)
    got = BroadcastFrom.apply(xb, sp4, "sp", 1)
    (got * 2.0).sum().backward()
    res["bcast/value"], res["bcast/grad"] = got.detach().numpy(), xb.grad.numpy()

    # forwards
    base = params_from_numpy(unflatten(data, "sp/params/"), "cpu")
    x, y = torch.from_numpy(data["sp/images"]), torch.from_numpy(data["sp/labels"])
    for name, mesh, ops in (("eager_sp4", sp4, "eager"), ("fused_train_sp4", sp4, "fused_train"),
                            ("eager_dp2sp2", dpsp, "eager")):
        res[f"{name}/logits"] = shard_forward_sp(SP, mesh, ops_name=ops)(base, x).numpy()
    for name, cfg in SP_CONFIGS.items():
        mesh = sp2 if name == "deit" else sp4
        tree = params_from_numpy(unflatten(data, f"{name}/params/"), "cpu")
        res[f"{name}/logits"] = shard_forward_sp(cfg, mesh)(
            tree, torch.from_numpy(data[f"{name}/images"])).numpy()

    # train steps
    def sp_step(mesh, ops, **kw):
        return lambda p: make_sp_train_step(SP, sgd(p, 0.1), mesh, ops_name=ops, **kw)

    step_case(res, "train_eager_sp4", sp_step(sp4, "eager"), base, sp4, x, y, False)
    step_case(res, "train_fused_sp4", sp_step(sp4, "fused_train"), base, sp4, x, y, False)
    step_case(res, "train_fused_dp2sp2", sp_step(dpsp, "fused_train"), base, dpsp, x, y, False)
    for ops in ("eager", "fused_train"):
        step_case(res, f"train_bf16_{ops}_sp2",
                  sp_step(sp2, ops, compute_dtype=torch.bfloat16), base, sp2, x, y, False)


def cli_cases(res, mode: str, init: Path, out: Path, rank: int):
    """The train CLI over the group, rank 0 alone printing and writing:
    ``--pp 2 --dp 2`` for 3 steps with ``--save-state``, resumed for 1 step;
    ``--sp 2 --dp 2`` for 3 steps."""
    from vit_tpu_torch.cli.train import main

    cfg = PP if mode == "pp" else SP
    config.CONFIGS[cfg.name] = cfg
    base = ["--config", cfg.name, "--init-weights", str(init), "--batch", "4", "--ops", "eager",
            "--device", "cpu", "--dist-backend", "gloo", "--dp", "2"]
    if mode == "pp":
        runs = {"cli": ["--pp", "2", "--microbatches", "2", "--steps", "3", "--save-state", str(out / "state.npz")],
                "cli_resumed": ["--pp", "2", "--microbatches", "2", "--steps", "1", "--resume", str(out / "state.npz")]}
    else:
        runs = {"cli": ["--sp", "2", "--steps", "3", "--label-smoothing", "0.1"]}
    for name, flags in runs.items():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = main([*base, *flags, "--log-jsonl", str(out / f"{name}.jsonl"),
                       "--save", str(out / f"{name}.npz")])
        res[f"{name}/rc"] = np.int32(rc)
        res[f"{name}/stdout_lines"] = np.int32(len(buf.getvalue().splitlines()))
        if rank == 0:
            res[f"{name}/stdout"] = np.array(buf.getvalue())


def start_group(mode: str, d: Path, arrays: dict, timeout: int = 420) -> list:
    """Write ``arrays`` to ``d/in.npz``, run the 4-rank group in ``mode``
    over them (``d/init.npz`` is the CLI runs' --init-weights) -> the ranks'
    result dicts."""
    repo = Path(__file__).resolve().parents[1]
    np.savez(d / "in.npz", **arrays)
    (d / "out").mkdir()
    env = dict(os.environ, PYTHONPATH=f"{repo}:{repo / 'tests'}", OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4", "--standalone",
         __file__, mode, str(d / "in.npz"), str(d / "out" / "res")],
        cwd=d, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return [dict(np.load(d / "out" / f"res.{r}.npz")) for r in range(4)]


def main(mode: str, inp: str, out: str) -> None:
    torch.set_num_threads(1)
    data = dict(np.load(inp))
    assert distributed.initialize(backend="gloo", device_type="cpu") == "gloo"
    rank = dist.get_rank()
    res = {}
    (pp_cases if mode == "pp" else sp_cases)(res, data)
    cli_cases(res, mode, Path(inp).parent / "init.npz", Path(out).parent, rank)
    np.savez(f"{out}.{rank}.npz", **res)


if __name__ == "__main__":
    main(*sys.argv[1:4])
