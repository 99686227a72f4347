"""Parallel training in the port — K8's ``residual=False`` twin, the
tensor-parallel step through the fused kernels
(``trainer.make_train_step_kernel_tp``), the data-parallel steps
(``make_train_step_dp``, MAE and distillation over ``dp``) and the train
CLI's ``--tp``/``--dp`` (``--tp`` on ``fused_train`` and on the plain
tiers) — against the JAX package on the CPU: its Pallas
kernels in interpret mode and its ``shard_map``/GSPMD steps on the virtual
8-device mesh, the port in one 2-rank gloo group of its own
(``torch_parallel_train_worker.py``, started once for the module), plus one
4-rank ``torchrun`` of the CLI, started with it: both run while the JAX
references are computed.

Tolerances.  K8's twin against the Pallas kernel: fp32 1e-4
(``test_torch_flash.py``'s bar), bf16 2e-2 of each output's largest |value|
(``test_torch_backward.py``'s).  The tp 2 SGD step: loss 1e-6 and every
leaf 1e-5 (``tests/test_parallel.py:262-263``), against the JAX package's
``jit_train_step_kernel_tp`` and against the port's own single-rank
``fused_train`` step.  Past the switch loss 1e-6 and every leaf 1e-4
(``test_parallel.py:318-319``).  The other steps against the JAX
package: loss 1e-5 and every leaf 1e-4, the bar ``test_torch_train.py``
holds the single-device step to.  bf16 mixed
precision, AdamW (the key bias, whose gradient is rounding noise around
an exact zero), ToMe, distillation and the CLIs as the single-device files
hold them (``test_torch_train.py``, ``test_torch_tome_train.py``,
``test_torch_distill.py``).  The CLI's ``--tp 2`` on the plain tiers against
the JAX CLI's: the first loss within 1e-5 relative, the later ones within
the CLI bar 1e-4 (AdamW scales rounding-noise gradients up to about lr a
step); on ``qat`` the first loss within 1e-4 and the later ones within the
flip budget 2^-6 (``test_torch_qat.py``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vit_tpu.ops.pallas.backward as JB
from vit_tpu.io import checkpoint as jckpt
from vit_tpu.io.load_any import load_params_any as jload_any
from vit_tpu.models import mae as jmae
from vit_tpu.models import tome as jtome
from vit_tpu.models import vit as jvit
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu.parallel import make_mesh as jmake_mesh
from vit_tpu.parallel.sharding import batch_sharding, param_shardings
from vit_tpu.parallel.sharding import shard_params as jshard_params
from vit_tpu.runtime import trainer as jtrainer
from vit_tpu_torch.cli import common, train_setup
from vit_tpu_torch.cli.train import main as tmain
from vit_tpu_torch.cli.train_args import build_parser
from vit_tpu_torch.io.load_any import load_params_any as tload_any
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.models import mae as tmae
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.ops.kernels.ln_mlp_residual_bwd import ln_mlp_residual_bwd
from vit_tpu_torch.parallel.mesh import Mesh
from vit_tpu_torch.runtime import trainer as ttrainer

import torch_parallel_train_worker as W

REPO = Path(__file__).resolve().parents[1]
EPS = 1e-6
# the AdamW runs' rate: one step moves every leaf by about lr
LR = W.ADAMW_LR

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _jtree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


def _batch(seed, b, cfg):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
    return x, rng.integers(0, cfg.num_classes, b).astype(np.int32)


def _key_columns(cfg):
    """Mask of the packed QKV's key columns ((head, {q,k,v}, dh) order)."""
    dh = cfg.embed_dim // cfg.num_heads
    return (np.arange(3 * cfg.embed_dim) // dh) % 3 == 1


def _leaf_close(got: dict, want: dict, atol: float, adam_cfg=None, steps: int = 1):
    """Every leaf of two flat trees within ``atol``.  ``adam_cfg``: after
    ``steps`` Adam steps the key bias's columns are held to ``steps`` x lr
    instead (its gradient is rounding noise around an exact zero, which
    Adam scales up to about lr a step)."""
    assert got.keys() == want.keys()
    for k in want:
        g, w = got[k], want[k]
        if adam_cfg is not None and k.endswith("blocks/bqkv"):
            kc, bound = _key_columns(adam_cfg), steps * LR + 1e-6
            assert np.abs(g[..., kc]).max() <= bound and np.abs(w[..., kc]).max() <= bound
            g, w = g[..., ~kc], w[..., ~kc]
        np.testing.assert_allclose(g, w, atol=atol, rtol=0, err_msg=k)


def _updates_close(got: dict, want: dict, start: dict, rel: float):
    """Each leaf's update within ``rel`` of the largest update of that leaf."""
    for k in want:
        step = np.abs(want[k] - start[k]).max()
        assert np.abs(got[k] - want[k]).max() <= rel * step + 1e-6, k


# -- the inputs, the 2-rank group and the JAX references -----------------------------


@pytest.fixture(scope="module")
def cases(tiny_cfg):
    """name -> (params tree (numpy), images, labels) for each worker case,
    and the teacher and MAE noise."""
    tome_cfg = dataclasses.replace(tiny_cfg, depth=3, image_size=64, patch_size=8,
                                   name="vit_tome_test")
    tp = _jtree(jvit.init_params(jax.random.key(7), tiny_cfg))
    dp = _jtree(jvit.init_params(jax.random.key(5), tiny_cfg))
    out = {name: (tp, *_batch(7, 8, tiny_cfg))
           for name in ("tp", "tp_bf16", "tp_clip", "tp_adamw", "tp_long")}
    out.update({name: (dp, *_batch(5, 8, tiny_cfg))
                for name in ("dp_adamw", "dp_fused_adamw", "dp_accum", "dp_eager", "dp_smooth",
                             "dp_dropout")})
    x = np.random.default_rng(3).normal(size=(4, 3, 64, 64)).astype(np.float32)
    out["dp_tome"] = (_jtree(jvit.init_params(jax.random.key(0), tome_cfg)), x,
                      np.random.default_rng(4).integers(0, 11, 4).astype(np.int32))
    out["dp_distill"] = (_jtree(jvit.init_params(jax.random.key(4), W.DEIT)),
                         *_batch(3, 6, W.DEIT))
    jm = jmae.MAEConfig(mask_ratio=0.5, decoder_dim=32, decoder_depth=2, decoder_heads=2)
    out["mae"] = (_jtree(jmae.init_mae_params(jax.random.PRNGKey(3), tiny_cfg, jm)),
                  *_batch(4, 4, tiny_cfg))
    out["teacher"] = _jtree(jvit.init_params(jax.random.key(11), W.TEACHER))
    out["noise"] = np.array(jax.random.uniform(jax.random.PRNGKey(8), (4, tiny_cfg.num_patches)))
    out["tome_cfg"] = tome_cfg
    return out


# the two torchrun runs of the worker: the 2-rank group and the 4-rank CLI
# at --dp 2 --tp 2 (the JAX CLI test's mesh, tests/test_cli.py)
RANK_RUNS = ("group", "four")


@pytest.fixture(scope="module")
def launched(tmp_path_factory, cases, tiny_cfg):
    """The worker's inputs, and both torchrun runs of
    ``torch_parallel_train_worker.py`` started at once, each rank at one
    torch thread, so that they run while this process computes the JAX
    references; -> (dir, {run: Popen}).  Each run's stdout and stderr go to
    ``dir/<run>.out``/``.err``; a run still going at teardown is killed."""
    d = tmp_path_factory.mktemp("group")
    arrays = {}
    for name, case in cases.items():
        if name in ("teacher", "noise", "tome_cfg"):
            continue
        tree, x, y = case
        arrays.update(_flat(tree, f"{name}/params/"))
        arrays[f"{name}/images"], arrays[f"{name}/labels"] = x, y
    arrays.update(_flat(cases["teacher"], "teacher/"))
    arrays["mae/noise"] = cases["noise"]
    np.savez(d / "in.npz", **arrays)
    jckpt.save_npz(cases["tp"][0], str(d / "init.npz"))
    # the plain tiers' --tp 2 CLI runs: the DeiT student's and the teacher's
    # params, and MAE's start as a step-0 train state (--mae takes no
    # --init-weights)
    jckpt.save_npz(cases["dp_distill"][0], str(d / "deit.npz"))
    jckpt.save_npz(cases["teacher"], str(d / "teacher.npz"))
    mae_tree = jax.tree.map(jnp.asarray, cases["mae"][0])
    jckpt.save_train_state(mae_tree, optax.adamw(1e-3).init(mae_tree), 0,
                           str(d / "mae_state.npz"))
    (d / "out").mkdir()
    (d / "four").mkdir()
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO / 'tests'}", OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    worker = str(REPO / "tests" / "torch_parallel_train_worker.py")
    argv = {
        "group": ["2", worker, str(d / "in.npz"), str(d / "out" / "res")],
        "four": ["4", worker, "--cli", "--config", tiny_cfg.name, "--init-weights",
                 str(d / "init.npz"), "--steps", "3", "--batch", "4", "--ops", "fused_train",
                 "--device", "cpu", "--dist-backend", "gloo", "--dp", "2", "--tp", "2",
                 "--log-jsonl", str(d / "four" / "l.jsonl"), "--save", str(d / "four" / "p.npz")],
    }
    procs = {}
    for run in RANK_RUNS:
        n, *rest = argv[run]
        with open(d / f"{run}.out", "w") as out, open(d / f"{run}.err", "w") as err:
            procs[run] = subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", n,
                 "--standalone", *rest], cwd=d, env=env, stdout=out, stderr=err)
    yield d, procs
    for proc in procs.values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def _finished(launched, run: str, timeout: int):
    """-> (exit code, stdout, stderr) of the rank run ``run``."""
    d, procs = launched
    rc = procs[run].wait(timeout=timeout)
    return rc, (d / f"{run}.out").read_text(), (d / f"{run}.err").read_text()


@pytest.fixture(scope="module")
def group(launched, jax_cli, jax_tp_cli):
    """Both ranks' results of ``torch_parallel_train_worker.py`` (the JAX
    CLI references first: they are computed while the ranks run)."""
    d, _ = launched
    rc, _, err = _finished(launched, "group", 420)
    assert rc == 0, err[-4000:]
    r0, r1 = (dict(np.load(d / "out" / f"res.{r}.npz")) for r in (0, 1))
    return r0, r1, d


def _res_tree(res, name):
    return {k[len(name) + len("/params/"):]: v for k, v in res.items()
            if k.startswith(f"{name}/params/")}


def _jax_kernel_tp(cfg, tree, x, y, optimizer, mesh_shape, **kw):
    n = mesh_shape["dp"] * mesh_shape["tp"]
    mesh = jmake_mesh(mesh_shape, jax.devices()[:n])
    params = jax.tree.map(jnp.asarray, tree)
    opt0 = optimizer.init(params)
    p_s = jshard_params(params, mesh)
    o_s = jax.device_put(opt0, jtrainer._opt_state_shardings(
        opt0, p_s, param_shardings(mesh, p_s), mesh))
    step = jtrainer.jit_train_step_kernel_tp(cfg, optimizer, mesh, p_s, o_s, **kw)
    p, _, loss = step(p_s, o_s, jax.device_put(jnp.asarray(x), batch_sharding(mesh, 4)),
                      jax.device_put(jnp.asarray(y), batch_sharding(mesh, 1)))
    return _flat(jax.device_get(p), ""), float(loss)


def _jax_dp(cfg, tree, x, y, optimizer, ops="fused_train", **kw):
    mesh = jmake_mesh({"dp": 2}, jax.devices()[:2])
    params = jax.tree.map(jnp.asarray, tree)
    if kw.get("fused_adamw") is not None:
        opt0 = jtrainer.init_fused_adamw_state(params)
    else:
        opt0 = optimizer.init(params)
    if ops == "xla":
        step = jtrainer.jit_train_step_for_mesh(cfg, optimizer, mesh, params, opt0,
                                                ops=jget_ops("xla"), **kw)
    else:
        step = jtrainer.jit_train_step_dp_shard_map(cfg, optimizer, mesh, jget_ops(ops),
                                                    remat=False, **kw)
    p, _, loss = step(params, opt0, jnp.asarray(x), jnp.asarray(y))
    return _flat(jax.device_get(p), ""), float(loss)


def _port_single(cfg, tree, x, y, make_opt, ops="fused_train", **kw):
    params = ttrainer.as_trainable(params_from_numpy(tree, "cpu"), "cpu")
    step = ttrainer.make_train_step(cfg, make_opt(list(ttrainer.leaves(params))),
                                    get_ops(ops), remat=False, **kw)
    loss = step(params, torch.from_numpy(x), torch.from_numpy(y))
    return _flat(params_to_numpy(params), ""), float(loss)


def test_ranks_agree(group):
    # the whole params after every case, gathered, are the same bits on
    # both ranks: the replicated leaves stay equal, and so do the dp steps'
    r0, r1, _ = group
    for key in r0:
        if key.startswith(("dp_dropout_seed", "cli_")):
            continue
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)


# -- K8 residual=False: the twin against the Pallas kernel -------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows", [1, 37, 130])
@pytest.mark.parametrize("f", [128, 64], ids=["tp2", "tp4"])
def test_k8_partial_twin_matches_pallas(dtype, rows, f):
    d = 64  # the tiny config's D; F/tp of its MLP width 256 at tp 2 and 4
    arrays = [_np(40, rows, d), _np(41, rows, d, scale=2.0), _np(42, d, scale=0.2, shift=1.0),
              _np(43, d, scale=0.2), _np(44, d, f, scale=d ** -0.5), _np(45, f, scale=0.1),
              _np(46, f, d, scale=f ** -0.5)]
    want = JB.ln_mlp_residual_bwd(*(jnp.asarray(a).astype(dtype) for a in arrays), EPS,
                                  block_rows=16, interpret=True, residual=False)
    got = ln_mlp_residual_bwd(*(torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays),
                              EPS, residual=False)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.float().numpy(), np.asarray(w.astype(jnp.float32)).reshape(g.shape)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=f"output {i}")
        else:
            assert np.abs(g - w).max() <= 2e-2 * float(np.abs(w).max()), f"output {i}"


# -- the tensor-parallel step ----------------------------------------------------


def test_tp2_step_matches_jax_kernel_tp(group, cases, tiny_cfg):
    tree, x, y = cases["tp"]
    want, want_loss = _jax_kernel_tp(tiny_cfg, tree, x, y, optax.sgd(W.SGD_LR),
                                     {"dp": 1, "tp": 2})
    r0 = group[0]
    assert abs(float(r0["tp/loss"]) - want_loss) <= 1e-6
    _leaf_close(_res_tree(r0, "tp"), want, 1e-5)


def test_tp2_step_matches_single_rank_fused_train(group, cases, tiny_cfg):
    tree, x, y = cases["tp"]
    want, want_loss = _port_single(tiny_cfg, tree, x, y, lambda p: torch.optim.SGD(p, W.SGD_LR))
    r0 = group[0]
    assert abs(float(r0["tp/loss"]) - want_loss) <= 1e-6
    _leaf_close(_res_tree(r0, "tp"), want, 1e-5)


def test_tp2_long_step_matches_jax(group, cases, tiny_cfg, monkeypatch):
    from vit_tpu.ops.pallas import fused_block as JFB

    monkeypatch.setattr(JFB, "VMEM_ATTENTION_MAX_T", 4)  # T=5 > 4, as in the worker
    tree, x, y = cases["tp_long"]
    want, want_loss = _jax_kernel_tp(tiny_cfg, tree, x, y, optax.sgd(W.SGD_LR),
                                     {"dp": 1, "tp": 2})
    r0 = group[0]
    assert abs(float(r0["tp_long/loss"]) - want_loss) <= 1e-6
    _leaf_close(_res_tree(r0, "tp_long"), want, 1e-4)


def test_tp2_grad_clip_takes_the_global_norm(group, cases, tiny_cfg):
    # the norm binds (0.05 is far below the gradient's): a norm over one
    # rank's shards alone, or the whole leaves counted twice, moves every
    # update by its ratio
    tree, x, y = cases["tp_clip"]
    opt = optax.chain(optax.clip_by_global_norm(0.05), optax.sgd(W.SGD_LR))
    want, want_loss = _jax_kernel_tp(tiny_cfg, tree, x, y, opt, {"dp": 1, "tp": 2})
    unclipped, _ = _jax_kernel_tp(tiny_cfg, tree, x, y, optax.sgd(W.SGD_LR), {"dp": 1, "tp": 2})
    start = _flat(tree, "")
    assert max(np.abs(unclipped[k] - start[k]).max() - np.abs(want[k] - start[k]).max()
               for k in want) > 1e-3  # it binds
    got = _res_tree(group[0], "tp_clip")
    assert abs(float(group[0]["tp_clip/loss"]) - want_loss) <= 1e-5
    _updates_close(got, want, start, 1e-4)


def test_tp2_mixed_precision_matches_jax(group, cases, tiny_cfg):
    tree, x, y = cases["tp_bf16"]
    want, want_loss = _jax_kernel_tp(tiny_cfg, tree, x, y, optax.sgd(W.SGD_LR),
                                     {"dp": 1, "tp": 2}, compute_dtype=jnp.bfloat16)
    got = _res_tree(group[0], "tp_bf16")
    assert all(v.dtype == np.float32 for v in got.values())  # fp32 masters
    assert abs(float(group[0]["tp_bf16/loss"]) - want_loss) <= 2e-2
    _updates_close(got, want, _flat(tree, ""), 2e-2)


def test_tp2_adamw_matches_jax(group, cases, tiny_cfg):
    tree, x, y = cases["tp_adamw"]
    want, want_loss = _jax_kernel_tp(tiny_cfg, tree, x, y,
                                     optax.adamw(LR, weight_decay=W.WD), {"dp": 1, "tp": 2})
    assert abs(float(group[0]["tp_adamw/loss"]) - want_loss) <= 1e-5
    _leaf_close(_res_tree(group[0], "tp_adamw"), want, 1e-4, adam_cfg=tiny_cfg)


def test_tp_shards_gather_back(group):
    r0, r1, _ = group
    assert bool(r0["tp_roundtrip"]) and bool(r1["tp_roundtrip"])
    assert r0["tp_local_w1_shape"].tolist() == [2, 64, 128]  # (L, D, F/tp)


# -- the data-parallel steps ------------------------------------------------------


@pytest.mark.parametrize("name,opt,kw", [
    ("dp_accum", "sgd", dict(grad_accum=2)),
    ("dp_smooth", "sgd", dict(label_smoothing=0.1)),
    ("dp_adamw", "adamw", {}),
    ("dp_fused_adamw", "fused_adamw", {}),
])
def test_dp2_fused_train_step_matches_jax(group, cases, tiny_cfg, name, opt, kw):
    tree, x, y = cases[name]
    optimizer = {"sgd": optax.sgd(W.SGD_LR), "adamw": optax.adamw(LR, weight_decay=W.WD),
                 "fused_adamw": None}[opt]
    if opt == "fused_adamw":
        kw = dict(fused_adamw={"lr": LR, "weight_decay": W.WD})
    want, want_loss = _jax_dp(tiny_cfg, tree, x, y, optimizer, **kw)
    assert abs(float(group[0][f"{name}/loss"]) - want_loss) <= 1e-5
    _leaf_close(_res_tree(group[0], name), want, 1e-4,
                adam_cfg=tiny_cfg if opt != "sgd" else None)


def test_dp2_eager_step_matches_jax_for_mesh(group, cases, tiny_cfg):
    tree, x, y = cases["dp_eager"]
    want, want_loss = _jax_dp(tiny_cfg, tree, x, y, optax.sgd(W.SGD_LR), ops="xla")
    assert abs(float(group[0]["dp_eager/loss"]) - want_loss) <= 1e-5
    _leaf_close(_res_tree(group[0], "dp_eager"), want, 1e-4)


def test_dp2_tome_step_matches_jax(group, cases):
    from test_torch_tome import assert_margins
    from vit_tpu_torch.eval import tome_stages
    from vit_tpu_torch.models import tome as ttome

    cfg = cases["tome_cfg"]
    tree, x, y = cases["dp_tome"]
    # the matching holds a margin on every image (it is per image, so per rank)
    with torch.no_grad():
        _, metrics = tome_stages.kernel_metrics(ttome.forward_train,
                                                params_from_numpy(tree, "cpu"),
                                                torch.from_numpy(x), cfg, 4)
    assert_margins(metrics, ttome.schedule(cfg, 4, ttome.TRAIN_MERGE_CHUNK))
    want, want_loss = _jax_dp(cfg, tree, x, y, optax.sgd(W.SGD_LR),
                              forward_fn=lambda p, im: jtome.forward_train(p, im, cfg, 4))
    got_loss = float(group[0]["dp_tome/loss"])
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    got, start = _res_tree(group[0], "dp_tome"), _flat(tree, "")
    for k in want:  # each update within 1e-4 of its leaf's gradient scale
        g_want = (start[k] - want[k]) / W.SGD_LR
        g_got = (start[k] - got[k]) / W.SGD_LR
        assert np.abs(g_got - g_want).max() <= 1e-4 * max(1.0, np.abs(g_want).max()), k


def test_dp2_distillation_matches_jax(group, cases):
    tree, x, y = cases["dp_distill"]
    teacher = jax.tree.map(jnp.asarray, cases["teacher"])
    want, want_loss = _jax_dp(W.DEIT, tree, x, y, optax.sgd(W.SGD_LR), distill=dict(
        teacher_fwd=lambda im: jvit.forward(teacher, im, W.TEACHER, jget_ops("fused")),
        alpha=0.5, hard=True, tau=1.0))
    assert abs(float(group[0]["dp_distill/loss"]) - want_loss) <= 1e-5
    _leaf_close(_res_tree(group[0], "dp_distill"), want, 2e-4)


def test_mae_dp2_matches_the_single_rank_step(group):
    # the same masks (masks_from_noise of one noise tensor, each rank its
    # rows): the dp mean of the two halves' losses and gradients is the
    # single step's (equal halves)
    r0 = group[0]
    assert abs(float(r0["mae_dp/loss"]) - float(r0["mae_single/loss"])) <= 1e-6
    _leaf_close(_res_tree(r0, "mae_dp"), _res_tree(r0, "mae_single"), 1e-5)


def test_mae_dp_folds_the_mask_seed(monkeypatch):
    # each dp rank draws its own masks from the step's seed (step 0's: the
    # run's seed folded with 0) folded with its index
    gens = []
    monkeypatch.setattr(tmae, "forward_loss", lambda p, x, gen, *a: gens.append(gen) or
                        (x.sum() * 0).requires_grad_())
    for i in (0, 1):
        mesh = Mesh({"dp": 2, "tp": 1}, i, {})
        step = ttrainer.make_mae_train_step(None, None, torch.optim.SGD([torch.zeros(1)], 0.1),
                                            torch.Generator().manual_seed(0xA46), mesh=mesh)
        step({}, torch.zeros(1))
    seeds = [g.initial_seed() for g in gens]
    assert seeds[0] != seeds[1] and 0xA46 not in seeds
    step0 = ttrainer.fold_in(0xA46, 0)
    assert seeds == [ttrainer.fold_in(step0, 0), ttrainer.fold_in(step0, 1)]


def test_dropout_masks_differ_between_dp_ranks(group):
    r0, r1, _ = group
    s0, s1 = r0["dp_dropout_seed"], r1["dp_dropout_seed"]
    assert len(s0) == len(s1) == 1 and s0[0] != s1[0]
    assert np.isfinite(float(r0["dp_dropout/loss"]))


# -- the train CLI over the group ---------------------------------------------------


@pytest.fixture(scope="module")
def jax_cli(launched, tiny_cfg, tmp_path_factory):
    """The JAX CLI's per-step losses and saved params at the worker's flags,
    on dp 1 x tp 2, dp 2 and dp 2 x tp 2."""
    import vit_tpu.config as jconfig
    from vit_tpu.cli.train import main as jmain

    d, _ = launched
    out = tmp_path_factory.mktemp("jax_cli")
    jconfig.CONFIGS[tiny_cfg.name] = tiny_cfg
    res = {}
    try:
        for name, flags in (("tp", ["--dp", "1", "--tp", "2"]), ("dp", ["--dp", "2"]),
                            ("dp_tp", ["--dp", "2", "--tp", "2"])):
            rc = jmain(["--config", tiny_cfg.name, "--init-weights", str(d / "init.npz"),
                        "--steps", "3", "--batch", "4", "--ops", "fused_train",
                        "--no-compile-cache", *flags, "--log-jsonl", str(out / f"{name}.jsonl"),
                        "--save", str(out / f"{name}.npz")])
            assert rc == 0
            res[name] = (_losses(out / f"{name}.jsonl"), out / f"{name}.npz")
    finally:
        jconfig.CONFIGS.pop(tiny_cfg.name, None)
    return res


def _losses(path):
    return [json.loads(line)["loss"] for line in Path(path).read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_tp_cli(launched, cases, tiny_cfg, tmp_path_factory):
    """The JAX CLI's per-step losses and saved params at the worker's plain
    tier --tp 2 flags (``--ops xla``/``qat``; MAE's masks from the worker's
    noise, as the worker patches its own)."""
    import vit_tpu.config as jconfig
    from vit_tpu.cli.train import main as jmain

    d, _ = launched
    out = tmp_path_factory.mktemp("jax_tp_cli")
    noise = jnp.asarray(cases["noise"])

    def masks(rng, batch, num_patches, len_keep):
        shuffle = jnp.argsort(noise, axis=-1).astype(jnp.int32)
        restore = jnp.argsort(shuffle, axis=-1).astype(jnp.int32)
        return shuffle[:, :len_keep], restore, (restore >= len_keep).astype(jnp.float32)

    runs = {
        "eager": ["--config", tiny_cfg.name, "--init-weights", str(d / "init.npz"),
                  "--ops", "xla"],
        "qat": ["--config", tiny_cfg.name, "--init-weights", str(d / "init.npz"), "--ops", "qat"],
        "mae": ["--config", tiny_cfg.name, "--ops", "xla", "--mae", "--mask-ratio", "0.5",
                "--mae-decoder", "32,2,2", "--resume", str(d / "mae_state.npz")],
        "distill": ["--config", W.DEIT.name, "--init-weights", str(d / "deit.npz"),
                    "--ops", "xla", "--distill-teacher", str(d / "teacher.npz")],
    }
    jconfig.CONFIGS[tiny_cfg.name] = tiny_cfg
    jconfig.CONFIGS[W.DEIT.name] = W.DEIT
    keep = jmae.random_mask
    jmae.random_mask = masks
    res = {}
    try:
        for name, flags in runs.items():
            rc = jmain([*flags, "--steps", "3", "--batch", "4", "--dp", "1", "--tp", "2",
                        "--no-compile-cache", "--log-jsonl", str(out / f"{name}.jsonl"),
                        "--save", str(out / f"{name}.npz")])
            assert rc == 0
            res[name] = (_losses(out / f"{name}.jsonl"), out / f"{name}.npz")
    finally:
        jmae.random_mask = keep
        jconfig.CONFIGS.pop(tiny_cfg.name, None)
        jconfig.CONFIGS.pop(W.DEIT.name, None)
    return res


def _saved_close(port_npz, jax_npz, cfg):
    tp = _flat(jckpt.load_npz(str(port_npz)), "")
    jp = _flat(jckpt.load_npz(str(jax_npz)), "")
    _leaf_close(tp, jp, 1e-4, adam_cfg=cfg, steps=3)


@pytest.mark.parametrize("name,jname", [("cli_tp", "tp"), ("cli_dp", "dp")])
def test_train_cli_over_the_group_matches_jax_cli(group, jax_cli, tiny_cfg, name, jname):
    r0, r1, d = group
    assert int(r0[f"{name}/rc"]) == int(r1[f"{name}/rc"]) == 0
    out = str(r0[f"{name}/stdout"])
    assert "ops: fused_train" in out and "step    2" in out and "mesh:" in out
    got, (want, jnpz) = _losses(d / "out" / f"{name}.jsonl"), jax_cli[jname]
    assert len(got) == len(want) == 3 and np.isfinite(got).all()  # rank 0 alone logs
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _saved_close(d / "out" / f"{name}.npz", jnpz, tiny_cfg)


@pytest.mark.parametrize("name", ["cli_tp", "cli_dp"])
def test_train_cli_rank0_alone_prints_and_saves_whole_params(group, tiny_cfg, name):
    r0, r1, d = group
    assert int(r1[f"{name}/stdout_lines"]) == 0 and int(r0[f"{name}/stdout_lines"]) > 3
    assert f"{name}/stdout" not in r1
    saved = d / "out" / f"{name}.npz"
    # whole (not a shard) and loadable in both packages
    for load in (jload_any, tload_any):
        tree = load(str(saved), tiny_cfg)
        assert np.asarray(tree["blocks"]["w1"]).shape == (2, 64, 256)
        assert np.asarray(tree["blocks"]["wqkv"]).shape == (2, 64, 192)


def test_train_cli_four_ranks_dp2_tp2_matches_jax_cli(launched, jax_cli, tiny_cfg):
    # the JAX CLI test's mesh (tests/test_cli.py: --dp 2 --tp 2), started
    # with the group (``launched``)
    d, _ = launched
    rc, stdout, stderr = _finished(launched, "four", 240)
    assert rc == 0, stderr[-4000:]
    assert "mesh: {'dp': 2, 'tp': 2} over 4 rank(s), backend gloo" in stdout
    assert stdout.count("step    2") == 1  # rank 0 alone prints
    got, (want, jnpz) = _losses(d / "four" / "l.jsonl"), jax_cli["dp_tp"]
    assert len(got) == 3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _saved_close(d / "four" / "p.npz", jnpz, tiny_cfg)


# -- the refusals, in the JAX package's words -----------------------------------------


@pytest.fixture
def fake_mesh(monkeypatch, tiny_cfg):
    """The CLI's mesh without a process group: the refusals come before any
    collective."""
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(tconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    monkeypatch.setitem(tconfig.CONFIGS, W.DEIT.name, W.DEIT)
    monkeypatch.setattr(common, "resolve_mesh", lambda dp, tp, device, backend=None, **_: (
        Mesh({"dp": dp or 1, "tp": tp}, 0, {}), device))
    # the exit code's all-reduce over the ranks: one rank here
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, op=None, group=None: None)


BASE = ["--config", "vit_tiny_test", "--steps", "1", "--batch", "4", "--device", "cpu"]


@pytest.mark.parametrize("flags,message", [
    (["--dp", "2", "--batch", "5"], "error: --batch 5 must be divisible by dp=2"),
    (["--tp", "3", "--ops", "fused_train"], "error: tp=3 must divide num_heads=4"),
    (["--tp", "2", "--ops", "fused_train", "--dropout", "0.1"],
     "error: --dropout/--drop-path require --ops eager, qat, or fused_train on a dp or dp x pp "
     "mesh (no --tp/--sp)"),
    (["--tp", "2", "--ops", "fused_train", "--drop-path", "0.1"],
     "error: --dropout/--drop-path require --ops eager, qat, or fused_train on a dp or dp x pp "
     "mesh (no --tp/--sp)"),
    (["--tp", "2", "--ops", "fused_train", "--tome", "2"],
     "error: --tome training requires --ops fused_train or eager on a dp mesh"),
    (["--tp", "2", "--ops", "fused_train", "--mae"],
     "error: --mae with --tp>1 requires --ops eager (the MAE kernel path is dp-only)"),
    (["--tp", "2", "--ops", "fused_train", "--grad-accum", "2"],
     "error: --augment/--grad-accum support the dp paths only (no --pp/--tp/--sp)"),
    (["--tp", "2", "--ops", "fused_train", "--optimizer", "fused_adamw"],
     "error: --optimizer fused_adamw requires --ops fused_train and tp=1"),
    # ZeRO's, at the JAX package's train_setup.py:233-251
    (["--dp", "2", "--pp", "2", "--ops", "fused_train", "--zero1"],
     "error: --zero1 composes with dp/tp eager/qat and fused_train placements only; --pp/--sp "
     "own their optimizer placement"),
    (["--dp", "2", "--sp", "2", "--zero1"],
     "error: --zero1 composes with dp/tp eager/qat and fused_train placements only; --pp/--sp "
     "own their optimizer placement"),
    (["--dp", "2", "--ops", "fused_train", "--fsdp"],
     "error: --fsdp needs the plain op paths (--ops eager/qat) and excludes --pp/--sp (the "
     "kernel paths and the pp/sp schedules require whole local weights per device)"),
    (["--dp", "2", "--pp", "2", "--ops", "eager", "--fsdp"],
     "error: --fsdp needs the plain op paths (--ops eager/qat) and excludes --pp/--sp"),
    (["--dp", "2", "--ops", "fused_train", "--optimizer", "fused_adamw", "--zero1"],
     "error: --zero1 with --optimizer fused_adamw would all-gather the sharded moments around "
     "the (unpartitionable) fused AdamW kernel every step, defeating the sharding; use "
     "--optimizer adamw with --zero1"),
])
def test_refusals_in_jax_words(fake_mesh, capsys, flags, message):
    assert tmain([*BASE, *flags]) == 2
    assert message in capsys.readouterr().err


def test_distill_teacher_with_tp_on_fused_train_refused(fake_mesh, capsys, tmp_path):
    jckpt.save_npz(_jtree(jvit.init_params(jax.random.key(1), W.TEACHER)), tmp_path / "t.npz")
    rc = tmain(["--config", W.DEIT.name, "--steps", "1", "--batch", "4", "--device", "cpu",
                "--tp", "2", "--ops", "fused_train", "--distill-teacher", str(tmp_path / "t.npz")])
    assert rc == 2
    assert ("error: --distill-teacher with --tp > 1 requires --ops eager or qat (the kernel-TP "
            "train step has no teacher leg); fused_train distillation runs on a dp mesh"
            in capsys.readouterr().err)


@pytest.mark.parametrize("name", ["eager", "qat", "mae", "distill"])
def test_gspmd_tensor_parallelism_is_a_later_slice(group, jax_tp_cli, tiny_cfg, name):
    # once refused: the train CLI's --tp 2 on the plain tiers, which the JAX
    # package runs through GSPMD, now runs tensor-parallel in plain torch
    # (tp_forward.plain_tp_ops); its losses and saved params against the
    # JAX CLI's at the same flags (--ops xla/qat)
    r0, r1, d = group
    key = f"cli_tp_{name}"
    assert int(r0[f"{key}/rc"]) == int(r1[f"{key}/rc"]) == 0
    assert "mesh: {'dp': 1, 'tp': 2} over 2 rank(s), backend gloo" in str(r0[f"{key}/stdout"])
    assert f"ops: {'qat' if name == 'qat' else 'eager'}" in str(r0[f"{key}/stdout"])
    got, (want, jnpz) = _losses(d / "out" / f"{key}.jsonl"), jax_tp_cli[name]
    assert len(got) == len(want) == 3
    cfg = W.DEIT if name == "distill" else tiny_cfg
    tp = _flat(jckpt.load_npz(str(d / "out" / f"{key}.npz")), "")
    jp = _flat(jckpt.load_npz(str(jnpz)), "")
    if name == "qat":
        # fake-int8 codes flip between the packages (test_torch_qat.py), and
        # a flip moves the loss past 1e-5: measured 4.5e-5, 1.2e-3 and
        # 6.8e-4 relative.  Step 0 (no update yet) within 1e-4, as
        # test_torch_qat.py holds the one-rank CLI's; the later steps within
        # the flip budget 2^-6 relative
        assert abs(got[0] - want[0]) <= 1e-4
        np.testing.assert_allclose(got, want, rtol=2.0 ** -6, atol=0)
    else:
        # every loss within 1e-5 relative, plus the 1e-6 that --log-jsonl's
        # 6 decimals round off (the worst reading, distillation's step 2, is
        # 0.91 of this bound)
        assert all(abs(g - w) <= 1e-5 * abs(w) + 1e-6 for g, w in zip(got, want)), (got, want)
    if name in ("mae", "qat"):
        # a few weights see a gradient that is rounding noise around zero
        # (on qat also a flipped code's), which AdamW scales up to about lr
        # a step: every element within 3 steps x the CLI's lr 1e-3, and the
        # key biases' columns (encoder and decoder, head width 16) aside,
        # all but a share of each leaf within 1e-4 (MAE 1e-3; qat 1e-2,
        # measured at most 2.8e-3)
        share = 1e-3 if name == "mae" else 1e-2
        for k in jp:
            diff = np.abs(tp[k] - jp[k])
            if k.endswith("bqkv"):
                diff = diff[..., (np.arange(diff.shape[-1]) // 16) % 3 != 1]
            assert (diff > 1e-4).mean() <= share and np.abs(tp[k] - jp[k]).max() <= 3e-3, k
        return
    _leaf_close(tp, jp, 1e-4, adam_cfg=cfg, steps=3)


def test_tp_and_dp_need_a_torchrun_world(monkeypatch, tiny_cfg, capsys):
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(tconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmain([*BASE, "--tp", "2"]) == 2
    assert "torchrun" in capsys.readouterr().err


def test_train_module_refuses_tp_without_torchrun():
    # `python -m vit_tpu_torch.cli.train`, the entry torchrun runs
    env = dict(os.environ, PYTHONPATH=str(REPO))
    for key in ("WORLD_SIZE", "MASTER_ADDR"):
        env.pop(key, None)
    out = subprocess.run([sys.executable, "-m", "vit_tpu_torch.cli.train", "--config", "vit_b_16",
                          "--steps", "1", "--device", "cpu", "--tp", "2"],
                         env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 2 and "torchrun" in out.stderr


def test_train_parser_takes_the_mesh_flags():
    from vit_tpu.cli.train_args import build_parser as jbuild

    args = build_parser().parse_args([])
    jargs = jbuild().parse_args([])
    assert (args.tp, args.dp) == (jargs.tp, jargs.dp) == (1, None)
    assert args.dist_backend is None
    assert build_parser().parse_args(["--dist-backend", "gloo"]).dist_backend == "gloo"
    with pytest.raises(SystemExit):
        build_parser().parse_args(["--dist-backend", "mpi"])


def test_fold_in_is_deterministic_and_distinct():
    assert ttrainer.fold_in(5, 0) == ttrainer.fold_in(5, 0)
    assert len({ttrainer.fold_in(5, i) for i in range(8)}) == 8
    assert ttrainer.fold_in(5, 1) != ttrainer.fold_in(6, 1)
