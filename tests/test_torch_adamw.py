"""The fused AdamW step against the JAX package on the CPU: K20's plain twin
against ``adamw_kernel.adamw_update`` in interpret mode and against
``torch.optim.AdamW``, ``make_train_step_fused_adamw`` against the JAX one
(a float lr, and a warmup-cosine schedule evaluated at the 1-based step),
and the train CLI's ``--optimizer fused_adamw`` with its refusals.

Inputs are made from numpy seeds and cross as numpy arrays.

Tolerances:
  - the update on fixed gradients: 1e-6 absolute and relative (the JAX
    package's own bar against optax, tests/test_adamw_kernel.py): fp32
    arithmetic, with the bias corrections' fp32 powers computed by numpy
    and by XLA;
  - train steps: loss 1e-5 and params 1e-4 (tests/test_torch_train.py),
    except the key bias, whose gradient is rounding noise around an exact
    zero that Adam scales up to about lr per step in both packages (see
    ``test_train_cli_matches_jax_cli`` there): its columns are held to
    steps x lr.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_tpu.io import checkpoint as ckpt
from vit_tpu.models import vit as jvit
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu.ops.pallas.adamw_kernel import adamw_update as j_adamw_update
from vit_tpu.runtime import trainer as jtrainer
from vit_tpu_torch.cli import train_setup
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.ops.kernels import adamw as KW
from vit_tpu_torch.runtime import trainer as ttrainer

# the JAX test's leaves: one its kernel takes, one under 2^15 elements, one
# not a multiple of 128 (both of the latter go to jnp there)
LEAVES = {"big": (64, 512), "mid": (768,), "odd": (1000,)}


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _tree(seed):
    return {k: _np(seed + i, *shape) for i, (k, shape) in enumerate(LEAVES.items())}


def _assert_tree_close(got, want, tol=1e-6):
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], np.float32), np.asarray(want[k], np.float32),
                                   atol=tol, rtol=tol, err_msg=k)


@pytest.mark.parametrize("wd", [0.0, 0.05])
def test_twin_matches_pallas_adamw(wd):
    params, lr = _tree(0), 1e-3
    zeros = {k: np.zeros_like(v) for k, v in params.items()}
    jp, jm, jv = (jax.tree.map(jnp.asarray, t) for t in (params, zeros, zeros))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    tm, tv = ({k: torch.zeros_like(v) for k, v in tp.items()} for _ in range(2))
    wp, wm, wv = ({k: t.clone() for k, t in d.items()} for d in (tp, tm, tv))
    for step in range(1, 4):  # bias correction moves with the step
        g = _tree(100 * step)
        jp, jm, jv = j_adamw_update(jax.tree.map(jnp.asarray, g), jp, jm, jv, jnp.int32(step), lr,
                                    weight_decay=wd, interpret=True)
        tg = {k: torch.from_numpy(v) for k, v in g.items()}
        KW.adamw_update_plain(tg, tp, tm, tv, step, lr, weight_decay=wd)
        # the wrapper on CPU leaves is the twin, bit for bit, with no launch
        before = KW.adamw_update.launches
        KW.adamw_update(tg, wp, wm, wv, step, lr, weight_decay=wd)
        assert KW.adamw_update.launches == before
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        _assert_tree_close({k: t.numpy() for k, t in got.items()}, want)
    for a, b in ((tp, wp), (tm, wm), (tv, wv)):
        assert all(torch.equal(a[k], b[k]) for k in a)


def test_twin_matches_torch_adamw():
    params, lr, wd = _tree(1), 1e-3, 0.05
    tp = [torch.from_numpy(v.copy()) for v in params.values()]
    mu, nu = [torch.zeros_like(t) for t in tp], [torch.zeros_like(t) for t in tp]
    ref = [torch.from_numpy(v.copy()).requires_grad_(True) for v in params.values()]
    opt = torch.optim.AdamW(ref, lr=lr, weight_decay=wd)
    for step in range(1, 4):
        grads = [torch.from_numpy(_np(200 * step + i, *t.shape)) for i, t in enumerate(tp)]
        KW.adamw_update_plain(grads, tp, mu, nu, step, lr, weight_decay=wd)
        for t, g in zip(ref, grads):
            t.grad = g.clone()
        opt.step()
    for got, m, v, want in zip(tp, mu, nu, ref):
        st = opt.state[want]
        for a, b in ((got, want.detach()), (m, st["exp_avg"]), (v, st["exp_avg_sq"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-6)


def test_wrapper_refuses_other_devices():
    # a non-CPU leaf either launches the kernel or raises; never the twin
    m = torch.empty(8, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        KW.adamw_update([m], [m], [m], [m], 1, 1e-3)


def test_fused_adamw_optimizer_state():
    p = [torch.zeros(3, requires_grad=True), torch.ones(2, 2, requires_grad=True)]
    opt = ttrainer.FusedAdamW(p, lr=lambda count: 0.1 * count, weight_decay=0.0)
    p[0].grad = torch.ones(3)  # p[1] has no gradient: skipped, as torch skips it
    opt.step()
    opt.step()
    assert opt.count == 2 and set(opt.state) == {p[0]}
    assert opt.state[p[0]]["mu"].dtype == torch.float32
    # lr(1) then lr(2): Adam's first steps move by lr, up to the fp32 bias
    # corrections (1 - 0.9 rounds to 0.100000024 in fp32)
    np.testing.assert_allclose(p[0].detach().numpy(), -0.3, atol=1e-5)
    count, mu, nu = ttrainer.init_fused_adamw_state({"a": {"b": p[1]}})
    assert count == 0 and mu["a"]["b"].shape == (2, 2) and not nu["a"]["b"].any()


# -- the train step against the JAX package's make_train_step_fused_adamw ----


@pytest.fixture(scope="module")
def jparams(tiny_cfg):
    return jax.tree.map(lambda a: np.array(a, np.float32),
                        jvit.init_params(jax.random.key(3), tiny_cfg))


@pytest.fixture(scope="module")
def batch(tiny_cfg):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 3, tiny_cfg.image_size, tiny_cfg.image_size)).astype(np.float32)
    return x, rng.integers(0, tiny_cfg.num_classes, 4).astype(np.int32)


def _key_columns(cfg):
    dh = cfg.embed_dim // cfg.num_heads
    return (np.arange(3 * cfg.embed_dim) // dh) % 3 == 1


def _params_close(cfg, got, want, steps, lr):
    got, want = dict(got), dict(want)
    gb, wb = dict(got.pop("blocks")), dict(want.pop("blocks"))
    tb, jb = gb.pop("bqkv"), wb.pop("bqkv")
    k = _key_columns(cfg)
    for g, w in ((got, want), (gb, wb)):
        for name in w:
            if isinstance(w[name], dict):
                _assert_tree_close(g[name], w[name], 1e-4)
            else:
                np.testing.assert_allclose(g[name], w[name], atol=1e-4, rtol=0, err_msg=name)
    np.testing.assert_allclose(tb[:, ~k], jb[:, ~k], atol=1e-4, rtol=0)
    assert np.abs(tb[:, k]).max() <= steps * lr + 1e-6
    assert np.abs(jb[:, k]).max() <= steps * lr + 1e-6


@pytest.mark.parametrize("schedule", [False, True], ids=["float_lr", "warmup_cosine"])
def test_fused_adamw_step_matches_jax(tiny_cfg, jparams, batch, schedule):
    lr, steps, horizon = 1e-3, 2, 10
    jlr = optax.warmup_cosine_decay_schedule(0.0, lr, 1, horizon) if schedule else lr
    tlr = train_setup.warmup_cosine(lr, horizon) if schedule else lr
    jstep = jax.jit(jtrainer.make_train_step_fused_adamw(tiny_cfg, jlr, jget_ops("xla"),
                                                         weight_decay=0.05))
    tstep = ttrainer.make_train_step_fused_adamw(tiny_cfg, tlr, get_ops("eager"),
                                                 weight_decay=0.05)
    jp = jax.tree.map(jnp.asarray, jparams)
    jstate = jtrainer.init_fused_adamw_state(jp)
    tp = ttrainer.as_trainable(params_from_numpy(jparams, "cpu"), "cpu")
    tstate = ttrainer.init_fused_adamw_state(tp)
    x, y = batch
    for _ in range(steps):
        jp, jstate, jloss = jstep(jp, jstate, jnp.asarray(x), jnp.asarray(y))
        tp, tstate, tloss = tstep(tp, tstate, torch.from_numpy(x), torch.from_numpy(y))
        assert abs(float(tloss) - float(jloss)) <= 1e-5
    assert tstate[0] == int(jstate[0]) == steps
    got = params_to_numpy(tp)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jp)
    _params_close(tiny_cfg, got, want, steps, lr)
    # the schedule runs at count + 1: the first update is lr(1) = lr, not
    # lr(0) = 0, so every weight matrix moved
    assert np.abs(got["blocks"]["w1"] - jparams["blocks"]["w1"]).max() > 0.5 * lr


# -- the train CLI ---------------------------------------------------------------


@pytest.fixture
def tiny_registered(tiny_cfg, monkeypatch):
    import vit_tpu.config as config_mod
    import vit_tpu_torch.config as tconfig_mod

    monkeypatch.setitem(config_mod.CONFIGS, "vit_tiny_test", tiny_cfg)
    monkeypatch.setitem(tconfig_mod.CONFIGS, "vit_tiny_test", tiny_cfg)
    return tiny_cfg


def _losses(path):
    return [json.loads(line)["loss"] for line in path.read_text().splitlines()]


def test_train_cli_fused_adamw_matches_jax_cli(tiny_registered, jparams, tmp_path, capsys):
    from vit_tpu.cli.train import main as jmain
    from vit_tpu_torch.cli.train import main as tmain

    init = tmp_path / "p.npz"
    ckpt.save_npz(jparams, str(init))
    common = ["--config", "vit_tiny_test", "--init-weights", str(init), "--steps", "3",
              "--batch", "4", "--ops", "fused_train", "--optimizer", "fused_adamw",
              "--schedule", "warmup_cosine"]
    assert tmain([*common, "--device", "cpu", "--log-jsonl", str(tmp_path / "t.jsonl"),
                  "--save", str(tmp_path / "t.npz")]) == 0
    assert "ops: fused_train" in capsys.readouterr().out
    assert jmain([*common, "--dp", "1", "--no-compile-cache", "--log-jsonl",
                  str(tmp_path / "j.jsonl"), "--save", str(tmp_path / "j.npz")]) == 0
    got, want = _losses(tmp_path / "t.jsonl"), _losses(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _params_close(tiny_registered, ckpt.load_npz(str(tmp_path / "t.npz")),
                  ckpt.load_npz(str(tmp_path / "j.npz")), 3, 1e-3)


@pytest.mark.parametrize("extra,msg", [
    (["--wd-exempt-norm-bias"], "error: --wd-exempt-norm-bias requires --optimizer adamw"),
    (["--grad-clip", "1.0"], "error: --grad-clip requires --optimizer adamw"),
    (["--ops", "eager"], "error: --optimizer fused_adamw requires --ops fused_train and tp=1"),
], ids=["wd_exempt", "grad_clip", "eager"])
def test_train_cli_fused_adamw_refusals(tiny_registered, capsys, extra, msg):
    from vit_tpu_torch.cli.train import main

    argv = ["--config", "vit_tiny_test", "--steps", "1", "--batch", "4", "--device", "cpu",
            "--ops", "fused_train", "--optimizer", "fused_adamw", *extra]
    assert main(argv) == 2
    assert msg in capsys.readouterr().err


@pytest.mark.parametrize("extra", [["--grad-accum", "2"], ["--dropout", "0.1", "--drop-path", "0.1"],
                                   ["--tome", "1"]], ids=["grad_accum", "regularized", "tome"])
def test_train_cli_fused_adamw_composes(tiny_registered, tmp_path, extra):
    """As the JAX dp step, the fused AdamW takes the step's gradients
    whatever made them: microbatches, in-kernel regularizers, merging."""
    from vit_tpu_torch.cli.train import main

    log = tmp_path / "t.jsonl"
    assert main(["--config", "vit_tiny_test", "--steps", "2", "--batch", "4", "--device", "cpu",
                 "--ops", "fused_train", "--optimizer", "fused_adamw", "--log-jsonl", str(log),
                 *extra]) == 0
    assert np.isfinite(_losses(log)).all() and len(_losses(log)) == 2
