"""The training loop's state and recipe in the port against the JAX package
on the CPU, at ``tiny_cfg``: the train-state archive (``--save-state``,
``--resume``), the EMA, ``--freeze-backbone``, ``--skip-nonfinite``,
``--save-reference``, SIGTERM checkpointing and the refusals.

- The archive's keys, shapes and dtypes are those of the JAX package's
  ``save_train_state(optimizer.init(params))`` for every optimizer stack of
  its ``_build_optimizer`` (and ``init_fused_adamw_state``).
- Cross resume: each package runs k + m steps with ``--save-every k``
  (every save kept), the other resumes its step-k archive for m steps, and
  the two step-(k + m) archives agree: moments and counters within 1e-5 of
  each leaf's scale (at least 1), and so the params, except the key bias,
  whose gradient is zero in exact arithmetic — Adam's normalised update
  turns each package's rounding noise there into steps of up to lr, so its
  columns are held to m · lr.
- Within the port, k + m straight steps equal k steps, a save, a resume and
  m steps bit for bit (dropout, augmentation, EMA, ``--data-dir``).
- ``--skip-nonfinite`` and ``--freeze-backbone`` with ``--grad-clip``
  against ``optax.apply_if_finite`` and ``multi_transform`` on one gradient
  sequence; ``--save-reference`` byte for byte the JAX writer's.
"""

import dataclasses
import os
import shutil
import signal
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vit_tpu.io import checkpoint as jckpt
from vit_tpu.io import weights as jwio
from vit_tpu.io.images import save_image_bin
from vit_tpu.models import vit as jvit
from vit_tpu_torch.cli.train_setup import _detached, _trained, adamw_param_groups
from vit_tpu_torch.io import checkpoint as tckpt
from vit_tpu_torch.io import weights as twio
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.runtime import trainer as ttrainer
from vit_tpu_torch.utils import flatten_tree as tflatten
from vit_tpu_torch.utils import unflatten_tree as tunflatten

from torch_spy_record import one_thread

REPO = Path(__file__).resolve().parents[1]
LR = 1e-3
K_STEPS, M_STEPS = 2, 2


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """torch at one thread: the suite's workers share the cores, and the
    tiny steps gain nothing from more."""
    with one_thread():
        yield


@pytest.fixture
def registered(tiny_cfg, monkeypatch):
    import vit_tpu.config as jconfig
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(jconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    monkeypatch.setitem(tconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    return tiny_cfg


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory, tiny_cfg):
    path = tmp_path_factory.mktemp("init") / "init.npz"
    jckpt.save_npz(_np_tree(jvit.init_params(jax.random.key(3), tiny_cfg)), str(path))
    return path


@pytest.fixture(scope="module")
def shards(tmp_path_factory, tiny_cfg):
    d = tmp_path_factory.mktemp("shards")
    rng = np.random.default_rng(0)
    for i, n in enumerate((7, 5, 9)):
        save_image_bin(rng.normal(size=(n, 3, 32, 32)).astype(np.float32), d / f"s{i}.bin")
        rng.integers(0, tiny_cfg.num_classes, n).astype("<i4").tofile(d / f"s{i}.labels.bin")
    return d


def _archive(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _keep_each_save(monkeypatch, module):
    """Every ``save_train_state`` of ``module`` also copied to ``PATH.<step>``."""
    orig = module.save_train_state

    def save(params, opt, step, path):
        orig(params, opt, step, path)
        shutil.copy(path, f"{path}.{step}")

    monkeypatch.setattr(module, "save_train_state", save)


def _tmain(flags):
    from vit_tpu_torch.cli.train import main

    return main([*flags, "--device", "cpu"])


def _jmain(flags):
    from vit_tpu.cli.train import main

    return main([*flags, "--dp", "1", "--no-compile-cache"])


def _key_bias_columns(cfg) -> np.ndarray:
    """bqkv's key columns in the packed (head, {q,k,v}, head_dim) order."""
    dh = cfg.embed_dim // cfg.num_heads
    return np.concatenate([np.arange(h * 3 * dh + dh, h * 3 * dh + 2 * dh)
                           for h in range(cfg.num_heads)])


def _assert_archives_close(got: dict, want: dict, cfg, steps: int, tol: float = 1e-5):
    """Two train-state archives (or two flat params trees) within ``tol`` of
    each leaf's scale, the key bias within ``steps`` x lr; counters equal."""
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if w.dtype.kind in "bi":
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        scale = max(1.0, float(np.abs(w).max()))
        if k.endswith("blocks/bqkv") and not k.startswith("opt."):
            cols = _key_bias_columns(cfg)
            np.testing.assert_allclose(g[:, cols], w[:, cols], atol=steps * LR, rtol=0)
            g, w = np.delete(g, cols, axis=1), np.delete(w, cols, axis=1)
        np.testing.assert_allclose(g, w, atol=tol * scale, rtol=0, err_msg=k)


# -- the archive's layout ----------------------------------------------------------

STACKS = {  # name: (train CLI flags, the JAX optimizer's options)
    "adamw": ([], {}),
    "warmup_cosine": (["--schedule", "warmup_cosine"], {"schedule": True}),
    "wd_exempt": (["--wd-exempt-norm-bias"], {"wd_exempt_norm_bias": True}),
    "grad_clip": (["--grad-clip", "0.5"], {"grad_clip": 0.5}),
    "freeze_clip": (["--freeze-backbone", "--grad-clip", "0.05"],
                    {"freeze_backbone": True, "grad_clip": 0.05}),
    "skip_nonfinite": (["--skip-nonfinite", "--schedule", "warmup_cosine"],
                       {"skip_nonfinite": True, "schedule": True}),
    "skip_freeze": (["--skip-nonfinite", "--freeze-backbone"],
                    {"skip_nonfinite": True, "freeze_backbone": True}),
    "fused_adamw": (["--ops", "fused_train", "--optimizer", "fused_adamw"], {"fused": True}),
}


def _jax_optimizer(schedule=False, fused=False, **kw):
    from vit_tpu.cli.train_setup import _build_optimizer

    args = SimpleNamespace(**{"wd_exempt_norm_bias": False, "optimizer": "adamw",
                              "weight_decay": 0.05, "grad_clip": 0.0, "freeze_backbone": False,
                              "skip_nonfinite": False, **kw})
    lr = optax.warmup_cosine_decay_schedule(0.0, LR, 1, 4) if schedule else LR
    return _build_optimizer(args, lr)


@pytest.mark.parametrize("stack", list(STACKS))
def test_archive_layout_is_jaxs(registered, init_npz, tmp_path, stack, capsys):
    flags, jopts = STACKS[stack]
    path = tmp_path / "ckpt"  # no suffix: written to exactly this name
    assert _tmain(["--config", registered.name, "--init-weights", str(init_npz), "--steps", "2",
                   "--batch", "4", "--lr", str(LR), "--save-state", str(path), *flags]) == 0
    assert f"saved training state (step 2) to {path}\n" in capsys.readouterr().out
    params = jax.tree.map(jnp.asarray, jckpt.load_npz(str(init_npz)))
    if jopts.get("fused"):
        from vit_tpu.runtime.trainer import init_fused_adamw_state

        state = init_fused_adamw_state(params)
    else:
        state = _jax_optimizer(**jopts).init(params)
    jckpt.save_train_state(_np_tree(params), jax.device_get(state), 0, str(tmp_path / "j.npz"))
    got, want = _archive(path), _archive(tmp_path / "j.npz")
    assert sorted(got) == sorted(want)
    for k in want:
        assert (got[k].shape, got[k].dtype) == (want[k].shape, want[k].dtype), k
    assert got["__step__"].dtype == np.int64 and int(got["__step__"]) == 2
    assert tckpt.peek_step(path) == 2 and jckpt.peek_step(str(path)) == 2


# -- cross resume ------------------------------------------------------------------

CROSS = {
    "adamw": [],
    "cosine_wd_clip": ["--schedule", "warmup_cosine", "--wd-exempt-norm-bias", "--grad-clip",
                       "0.5"],
    "freeze_clip": ["--freeze-backbone", "--grad-clip", "0.05"],
    "skip_nonfinite": ["--skip-nonfinite", "--schedule", "warmup_cosine"],
    "fused_adamw": ["--ops", "fused_train", "--optimizer", "fused_adamw"],
}


@pytest.mark.parametrize("stack", list(CROSS))
def test_either_package_resumes_the_others_archive(registered, init_npz, tmp_path, monkeypatch,
                                                  stack):
    flags = ["--config", registered.name, "--batch", "4", "--lr", str(LR), "--seed", "5",
             *CROSS[stack]]
    if "--ops" not in flags:
        flags += ["--ops", "eager"]
    straight = ["--init-weights", str(init_npz), "--steps", str(K_STEPS + M_STEPS),
                "--save-every", str(K_STEPS)]
    resume = ["--steps", str(M_STEPS)]
    _keep_each_save(monkeypatch, jckpt)
    _keep_each_save(monkeypatch, tckpt)
    jflags = [("xla" if f == "eager" else f) for f in flags]
    j, t = tmp_path / "j.npz", tmp_path / "t.npz"
    assert _jmain([*jflags, *straight, "--save-state", str(j)]) == 0
    assert _tmain([*flags, *straight, "--save-state", str(t)]) == 0
    # the port resumes JAX's step-k archive, JAX the port's
    assert _tmain([*flags, *resume, "--resume", f"{j}.{K_STEPS}",
                   "--save-state", str(tmp_path / "t_from_j.npz")]) == 0
    assert _jmain([*jflags, *resume, "--resume", f"{t}.{K_STEPS}",
                   "--save-state", str(tmp_path / "j_from_t.npz")]) == 0
    end = K_STEPS + M_STEPS
    _assert_archives_close(_archive(tmp_path / "t_from_j.npz"), _archive(f"{j}.{end}"),
                           registered, end)
    _assert_archives_close(_archive(tmp_path / "j_from_t.npz"), _archive(f"{t}.{end}"),
                           registered, end)
    # the step-k archives agree too: the two runs are the same run
    _assert_archives_close(_archive(f"{t}.{K_STEPS}"), _archive(f"{j}.{K_STEPS}"), registered,
                           K_STEPS)


# -- resumed equals straight, in the port -------------------------------------------


def _sigterm_in_step(monkeypatch, n: int) -> None:
    """The train CLI's step sends this process SIGTERM in step ``n``."""
    orig = ttrainer.make_train_step_dp

    def make(*a, **kw):
        inner = orig(*a, **kw)

        def step_fn(params, x, y, step=None):
            if step == n:
                os.kill(os.getpid(), signal.SIGTERM)
            return inner(params, x, y, step=step)

        return step_fn

    monkeypatch.setattr(ttrainer, "make_train_step_dp", make)


@pytest.mark.parametrize("ops", ["eager", "fused_train"])
def test_resumed_run_is_the_straight_run_bit_for_bit(registered, init_npz, shards, tmp_path,
                                                     monkeypatch, ops):
    flags = ["--config", registered.name, "--batch", "4", "--lr", str(LR), "--seed", "9",
             "--ops", ops, "--data-dir", str(shards), "--data-threads", "2", "--dropout", "0.1",
             "--drop-path", "0.1", "--augment", "crop,flip,mixup,cutmix", "--ema-decay", "0.9",
             "--label-smoothing", "0.1", "--schedule", "warmup_cosine"]
    straight, first = tmp_path / "straight.npz", tmp_path / "first.npz"
    resumed = tmp_path / "resumed.npz"
    assert _tmain([*flags, "--init-weights", str(init_npz), "--steps", "6", "--save-state",
                   str(straight)]) == 0
    # the same run preempted in its third step: SIGTERM, the state saved at
    # step 3, resumed for the 3 steps left
    with monkeypatch.context() as mp:
        _sigterm_in_step(mp, 2)
        assert _tmain([*flags, "--init-weights", str(init_npz), "--steps", "6", "--save-state",
                       str(first)]) == 0
    assert tckpt.peek_step(first) == 3
    assert _tmain([*flags, "--steps", "3", "--resume", str(first), "--save-state",
                   str(resumed)]) == 0
    got, want = _archive(resumed), _archive(straight)
    assert sorted(got) == sorted(want) and int(got["__step__"]) == 6
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    ga, gb = (tflatten(tckpt.load_npz(p.with_suffix(".ema.npz"))) for p in (resumed, straight))
    assert sorted(ga) == sorted(gb)
    for path, x in gb.items():
        np.testing.assert_array_equal(ga[path], x, err_msg=path)


# -- the update rules against optax ---------------------------------------------------


def _tree_and_port(cfg, seed=0):
    """(JAX params, the port's trainable params) of one init."""
    tree = _np_tree(jvit.init_params(jax.random.key(seed), cfg))
    return (jax.tree.map(jnp.asarray, tree),
            ttrainer.as_trainable(params_from_numpy(tree, "cpu"), "cpu", torch.float32))


def _grad_seq(tree, n, seed=1):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32), tree)
            for _ in range(n)]


def _port_optimizer(tparams, freeze, lr=LR):
    trained = _trained(tparams, freeze)
    return torch.optim.AdamW(adamw_param_groups(trained, 0.05, False), lr=lr), trained


def _set_grads(tparams, grads):
    flat = tflatten(grads)
    for path, t in tflatten(tparams).items():
        t.grad = torch.from_numpy(np.asarray(flat[path]).copy())


def _assert_params(tparams, jparams, tol=1e-6):
    want = tflatten(_np_tree(jparams))
    for path, g in tflatten(params_to_numpy(tparams)).items():
        np.testing.assert_allclose(g, want[path], atol=tol, rtol=0, equal_nan=True,
                                   err_msg=path)


@pytest.mark.parametrize("freeze", [False, True], ids=["all", "frozen_backbone"])
def test_skip_nonfinite_follows_apply_if_finite(tiny_cfg, freeze):
    """NaN steps at 1 and 3-11 (nine in a row: the ninth is applied), one
    infinity in a backbone leaf at 13: the counters, the params and the
    archive's leaves step for step."""
    jparams, tparams = _tree_and_port(tiny_cfg)
    grads = _grad_seq(jparams, 15)
    for i in (1, *range(3, 12)):
        grads[i]["blocks"]["w1"][0, 0, 0] = np.nan
    grads[13]["blocks"]["wo"][1, 2, 3] = np.inf  # frozen under freeze: skipped all the same
    jopt = _jax_optimizer(skip_nonfinite=True, freeze_backbone=freeze)
    jstate = jopt.init(jparams)
    jupdate = jax.jit(jopt.update)
    opt, trained = _port_optimizer(tparams, freeze)
    guard = ttrainer.NonFiniteGuard()
    seen = []
    for i, g in enumerate(grads):
        if i == 12:  # after the applied NaN step: restart from finite params
            jparams, tparams = _tree_and_port(tiny_cfg, seed=2)
            jstate = jopt.init(jparams)
            opt, trained = _port_optimizer(tparams, freeze)
            guard = ttrainer.NonFiniteGuard()
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _set_grads(tparams, g)
        ttrainer._update(tparams, opt, 0.0, None, guard)
        counters = (guard.notfinite_count, guard.last_finite, guard.total_notfinite)
        assert counters == (int(jstate.notfinite_count), bool(jstate.last_finite),
                            int(jstate.total_notfinite)), i
        seen.append(counters)
        _assert_params(tparams, jparams)
        want = jax.tree.leaves(jax.device_get(jstate))
        got = ttrainer.opt_state_leaves(opt, trained, guard=guard)
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, equal_nan=True)
    assert seen[11] == (9, False, 10)  # the ninth in a row: applied
    assert seen[13] == (1, False, 1)


def test_freeze_backbone_with_grad_clip_matches_jax(tiny_cfg):
    """The global norm covers the heads alone; the backbone takes no update
    and no decay, bit for bit."""
    jparams, tparams = _tree_and_port(tiny_cfg)
    start = {k: v.detach().clone() for k, v in tflatten(tparams).items()}
    jopt = _jax_optimizer(freeze_backbone=True, grad_clip=0.05)
    jstate = jopt.init(jparams)
    opt, trained = _port_optimizer(tparams, True)
    for g in _grad_seq(jparams, 3, seed=4):
        updates, jstate = jax.jit(jopt.update)(jax.tree.map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        _set_grads(tparams, g)
        ttrainer._update(tparams, opt, 0.05, None, trained=trained)
    for path, t in tflatten(tparams).items():
        if not path.startswith("head/"):
            assert torch.equal(t.detach(), start[path]), path
    _assert_params(tparams, jparams)
    got = ttrainer.opt_state_leaves(opt, trained)
    for a, b in zip(got, jax.tree.leaves(jax.device_get(jstate))):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_frozen_leaves_take_no_stale_gradient(tiny_cfg):
    params = ttrainer.as_trainable(tvit.init_params(torch.Generator().manual_seed(0), tiny_cfg),
                                   "cpu")
    opt = torch.optim.AdamW(list(ttrainer.leaves(_trained(params, True))), lr=LR)
    step = ttrainer.make_train_step(tiny_cfg, opt, remat=False)
    x = torch.from_numpy(np.random.default_rng(1).normal(size=(4, 3, 32, 32)).astype(np.float32))
    y = torch.tensor([1, 2, 3, 4])
    step(params, x, y)
    # the second step's backbone gradient is its own, not a sum with the first's
    ref = {k: v.detach().clone().requires_grad_(True) for k, v in tflatten(params).items()}
    step(params, x, y)
    ttrainer.cross_entropy_loss(tvit.forward(tunflatten(ref), x, tiny_cfg), y).backward()
    w = params["blocks"]["w1"]
    assert w.grad is not None
    torch.testing.assert_close(w.grad, ref["blocks/w1"].grad, rtol=0, atol=0)


def test_ema_matches_jax(tiny_cfg):
    from vit_tpu.runtime.trainer import make_ema_update

    jparams, tparams = _tree_and_port(tiny_cfg)
    jema = jax.tree.map(lambda a: a * 0.5, jparams)
    tema = jax.tree.map(lambda t: t * 0.5, _detached(tparams))
    jupd, tupd = make_ema_update(0.99), ttrainer.make_ema_update(0.99)
    for _ in range(3):
        jema = jupd(jema, jparams)
        tupd(tema, tparams)
    _assert_params(tema, jema, tol=1e-7)


# -- SIGTERM -------------------------------------------------------------------------


@pytest.mark.parametrize("save", [True, False], ids=["save_state", "no_save_state"])
def test_sigterm_in_the_second_step_checkpoints_and_exits(registered, init_npz, tmp_path,
                                                          monkeypatch, capsys, save):
    _sigterm_in_step(monkeypatch, 1)
    before = signal.getsignal(signal.SIGTERM)
    path = tmp_path / "ckpt.npz"
    held = tmp_path / "held"
    held.mkdir()
    rng = np.random.default_rng(3)
    save_image_bin(rng.normal(size=(8, 3, 32, 32)).astype(np.float32), held / "h.bin")
    rng.integers(0, 11, 8).astype("<i4").tofile(held / "h.labels.bin")
    rc = _tmain(["--config", registered.name, "--init-weights", str(init_npz), "--steps", "5",
                 "--batch", "4", "--ops", "eager", "--eval-data-dir", str(held), "--eval-every",
                 "4", *(["--save-state", str(path)] if save else [])])
    out = capsys.readouterr()
    assert rc == 0
    assert signal.getsignal(signal.SIGTERM) == before
    assert "step    2" not in out.out and "eval top-1" not in out.out  # no final eval
    if save:
        assert ("SIGTERM: checkpointing at step 2 and exiting (resume with --resume)"
                in out.err)
        assert tckpt.peek_step(path) == 2 and jckpt.peek_step(str(path)) == 2
    else:
        assert "SIGTERM: exiting at step 2 (no --save-state given; nothing checkpointed)" in out.err


# -- --save-reference ------------------------------------------------------------------


def test_save_reference_is_the_jax_writers(registered, init_npz, tmp_path, capsys):
    ref, saved = tmp_path / "ref", tmp_path / "final.npz"
    assert _tmain(["--config", registered.name, "--init-weights", str(init_npz), "--steps", "2",
                   "--batch", "4", "--ops", "eager", "--save", str(saved),
                   "--save-reference", str(ref)]) == 0
    assert f"exported reference-format weights to {ref}" in capsys.readouterr().out
    params = jckpt.load_npz(str(saved))
    jwio.save_reference_weights(jwio.tensors_from_params(params, registered),
                                tmp_path / "jref", registered)
    names = sorted(p.name for p in ref.iterdir())
    assert names == sorted(p.name for p in (tmp_path / "jref").iterdir())
    assert len(names) == 4 + 12 * registered.depth + 4
    for name in names:
        assert (ref / name).read_bytes() == (tmp_path / "jref" / name).read_bytes(), name
    back = jwio.load_reference_weights(ref, registered, round_to_6dp=False)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_tensors_from_params_refuses_deit_in_jaxs_words(tiny_cfg):
    deit = dataclasses.replace(tiny_cfg, distilled=True, name="deit_tiny")
    tree = _np_tree(jvit.init_params(jax.random.key(0), deit))
    with pytest.raises(ValueError) as want:
        jwio.tensors_from_params(tree, deit)
    with pytest.raises(ValueError) as got:
        twio.tensors_from_params(tree, deit)
    assert str(got.value) == str(want.value)


# -- refusals ---------------------------------------------------------------------------


def _refusal(main, flags, capsys):
    rc = main(flags)
    err = capsys.readouterr().err.strip().splitlines()
    return rc, err[-1] if err else ""


@pytest.mark.parametrize("extra", [
    ["--save-ema", "e.npz"],
    ["--optimizer", "fused_adamw", "--ops", "fused_train", "--freeze-backbone"],
    ["--optimizer", "fused_adamw", "--ops", "fused_train", "--skip-nonfinite"],
    ["--config", "deit_tiny_test", "--distill-teacher", "T", "--augment", "flip"],
], ids=["save_ema", "fused_freeze", "fused_skip", "distill_augment"])
def test_refusals_in_jax_words(registered, monkeypatch, tmp_path, capsys, extra):
    import vit_tpu.config as jconfig
    import vit_tpu_torch.config as tconfig

    deit = dataclasses.replace(registered, distilled=True, patch_size=8, name="deit_tiny_test")
    monkeypatch.setitem(jconfig.CONFIGS, deit.name, deit)
    monkeypatch.setitem(tconfig.CONFIGS, deit.name, deit)
    teacher = tmp_path / "t.npz"
    jckpt.save_npz(_np_tree(jvit.init_params(jax.random.key(1), registered)), str(teacher))
    flags = ["--config", registered.name, "--steps", "1", "--batch", "4",
             *[str(teacher) if f == "T" else f for f in extra]]
    rc, line = _refusal(_tmain, flags, capsys)
    jrc, jline = _refusal(_jmain, flags, capsys)
    assert rc == jrc == 2 and line.startswith("error: ")
    if "--distill-teacher" in extra:
        # the JAX package lists flags the port has not (--pp/--sp/--multihost)
        assert "--augment" in line and "--augment" in jline
    else:
        assert line == jline


@pytest.mark.parametrize("extra,words", [
    (["--augment", "flip,rotate"],
     "error: unknown augmentation(s) ['rotate']; choose from ['crop', 'cutmix', 'flip', 'mixup']"),
    (["--augment", "mixup", "--mixup-alpha", "0"],
     "error: mixup_alpha must be > 0 (got 0.0); to disable mixup, drop 'mixup' from the "
     "augmentation list instead"),
    (["--augment", "cutmix", "--cutmix-alpha", "-1"],
     "error: cutmix_alpha must be > 0 (got -1.0); to disable cutmix, drop 'cutmix' from the "
     "augmentation list instead"),
    (["--mae", "--augment", "flip"], "use --resume for warm starts"),
    (["--mae", "--freeze-backbone"], "--freeze-backbone/--eval-data-dir"),
    (["--mae", "--save-reference", "R"], "--init-weights/--save-reference/--optimizer"),
], ids=["unknown", "mixup_alpha", "cutmix_alpha", "mae_augment", "mae_freeze",
        "mae_save_reference"])
def test_recipe_refusals(registered, capsys, extra, words):
    rc, line = _refusal(_tmain, ["--config", registered.name, "--steps", "1", "--batch", "4",
                                 *extra], capsys)
    assert rc == 2 and words in line


def test_resume_refusals(registered, init_npz, tmp_path, capsys):
    base = ["--config", registered.name, "--steps", "1", "--batch", "4", "--ops", "eager"]
    # a bare params npz: peek_step's words
    rc, line = _refusal(_tmain, [*base, "--resume", str(init_npz)], capsys)
    assert rc == 2 and line == (f"error: {init_npz}: not a train-state archive (no __step__); "
                                "was this saved with --save-state?")
    # another optimizer: the leaf count, then a leaf's shape
    frozen = tmp_path / "frozen.npz"
    assert _tmain([*base, "--freeze-backbone", "--save-state", str(frozen)]) == 0
    capsys.readouterr()
    rc, line = _refusal(_tmain, [*base, "--resume", str(frozen)], capsys)
    assert rc == 2 and line == ("error: checkpoint has 5 optimizer leaves, template has 41 "
                                "(optimizer mismatch?)")
    with pytest.raises(ValueError, match=r"opt leaf 1: checkpoint shape \(11,\) != template "
                       r"\(2, 256\) \(optimizer mismatch\?\)"):
        tckpt.load_train_state(frozen, [()] + [(2, 256)] * 4)


def test_tree_helpers_are_jaxs(tiny_cfg):
    from vit_tpu.utils import cast_tree, flatten_tree, unflatten_tree
    from vit_tpu_torch import utils as tutils

    tree = _np_tree(jvit.init_params(jax.random.key(0), tiny_cfg))
    flat = tutils.flatten_tree(tree)
    assert list(flat) == list(flatten_tree(tree))
    assert list(tutils.flatten_tree(tree, sep=".")) == list(flatten_tree(tree, sep="."))
    back = tutils.unflatten_tree(flat)
    assert jax.tree.structure(back) == jax.tree.structure(unflatten_tree(flatten_tree(tree)))
    assert all(a.dtype == np.float16 for a in jax.tree.leaves(tutils.cast_tree(tree, np.float16)))
    assert jax.tree.leaves(cast_tree(tree, np.float16))[0].dtype == np.float16
    t = tutils.cast_tree({"a": {"b": torch.ones(2)}}, torch.bfloat16)
    assert t["a"]["b"].dtype == torch.bfloat16


# -- tensor parallelism: a tp 2 archive is a one-device archive ---------------------------


def test_tp2_archive_and_resume_are_the_one_device_runs(registered, init_npz, tmp_path):
    """Two gloo ranks (``tests/torch_parallel_train_worker.py --cli``): a tp 2
    run saves the whole tree and the whole moments, as the one-device run's
    archive; resumed under tp 2, the one-device archive continues as the
    one-device run does."""
    flags = ["--config", registered.name, "--batch", "4", "--lr", str(LR), "--seed", "2",
             "--ops", "fused_train", "--ema-decay", "0.9"]
    one_k, one_km = tmp_path / "one_k.npz", tmp_path / "one_km.npz"
    assert _tmain([*flags, "--init-weights", str(init_npz), "--steps", str(K_STEPS),
                   "--save-state", str(one_k)]) == 0
    assert _tmain([*flags, "--resume", str(one_k), "--steps", str(M_STEPS),
                   "--save-state", str(one_km)]) == 0
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO / 'tests'}", OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    ranks = ["--device", "cpu", "--dist-backend", "gloo", "--tp", "2"]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--standalone",
         str(REPO / "tests" / "torch_parallel_train_worker.py"), "--cli",
         *flags, *ranks, "--init-weights", str(init_npz), "--steps", str(K_STEPS),
         "--save-state", str(tmp_path / "tp_k.npz"), "--and",
         *flags, *ranks, "--resume", str(one_k), "--steps", str(M_STEPS),
         "--save-state", str(tmp_path / "tp_km.npz")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("resumed EMA from") == 1  # rank 0 alone prints
    for tp, one, steps in (("tp_k", one_k, K_STEPS), ("tp_km", one_km, K_STEPS + M_STEPS)):
        _assert_archives_close(_archive(tmp_path / f"{tp}.npz"), _archive(one), registered, steps)
        _assert_archives_close(_archive(tmp_path / f"{tp}.ema.npz"),
                               _archive(Path(one).with_suffix(".ema.npz")), registered, steps)
