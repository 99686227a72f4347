"""The port's training slice against the JAX package on the CPU: the
``fused_train`` block's gradients, one train step, the optimizer pieces
and the train CLI, plus the train-side faults.

The JAX side runs its Pallas kernels in interpret mode (as
``tests/test_backward.py`` does); the port's kernels run through their
plain twins.  Inputs come from numpy seeds and JAX's own initializer, and
cross as numpy arrays.

Tolerances:
  - fp32 block gradients 1e-4 (tests/test_backward.py's bar for the Pallas
    backward against autodiff); fp32 step: loss 1e-5, params 1e-4
    (test_backward.py:168-191).
  - mixed precision (bf16 compute, fp32 master weights): both sides round
    at the same points, but a bf16 rounding that flips on a last-bit
    difference moves a value by up to 2^-7 of itself and the flip
    propagates; so the loss is held to 2e-2 (ROADMAP.md section 3, "bf16
    tolerances") and each leaf's SGD(0.05) update to 2e-2 of its largest.
  - optimizer pieces on fixed numpy gradients: 1e-6, fp32 arithmetic in a
    different order.
  - train CLIs: per-step loss and saved params 1e-4 — except the key
    bias, whose gradient is rounding noise around an exact zero (see the
    test).
"""

import dataclasses
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
from vit_tpu.ops.pallas import trainable as JT
from vit_tpu.runtime import trainer as jtrainer
from vit_tpu_torch.cli import train_setup
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops import trainable as TT
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.runtime import trainer as ttrainer

EPS = 1e-6


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _jtree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _max_leaf_diff(a, b):
    """max |a - b| over two nested dicts of numpy arrays with the same keys."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return max(_max_leaf_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


@pytest.fixture(scope="module")
def jparams(tiny_cfg):
    return _jtree(jvit.init_params(jax.random.key(3), tiny_cfg))


@pytest.fixture(scope="module")
def batch(tiny_cfg):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 3, tiny_cfg.image_size, tiny_cfg.image_size)).astype(np.float32)
    return x, rng.integers(0, tiny_cfg.num_classes, 4).astype(np.int32)


# -- the block: port autograd vs jax.grad of the JAX fused_train block -------


def _block(d, f, seed):
    return {
        "ln1_scale": _np(seed, d, scale=0.2, shift=1.0), "ln1_bias": _np(seed + 1, d, scale=0.2),
        "wqkv": _np(seed + 2, d, 3 * d, scale=d ** -0.5), "bqkv": _np(seed + 3, 3 * d, scale=0.1),
        "wo": _np(seed + 4, d, d, scale=d ** -0.5), "bo": _np(seed + 5, d, scale=0.1),
        "ln2_scale": _np(seed + 6, d, scale=0.2, shift=1.0), "ln2_bias": _np(seed + 7, d, scale=0.2),
        "w1": _np(seed + 8, d, f, scale=d ** -0.5), "b1": _np(seed + 9, f, scale=0.1),
        "w2": _np(seed + 10, f, d, scale=f ** -0.5), "b2": _np(seed + 11, d, scale=0.1),
    }


def _port_block_grads(fn, x, blk, weight, heads, t, variant):
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in blk.items()}
    out = fn(xt, bt, heads, t, EPS, variant)
    (out * torch.from_numpy(weight)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), {k: v.grad.numpy() for k, v in bt.items()}


# (batch, T): tiny T = 5, T = 17 (image 64 at patch 16), DeiT's two prefix
# tokens over a 2 x 2 patch grid (T = 6)
BLOCK_CASES = {"tiny_t5": (3, 5), "t17": (2, 17), "deit_t6": (3, 6)}


@pytest.mark.parametrize("case,variant", [("tiny_t5", "exact"), ("tiny_t5", "tanh"),
                                          ("t17", "exact"), ("deit_t6", "exact")])
def test_block_grads_match_jax(case, variant):
    b, t = BLOCK_CASES[case]
    d, f, heads = 64, 256, 4
    x = _np(1, b * t, d, scale=0.5)
    weight = _np(2, b * t, d)
    blk = _block(d, f, 10)

    def jloss(xj, bj):
        out = JT.encoder_block_trainable(xj, bj, heads, t, EPS, variant)
        return jnp.sum(out * weight)

    jgx, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, blk))
    _, gx, gb = _port_block_grads(TT.encoder_block_trainable, x, blk, weight, heads, t, variant)
    np.testing.assert_allclose(gx, np.asarray(jgx), atol=1e-4, rtol=1e-4)
    assert _max_leaf_diff(gb, _jtree(jgb)) <= 1e-4


@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_block_grads_match_the_eager_oracle(variant):
    # the kernels' analytic backward vs autograd through the eager block
    b, t, d, f, heads = 2, 5, 64, 256, 4
    x, weight, blk = _np(3, b * t, d, scale=0.5), _np(4, b * t, d), _block(d, f, 30)
    args = (x, blk, weight, heads, t, variant)
    out, gx, gb = _port_block_grads(TT.encoder_block_trainable, *args)
    rout, rgx, rgb = _port_block_grads(TT._reference_block_2d, *args)
    np.testing.assert_allclose(out, rout, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gx, rgx, atol=1e-4, rtol=1e-4)
    assert _max_leaf_diff(gb, rgb) <= 1e-4


def test_block_bf16_forward_rounds_x1_like_jax():
    # the training forward (K1 -> K4 -> K5) rounds x1 to bf16, unlike the
    # inference block (K2 keeps it fp32): held to the JAX custom-VJP forward
    from vit_tpu.ops.pallas.trainable import _fwd

    b, t, d, f, heads = 3, 5, 64, 256, 4
    x, blk = _np(5, b * t, d), _block(d, f, 50)
    jout, _ = _fwd(jnp.asarray(x, jnp.bfloat16),
                   jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), blk), heads, t, EPS, "exact")
    tout = TT.encoder_block_trainable(
        torch.from_numpy(x).bfloat16(), {k: torch.from_numpy(v).bfloat16() for k, v in blk.items()},
        heads, t, EPS)
    assert tout.dtype == torch.bfloat16
    np.testing.assert_allclose(tout.float().numpy(), np.asarray(jout, np.float32),
                               atol=2e-2, rtol=2 ** -7)


# -- one train step: port make_train_step vs JAX make_train_step -------------


def _jax_step(cfg, jparams, batch, opt, ops, compute_dtype=None, grad_accum=1):
    params = jax.tree.map(jnp.asarray, jparams)
    step = jtrainer.make_train_step(cfg, opt, jget_ops(ops), remat=False,
                                    compute_dtype=compute_dtype, grad_accum=grad_accum)
    p, _, loss = jax.jit(step)(params, opt.init(params), jnp.asarray(batch[0]),
                               jnp.asarray(batch[1]))
    return _jtree(p), float(loss)


def _port_step(cfg, jparams, batch, make_opt, ops, compute_dtype=None, grad_accum=1, remat=False):
    params = ttrainer.as_trainable(params_from_numpy(jparams, "cpu"), "cpu")
    opt = make_opt(list(ttrainer.leaves(params)))
    step = ttrainer.make_train_step(cfg, opt, get_ops(ops), remat=remat,
                                    compute_dtype=compute_dtype, grad_accum=grad_accum)
    loss = step(params, torch.from_numpy(batch[0]), torch.from_numpy(batch[1]))
    return params_to_numpy(params), float(loss)


@pytest.mark.parametrize("ops,jops", [("fused_train", "fused_train"), ("eager", "xla")])
def test_sgd_step_matches_jax(tiny_cfg, jparams, batch, ops, jops):
    want_p, want_loss = _jax_step(tiny_cfg, jparams, batch, optax.sgd(0.05), jops)
    got_p, got_loss = _port_step(tiny_cfg, jparams, batch,
                                 lambda p: torch.optim.SGD(p, lr=0.05), ops)
    assert abs(got_loss - want_loss) <= 1e-5
    assert _max_leaf_diff(got_p, want_p) <= 1e-4


def test_sgd_step_mixed_precision_matches_jax(tiny_cfg, jparams, batch):
    want_p, want_loss = _jax_step(tiny_cfg, jparams, batch, optax.sgd(0.05), "fused_train",
                                  compute_dtype=jnp.bfloat16)
    got_p, got_loss = _port_step(tiny_cfg, jparams, batch,
                                 lambda p: torch.optim.SGD(p, lr=0.05), "fused_train",
                                 compute_dtype=torch.bfloat16)
    assert all(v.dtype == np.float32 for v in ttrainer.leaves(got_p))  # fp32 masters
    assert abs(got_loss - want_loss) <= 2e-2
    _updates_close(got_p, want_p, jparams)


def _updates_close(got, want, start):
    """Each leaf's mixed-precision update within 2e-2 of the largest update
    of that leaf: every dW is rounded to bf16 before it widens to the fp32
    master, so one flipped rounding moves it by up to 2^-7 of itself."""
    if isinstance(want, dict):
        for k in want:
            _updates_close(got[k], want[k], start[k])
        return
    step = np.abs(want - start).max()
    assert np.abs(got - want).max() <= 2e-2 * step + 1e-6


def test_grad_accum_step_matches_jax(tiny_cfg, jparams, batch):
    want_p, want_loss = _jax_step(tiny_cfg, jparams, batch, optax.sgd(0.05), "fused_train",
                                  grad_accum=2)
    got_p, got_loss = _port_step(tiny_cfg, jparams, batch,
                                 lambda p: torch.optim.SGD(p, lr=0.05), "fused_train",
                                 grad_accum=2)
    assert abs(got_loss - want_loss) <= 1e-5
    assert _max_leaf_diff(got_p, want_p) <= 1e-4


def test_remat_step_equals_plain_step(tiny_cfg, jparams, batch):
    sgd = lambda p: torch.optim.SGD(p, lr=0.05)  # noqa: E731
    p0, l0 = _port_step(tiny_cfg, jparams, batch, sgd, "eager", remat=False)
    p1, l1 = _port_step(tiny_cfg, jparams, batch, sgd, "eager", remat=True)
    assert l0 == l1 and _max_leaf_diff(p0, p1) == 0.0


@pytest.mark.parametrize("kind", ["int", "smoothed", "soft"])
def test_cross_entropy_matches_jax(kind):
    logits = _np(7, 6, 11, scale=3.0)
    labels = np.arange(6, dtype=np.int32) % 11
    smoothing = 0.1 if kind == "smoothed" else 0.0
    if kind == "soft":
        labels = np.abs(_np(8, 6, 11))
        labels /= labels.sum(-1, keepdims=True)
    want = float(jtrainer.cross_entropy_loss(jnp.asarray(logits), jnp.asarray(labels), smoothing))
    got = float(ttrainer.cross_entropy_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                                            smoothing))
    assert abs(got - want) <= 1e-6


def test_init_params_shapes_and_scales_match_jax(tiny_cfg):
    cfg = dataclasses.replace(tiny_cfg, depth=3, embed_dim=128, num_heads=4)
    want = _jtree(jvit.init_params(jax.random.key(0), cfg))
    got = params_to_numpy(tvit.init_params(torch.Generator().manual_seed(0), cfg))

    def walk(a, b, path=""):
        assert a.keys() == b.keys(), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
                continue
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, f"{path}/{k}"
            # the same law: constants equal, std within 15%, and the
            # truncated draws bounded alike (2 std of the unit normal)
            sa, sb = float(a[k].std()), float(b[k].std())
            assert abs(sa - sb) <= 0.15 * sb, (f"{path}/{k}", sa, sb)
            if sb == 0:
                np.testing.assert_array_equal(a[k], b[k])
            elif k != "pos_embed":
                assert float(np.abs(a[k]).max()) <= float(np.abs(b[k]).max()) * 1.05

    walk(got, want)
    assert tvit.num_params(tvit.init_params(torch.Generator().manual_seed(0), cfg)) == sum(
        v.size for v in jax.tree.leaves(want))


def test_init_train_state(tiny_cfg):
    params, opt = ttrainer.init_train_state(
        torch.Generator().manual_seed(0), tiny_cfg, lambda p: torch.optim.SGD(
            list(ttrainer.leaves(p)), lr=0.1), device="cpu")
    leaves = list(ttrainer.leaves(params))
    assert all(t.requires_grad and t.is_leaf and t.dtype == torch.float32 for t in leaves)
    assert all(t.device.type == "cpu" for t in leaves)
    assert [id(t) for t in opt.param_groups[0]["params"]] == [id(t) for t in leaves]


def test_helpers_default_to_the_card(tiny_cfg, monkeypatch):
    # the card unless the caller asks for the CPU; without one they raise
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = {"w": np.zeros(3, np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy(tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.as_trainable({"w": torch.zeros(3)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttrainer.init_train_state(torch.Generator(), tiny_cfg, lambda p: None)


# -- optimizer pieces against optax on fixed numpy gradients ------------------


def _opt_params():
    return {
        "cls_token": _np(60, 8), "patch_embed": {"kernel": _np(61, 12, 8), "bias": _np(62, 8)},
        "blocks": {"ln1_scale": _np(63, 2, 8, shift=1.0), "wqkv": _np(64, 2, 8, 24)},
        "head": {"kernel": _np(65, 8, 5), "bias": _np(66, 5)},
    }


def _opt_grads(params, seed):
    """Fixed gradients, a dict in the params' own key order."""
    return {
        k: _opt_grads(v, seed) if isinstance(v, dict)
        else np.random.default_rng(seed + v.size).normal(size=v.shape).astype(np.float32)
        for k, v in params.items()
    }


@pytest.mark.parametrize("exempt", [False, True], ids=["all_decay", "wd_exempt_norm_bias"])
@pytest.mark.parametrize("clip", [0.0, 0.5], ids=["no_clip", "clip"])
def test_adamw_matches_optax(exempt, clip):
    params = _opt_params()
    lr, wd, steps = 1e-2, 0.05, 4
    sched = optax.warmup_cosine_decay_schedule(0.0, lr, max(steps // 10, 1), steps)
    mask = train_setup.decay_mask(params) if exempt else None
    opt = optax.adamw(sched, weight_decay=wd, mask=mask)
    if clip:
        opt = optax.chain(optax.clip_by_global_norm(clip), opt)
    jp, state = jax.tree.map(jnp.asarray, params), None
    state = opt.init(jp)

    tp = ttrainer.as_trainable(params_from_numpy(params, "cpu"), "cpu")
    lr_at = train_setup.warmup_cosine(lr, steps)
    topt = torch.optim.AdamW(train_setup.adamw_param_groups(tp, wd, exempt), lr=lr_at(0))
    for s in range(steps):
        g = _opt_grads(params, 100 * s)
        upd, state = opt.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, upd)
        for t, gv in zip(ttrainer.leaves(tp), ttrainer.leaves(g)):
            t.grad = torch.from_numpy(gv)
        if clip:
            torch.nn.utils.clip_grad_norm_(list(ttrainer.leaves(tp)), clip)
        for group in topt.param_groups:
            group["lr"] = lr_at(s)
        topt.step()
    assert _max_leaf_diff(params_to_numpy(tp), _jtree(jp)) <= 1e-6


def test_decay_mask_matches_jax(tiny_cfg, jparams):
    from vit_tpu.cli.train_setup import decay_mask as jmask

    assert train_setup.decay_mask(jparams) == jmask(jparams)
    groups = train_setup.adamw_param_groups(ttrainer.as_trainable(params_from_numpy(jparams, "cpu"), "cpu"),
                                            0.05, True)
    assert [g["weight_decay"] for g in groups] == [0.05, 0.0]
    n_decay = sum(v for v in jax.tree.leaves(jmask(jparams)))
    assert len(groups[0]["params"]) == n_decay


@pytest.mark.parametrize("steps", [1, 7, 40])
def test_warmup_cosine_matches_optax(steps):
    if steps == 1:
        with pytest.raises(train_setup.SetupError, match="warmup_cosine"):
            train_setup.warmup_cosine(1e-3, steps)
        return
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, max(steps // 10, 1), steps)
    lr_at = train_setup.warmup_cosine(1e-3, steps)
    for s in range(steps + 2):
        assert abs(lr_at(s) - float(want(s))) <= 1e-9


# -- the train CLIs of both packages ----------------------------------------


@pytest.fixture
def tiny_registered(tiny_cfg, monkeypatch):
    import vit_tpu.config as config_mod
    import vit_tpu_torch.config as tconfig_mod

    monkeypatch.setitem(config_mod.CONFIGS, "vit_tiny_test", tiny_cfg)
    monkeypatch.setitem(tconfig_mod.CONFIGS, "vit_tiny_test", tiny_cfg)
    return tiny_cfg


def _key_columns(cfg):
    """Mask of the packed QKV's key columns ((head, {q,k,v}, dh) order)."""
    dh = cfg.embed_dim // cfg.num_heads
    return (np.arange(3 * cfg.embed_dim) // dh) % 3 == 1


def _losses(path):
    return [json.loads(line)["loss"] for line in path.read_text().splitlines()]


def test_train_cli_matches_jax_cli(tiny_registered, jparams, tmp_path, capsys):
    from vit_tpu.cli.train import main as jmain
    from vit_tpu_torch.cli.train import main as tmain

    init = tmp_path / "p.npz"
    ckpt.save_npz(jparams, str(init))
    common = ["--config", "vit_tiny_test", "--init-weights", str(init), "--steps", "3",
              "--batch", "4", "--ops", "fused_train"]
    rc = tmain([*common, "--device", "cpu", "--log-jsonl", str(tmp_path / "t.jsonl"),
                "--save", str(tmp_path / "t.npz")])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ops: fused_train" in out and "step    2" in out
    rc = jmain([*common, "--dp", "1", "--no-compile-cache", "--log-jsonl",
                str(tmp_path / "j.jsonl"), "--save", str(tmp_path / "j.npz")])
    assert rc == 0
    got, want = _losses(tmp_path / "t.jsonl"), _losses(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 3 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    tp, jp = ckpt.load_npz(str(tmp_path / "t.npz")), ckpt.load_npz(str(tmp_path / "j.npz"))
    # the key bias's gradient is zero in exact arithmetic (a shift of every
    # key's score by q.b_k cancels in the softmax), so in floats it is
    # rounding noise that Adam's first steps scale up to about lr each;
    # those columns are held to 3 steps x lr, every other value to 1e-4
    tb, jb = tp["blocks"].pop("bqkv"), jp["blocks"].pop("bqkv")
    k = _key_columns(tiny_registered)
    assert _max_leaf_diff(tp, jp) <= 1e-4
    assert _max_leaf_diff(tb[:, ~k], jb[:, ~k]) <= 1e-4
    assert np.abs(tb[:, k]).max() <= 3 * 1e-3 + 1e-6 and np.abs(jb[:, k]).max() <= 3 * 1e-3 + 1e-6


def test_train_cli_synthetic_eager_runs(tiny_registered, tmp_path, capsys):
    from vit_tpu_torch.cli.train import main

    rc = main(["--config", "vit_tiny_test", "--steps", "2", "--batch", "4", "--device", "cpu",
               "--schedule", "warmup_cosine", "--wd-exempt-norm-bias", "--grad-clip", "1.0",
               "--label-smoothing", "0.1", "--grad-accum", "2", "--num-classes", "5"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "ops: eager" in out and "remat: True" in out and "step    1" in out


def test_train_cli_reads_input_and_labels(tiny_registered, tmp_path, capsys):
    from vit_tpu.io.images import save_image_bin, synth_images
    from vit_tpu_torch.cli.train import main

    save_image_bin(synth_images(6, tiny_registered, seed=5), str(tmp_path / "in.bin"))
    labels = np.arange(6, dtype="<i4") % tiny_registered.num_classes
    labels.tofile(tmp_path / "labels.bin")
    base = ["--config", "vit_tiny_test", "--steps", "3", "--batch", "4", "--device", "cpu",
            "--input", str(tmp_path / "in.bin")]
    assert main([*base, "--labels", str(tmp_path / "labels.bin")]) == 0
    assert "step    2" in capsys.readouterr().out  # 6 images: one aligned batch, cycled
    (labels + 100).astype("<i4").tofile(tmp_path / "bad.bin")
    assert main([*base, "--labels", str(tmp_path / "bad.bin")]) == 2
    assert "labels outside" in capsys.readouterr().err


# -- train-side faults --------------------------------------------------------


def test_train_cli_cuda_without_card_raises(tiny_registered, monkeypatch):
    from vit_tpu_torch.cli.train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda"):
        main(["--config", "vit_tiny_test", "--steps", "1", "--batch", "4", "--device", "cuda"])


def test_train_cli_refuses_orbax_and_bad_accum(tiny_registered, tmp_path, capsys):
    from vit_tpu_torch.cli.train import main

    (tmp_path / "ckpt").mkdir()
    base = ["--config", "vit_tiny_test", "--steps", "1", "--batch", "4", "--device", "cpu"]
    assert main([*base, "--init-weights", str(tmp_path / "ckpt")]) == 2
    assert "Orbax" in capsys.readouterr().err
    assert main([*base, "--grad-accum", "3"]) == 2
    assert "--grad-accum" in capsys.readouterr().err


def test_train_cli_has_no_flags_of_later_slices():
    from vit_tpu_torch.cli.train_args import build_parser

    flags = {o for a in build_parser()._actions for o in a.option_strings}
    for later in ("--zero1", "--fsdp"):
        assert later not in flags
    assert {"--pp", "--microbatches", "--sp"} <= flags  # pipeline and sequence parallelism's
    # the training loop's state and recipe's
    assert {"--save-state", "--save-every", "--resume", "--ema-decay", "--save-ema", "--augment",
            "--mixup-alpha", "--cutmix-alpha", "--freeze-backbone", "--skip-nonfinite",
            "--save-reference"} <= flags
    assert {"--tp", "--dp", "--dist-backend"} <= flags  # parallel training's
    assert {"--dropout", "--drop-path"} <= flags  # the regularized slice's
    assert {"--tome", "--tome-chunk"} <= flags  # token merging's
    assert "--optimizer" in flags  # the fused AdamW's
    # pretraining and distillation's
    assert {"--mae", "--mask-ratio", "--mae-decoder", "--no-norm-pix", "--save-backbone",
            "--distill-teacher", "--distill-teacher-int8", "--distill-config",
            "--distill-alpha", "--distill-soft", "--distill-tau"} <= flags
    ops = next(a for a in build_parser()._actions if "--ops" in a.option_strings)
    assert "qat" in ops.choices


def test_forward_dropout_rng_raises(tiny_cfg, jparams, batch):
    # the inference table has no regularized kernels; fused_train and eager do
    with pytest.raises(ValueError, match="no kernel hooks"):
        tvit.forward(params_from_numpy(jparams, "cpu"), torch.from_numpy(batch[0]), tiny_cfg,
                     get_ops("fused"), dropout_rng=torch.Generator())


def test_long_sequence_block_raises(monkeypatch):
    # past VMEM_ATTENTION_MAX_T the trainable block runs flash attention
    # (K13/K14's twins here) and the split backward (K8/K9's), and its
    # gradients are those of autograd through the eager block
    import vit_tpu_torch.ops.kernels.flash_attention_bwd as KFB

    calls = []
    plain = KFB.flash_attention_bwd_plain
    monkeypatch.setattr(KFB, "flash_attention_bwd_plain", lambda *a: calls.append(1) or plain(*a))
    from vit_tpu_torch.ops import fused_block

    d, t = 64, fused_block.VMEM_ATTENTION_MAX_T + 1
    x, weight, blk = _np(71, t, d, scale=0.5), _np(72, t, d), _block(d, 128, 70)
    out, gx, gb = _port_block_grads(TT.encoder_block_trainable, x, blk, weight, 4, t, "exact")
    assert calls == [1]
    rout, rgx, rgb = _port_block_grads(TT._reference_block_2d, x, blk, weight, 4, t, "exact")
    np.testing.assert_allclose(out, rout, atol=1e-5, rtol=0)
    np.testing.assert_allclose(gx, rgx, atol=1e-4, rtol=1e-4)
    assert _max_leaf_diff(gb, rgb) <= 1e-4


def test_fused_train_table():
    ops = get_ops("fused_train")
    assert ops.name == "fused_train" and ops.encoder_block is TT.encoder_block_trainable
    assert ops.encoder_block_train is TT.encoder_block_train
    assert get_ops("fused").encoder_block_train is None
    assert get_ops("eager").encoder_block_train is None
    from vit_tpu_torch.ops import reference

    assert ops.layer_norm is reference.layer_norm and ops.patch_embed is reference.patch_embed


# -- the train-step profiler ---------------------------------------------------


def test_profile_train_flop_counts():
    from vit_tpu_torch.cli.profile_train import layer_flop
    from vit_tpu_torch.config import VIT_B_16

    rows, t = 64 * 197, 197  # B/16 batch 64
    want = {
        "ln_qkv_attn": 2 * rows * 768 * 2304 + 4 * 64 * t ** 2 * 768,
        "out_residual": 2 * rows * 768 * 768,
        "ln_mlp_residual": 4 * rows * 768 * 3072,
        "ln_mlp_out_residual_bwd": 10 * rows * 768 * 3072 + 4 * rows * 768 * 768,
        "ln_qkv_attn_bwd": 6 * rows * 768 * 2304 + 10 * 64 * t ** 2 * 768,
    }
    want.update(out_residual_train=want["out_residual"],
                ln_mlp_residual_train=want["ln_mlp_residual"],
                ln_mlp_out_residual_bwd_train=want["ln_mlp_out_residual_bwd"],
                flash_attention_fwd=4 * 64 * t ** 2 * 768,
                flash_attention_bwd=10 * 64 * t ** 2 * 768,
                ln_mlp_residual_bwd=10 * rows * 768 * 3072,
                out_residual_bwd=4 * rows * 768 * 768)
    assert layer_flop(VIT_B_16, 64) == want


def test_profile_train_device_sum_drops_annotations():
    # stand-ins for key_averages() rows: two kernels, an op row that repeats
    # its kernel's device time, and a device-side annotation spanning both
    from types import SimpleNamespace as Row

    from vit_tpu_torch.cli.profile_train import device_kernel_us

    rows = [Row(key="gemm_mma_kernel", self_cpu_time_total=0, self_device_time_total=300,
                is_user_annotation=False),
            Row(key="sdpa_mma_kernel", self_cpu_time_total=0, self_device_time_total=100),
            Row(key="aten::mm", self_cpu_time_total=40, self_device_time_total=300,
                is_user_annotation=False),
            Row(key="Optimizer.step#AdamW.step", self_cpu_time_total=0,
                self_device_time_total=400, is_user_annotation=True)]
    assert device_kernel_us(rows, "self_device_time_total") == 400
    assert device_kernel_us(rows[:2], "self_device_time_total") == 400


def test_profile_train_needs_a_card(monkeypatch):
    from vit_tpu_torch.cli.profile_train import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a card"):
        main(["--batch", "2"])
