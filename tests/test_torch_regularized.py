"""Regularized training (dropout + stochastic depth in the kernels K10,
K11, K12a) against the JAX package on the CPU: the hash masks bit for bit,
the kernels' plain twins against the Pallas kernels in interpret mode, the
regularized block's forward and gradients, the model's logits and
gradients under drop-path, and the train CLI's --dropout/--drop-path.

The CUDA kernels have no CPU mode; ``test_torch_cuda.py`` holds them to
these twins on the card.

Tolerances: masks exact (the same integer hash); the fp32 block forward
1e-5 and its gradients 1e-4 x max(1, |g|) — the JAX package's own bars for
its regularized kernels against autodiff (tests/test_backward.py:320,356);
the twins at test_torch_backward.py's (fp32 1e-5 forward, 1e-4 backward;
bf16 a few ulps of each output's scale, because a flipped rounding of an
intermediate carries through the next GEMM).  The model's fp32 logits
1e-5 and gradients 1e-4 x max(1, |g|).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops.pallas.backward as JB
import vit_tpu.ops.pallas.fused_block as JF
from vit_tpu.models import vit as jvit
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu.ops.pallas import trainable as JT
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops import fused_block as TF
from vit_tpu_torch.ops import reference as TR
from vit_tpu_torch.ops import trainable as TT
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.ops.kernels.ln_mlp_out_residual_bwd_train import (
    ln_mlp_out_residual_bwd_train,
    ln_mlp_out_residual_bwd_train_plain,
)
from vit_tpu_torch.ops.kernels.ln_mlp_residual_train import (
    ln_mlp_residual_train,
    ln_mlp_residual_train_plain,
)
from vit_tpu_torch.ops.kernels.out_residual_train import (
    out_residual_train,
    out_residual_train_plain,
)
from vit_tpu_torch.runtime import trainer as ttrainer

EPS = 1e-6
BIG_SEED = 2 ** 31 + 12345  # >= 2^31: the int32 round trip of the JAX operand
FWD_TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=2e-2, rtol=2 ** -7)}


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _bits(t):
    return np.asarray(t, np.float32).view(np.uint32)


# -- the masks -----------------------------------------------------------------


@pytest.mark.parametrize("site", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("p", [0.1, 0.3, 0.5])
def test_dropout_mask_matches_jax(p, site):
    for seed, rows0 in ((0, 0), (42, 384), (BIG_SEED, 12608 - 64)):
        want = JF.dropout_mask(jnp.uint32(seed), site, rows0, (64, 200), p)
        got = TF.dropout_mask(seed, site, rows0, (64, 200), p)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("rate", [0.0, 0.4, 0.99])
def test_drop_path_rows_match_jax(rate):
    for seed in (5, BIG_SEED):
        for site in (4, 5):
            want = JF.drop_path_scale_rows(jnp.uint32(seed), site, 200, 3, rate)
            got = TF.drop_path_scale_rows(seed, site, 200, 3, rate)
            np.testing.assert_array_equal(_bits(got.numpy()), _bits(want).reshape(-1))
    if rate == 0.0:
        assert (got == 1.0).all()


def test_hash_matches_jax_at_large_positions():
    rng = np.random.default_rng(0)
    r = rng.integers(0, 2 ** 31, 4096, dtype=np.int64)
    c = rng.integers(0, 2 ** 31, 4096, dtype=np.int64)
    for seed in (0, 7, BIG_SEED, 2 ** 32 - 1):
        for site in (1, 5):
            want = JF.mask_hash_u32(jnp.uint32(seed), site, jnp.asarray(r, jnp.uint32),
                                    jnp.asarray(c, jnp.uint32))
            got = TF.mask_hash_u32(seed, site, torch.from_numpy(r), torch.from_numpy(c))
            np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_mask_statistics():
    # tests/test_backward.py:380-409: the keep probabilities, the block
    # decomposition (the forward and backward cut rows differently), and
    # drop-path constant within a sample
    p = 0.3
    m = TF.dropout_mask(42, TF.DROP_SITE_MLP_INNER, 0, (512, 512), p).numpy()
    assert abs((m > 0).mean() - (1 - p)) < 0.01
    np.testing.assert_allclose(m[m > 0], 1.0 / (1 - p), rtol=1e-6)
    np.testing.assert_array_equal(m[128:256], TF.dropout_mask(42, 2, 128, (128, 512), p).numpy())
    s = TF.drop_path_scale_rows(42, TF.DROP_SITE_DP_ATTN, 200, 7, 0.4).numpy().reshape(200, 7)
    assert (s == s[:, :1]).all() and abs((s[:, 0] == 0).mean() - 0.4) < 0.1
    assert TF.dropout_launch_args(BIG_SEED + 2 ** 32, 0.1) == (
        BIG_SEED, int(0.1 * 4294967296.0), float(np.float32(1 / 0.9)), 1)
    assert TF.dropout_launch_args(3, 0.0)[1:] == (0, 1.0, 0)


# -- the kernels' plain twins against the Pallas kernels ----------------------


def _pairs(arrays, dtype):
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _dp(seed, site, rows, t, rate):
    j = JF.drop_path_scale_rows(jnp.uint32(seed), site, rows // t, t, rate)
    return j, TF.drop_path_scale_rows(seed, site, rows // t, t, rate)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_out_residual_train_twin_matches_pallas(dtype):
    rows, d, t = 100, 64, 5
    jops, tops = _pairs([_np(1, rows, d), _np(2, rows, d, scale=2.0),
                         _np(3, d, d, scale=d ** -0.5), _np(4, d, scale=0.1)], dtype)
    jdp, tdp = _dp(9, 4, rows, t, 0.3)
    want = JF.out_residual_train(*jops, jdp, jnp.uint32(BIG_SEED), 0.2, block_rows=32,
                                 interpret=True)
    got = out_residual_train_plain(*tops, tdp, BIG_SEED, 0.2)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), **FWD_TOL[dtype])
    # the mask pattern itself: with a zero residual the dropped outputs are exact zeros
    zero = torch.zeros_like(tops[1])
    got0 = out_residual_train_plain(tops[0], zero, *tops[2:], tdp, BIG_SEED, 0.2)
    want0 = JF.out_residual_train(jops[0], jnp.zeros_like(jops[1]), *jops[2:], jdp,
                                  jnp.uint32(BIG_SEED), 0.2, block_rows=32, interpret=True)
    np.testing.assert_array_equal(_f32(got0) == 0, _f32(want0) == 0)


def _k11_arrays(rows, d, f, seed):
    return [_np(seed, rows, d, scale=2.0), _np(seed + 1, d, scale=0.2, shift=1.0),
            _np(seed + 2, d, scale=0.2), _np(seed + 3, d, f, scale=d ** -0.5),
            _np(seed + 4, f, scale=0.1), _np(seed + 5, f, d, scale=f ** -0.5),
            _np(seed + 6, d, scale=0.1)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_ln_mlp_residual_train_twin_matches_pallas(dtype, variant):
    rows, t = 100, 5
    jops, tops = _pairs(_k11_arrays(rows, 64, 256, 10), dtype)
    jdp, tdp = _dp(9, 5, rows, t, 0.3)
    want = JF.ln_mlp_residual_train(*jops, jdp, jnp.uint32(BIG_SEED), 0.2, EPS, variant,
                                    block_rows=32, interpret=True)
    got = ln_mlp_residual_train_plain(*tops, tdp, BIG_SEED, 0.2, EPS, variant)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), **FWD_TOL[dtype])


def _k12a_arrays(rows, d, f, seed):
    return [_np(seed, rows, d), _np(seed + 1, rows, d, scale=2.0), _np(seed + 2, rows, d),
            _np(seed + 3, d, scale=0.2, shift=1.0), _np(seed + 4, d, scale=0.2),
            _np(seed + 5, d, f, scale=d ** -0.5), _np(seed + 6, f, scale=0.1),
            _np(seed + 7, f, d, scale=f ** -0.5), _np(seed + 8, d, d, scale=d ** -0.5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,p", [(100, 0.2), (34, 0.0)], ids=["ragged_100", "drop_path_only"])
def test_ln_mlp_out_residual_bwd_train_twin_matches_pallas(dtype, variant, rows, p):
    t = 5 if rows == 100 else 17
    jops, tops = _pairs(_k12a_arrays(rows, 64, 256, 30), dtype)
    jdpm, tdpm = _dp(3, 5, rows, t, 0.3)
    jdpa, tdpa = _dp(3, 4, rows, t, 0.3)
    want = JB.ln_mlp_out_residual_bwd_train(*jops, jdpm, jdpa, jnp.uint32(BIG_SEED), p, EPS,
                                            variant, block_rows=32, interpret=True)
    got = ln_mlp_out_residual_bwd_train_plain(*tops, tdpm, tdpa, BIG_SEED, p, EPS, variant)
    assert got[0].dtype == got[1].dtype == getattr(torch, dtype)
    assert all(g.dtype == torch.float32 for g in got[2:])
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _f32(g), _f32(w).reshape(g.shape)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=f"output {i}")
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), f"output {i}"


# -- the regularized block -----------------------------------------------------


def _block(d, f, seed):
    return {
        "ln1_scale": _np(seed, d, scale=0.2, shift=1.0), "ln1_bias": _np(seed + 1, d, scale=0.2),
        "wqkv": _np(seed + 2, d, 3 * d, scale=d ** -0.5), "bqkv": _np(seed + 3, 3 * d, scale=0.1),
        "wo": _np(seed + 4, d, d, scale=d ** -0.5), "bo": _np(seed + 5, d, scale=0.1),
        "ln2_scale": _np(seed + 6, d, scale=0.2, shift=1.0), "ln2_bias": _np(seed + 7, d, scale=0.2),
        "w1": _np(seed + 8, d, f, scale=d ** -0.5), "b1": _np(seed + 9, f, scale=0.1),
        "w2": _np(seed + 10, f, d, scale=f ** -0.5), "b2": _np(seed + 11, d, scale=0.1),
    }


def _port(fn, x, blk, weight, *args):
    xt = torch.from_numpy(x).requires_grad_(True)
    bt = {k: torch.from_numpy(v).requires_grad_(True) for k, v in blk.items()}
    out = fn(xt, bt, *args)
    (out * torch.from_numpy(weight)).sum().backward()
    return out.detach().numpy(), xt.grad.numpy(), {k: v.grad.numpy() for k, v in bt.items()}


def _grads_close(got, want, bound=1e-4):
    for k, w in want.items():
        w = np.asarray(w)
        assert np.abs(got[k] - w).max() <= bound * max(1.0, np.abs(w).max()), k


# (batch, T): rows 15; rows 300 = more than one 256-row block and not a multiple
@pytest.mark.parametrize("batch,t,variant", [(3, 5, "exact"), (3, 5, "tanh"), (60, 5, "exact")],
                         ids=["tiny_exact", "tiny_tanh", "rows300"])
def test_regularized_block_matches_jax(batch, t, variant):
    d, f, heads = 64, 256, 4
    x, weight, blk = _np(1, batch * t, d, scale=0.5), _np(2, batch * t, d), _block(d, f, 10)
    args = (heads, t, EPS, variant, BIG_SEED, 0.2, 0.3)

    def jloss(xj, bj):
        return jnp.sum(JT.encoder_block_train(xj, bj, *args[:4], jnp.uint32(BIG_SEED), 0.2, 0.3)
                       * weight)

    jx, jb = jnp.asarray(x), jax.tree.map(jnp.asarray, blk)
    jout = JT.encoder_block_train(jx, jb, *args[:4], jnp.uint32(BIG_SEED), 0.2, 0.3)
    jgx, jgb = jax.grad(jloss, argnums=(0, 1))(jx, jb)
    for fn in (TT.encoder_block_train, TT.train_block_reference_2d):
        out, gx, gb = _port(fn, x, blk, weight, *args)
        np.testing.assert_allclose(out, np.asarray(jout), atol=1e-5, rtol=0)
        _grads_close({"x": gx, **gb}, {"x": jgx, **jgb})


def test_zero_rates_equal_the_unregularized_block():
    b, t, d, f, heads = 3, 5, 64, 256, 4
    x, weight, blk = _np(3, b * t, d, scale=0.5), _np(4, b * t, d), _block(d, f, 30)
    out, gx, gb = _port(TT.encoder_block_train, x, blk, weight, heads, t, EPS, "exact", 5, 0.0, 0.0)
    rout, rgx, rgb = _port(TT.encoder_block_trainable, x, blk, weight, heads, t, EPS, "exact")
    np.testing.assert_array_equal(out, rout)
    np.testing.assert_array_equal(gx, rgx)
    for k in rgb:
        np.testing.assert_array_equal(gb[k], rgb[k])


def test_long_sequence_regularized_block_raises():
    blk = {k: torch.from_numpy(v) for k, v in _block(64, 256, 70).items()}
    with pytest.raises(ValueError, match="seq_len <= 1024"):
        TT.encoder_block_train(torch.zeros(1025, 64), blk, 4, 1025, EPS, "exact", 1, 0.1, 0.1)


# -- the model ----------------------------------------------------------------


def test_model_drop_path_logits_and_grads_match_jax(tiny_cfg, monkeypatch):
    cfg = dataclasses.replace(tiny_cfg, depth=3, drop_path=0.1, dropout=0.0)
    jparams = jax.tree.map(lambda a: np.array(a, np.float32), jvit.init_params(jax.random.key(3), cfg))
    x = np.random.default_rng(3).normal(size=(4, 3, 32, 32)).astype(np.float32)
    weight = _np(5, 4, cfg.num_classes)
    key = jax.random.key(11)

    def jloss(p):
        logits = jvit.forward(p, jnp.asarray(x), cfg, jget_ops("fused_train"), dropout_rng=key)
        return jnp.sum(logits * weight), logits

    (_, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, jparams))
    seeds = [int(s) for s in np.asarray(jax.random.bits(key, (cfg.depth,), jnp.uint32))]
    monkeypatch.setattr(tvit, "layer_seeds", lambda gen, depth: seeds[:depth])
    params = ttrainer.as_trainable(params_from_numpy(jparams, "cpu"), "cpu")
    logits = tvit.forward(params, torch.from_numpy(x), cfg, get_ops("fused_train"),
                          dropout_rng=torch.Generator().manual_seed(0))
    (logits * torch.from_numpy(weight)).sum().backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits), atol=1e-5, rtol=0)
    got = params_to_numpy({k: v for k, v in _grad_tree(params).items()})
    want = jax.tree.map(np.asarray, jgrads)

    def walk(a, b, path=""):
        for k in b:
            if isinstance(b[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
            else:
                assert np.abs(a[k] - b[k]).max() <= 1e-4 * max(1.0, np.abs(b[k]).max()), path + k

    walk(got, want)
    # the schedule's layer 0 keeps every sample; the last drops some at 0.1
    assert tvit._dp_rates(cfg) == [0.0, 0.05, 0.1]


def _grad_tree(tree):
    return {k: _grad_tree(v) if isinstance(v, dict) else v.grad for k, v in tree.items()}


def test_fused_forward_refuses_dropout(tiny_cfg):
    params = params_from_numpy(jax.tree.map(np.array, jvit.init_params(jax.random.key(0), tiny_cfg)),
                               "cpu")
    with pytest.raises(ValueError, match="no kernel hooks"):
        tvit.forward(params, torch.zeros(1, 3, 32, 32), tiny_cfg, get_ops("fused"),
                     dropout_rng=torch.Generator())


def test_eager_regularizers():
    gen = torch.Generator().manual_seed(0)
    x = torch.ones(400, 500)
    y = TR.dropout(x, 0.25, gen)
    assert abs((y > 0).float().mean().item() - 0.75) < 0.01
    assert set(torch.unique(y).tolist()) == {0.0, float(np.float32(1 / 0.75))}
    z = tvit._drop_path(torch.ones(2000, 3, 4), 0.4, gen)
    assert (z == z[:, :1, :1]).all() and abs((z[:, 0, 0] == 0).float().mean().item() - 0.4) < 0.05
    w1, w2 = torch.eye(6, 8), torch.eye(8, 6)
    h = TR.mlp(torch.ones(50, 6), w1, torch.zeros(8), w2, torch.zeros(6),
               inner_dropout=(torch.Generator().manual_seed(1), 0.5))
    assert ((h == 0) | (h > 1.5)).all() and (h == 0).any()


# -- the trainer and the train CLI ---------------------------------------------


def test_dropout_step_needs_a_generator_and_remat_draws_the_same_masks(tiny_cfg):
    cfg = dataclasses.replace(tiny_cfg, dropout=0.2, drop_path=0.3)
    with pytest.raises(ValueError, match="rng"):
        ttrainer.make_train_step(cfg, None, use_dropout=True)
    x = torch.from_numpy(np.random.default_rng(4).normal(size=(4, 3, 32, 32)).astype(np.float32))
    y = torch.tensor([1, 2, 3, 4])
    results = []
    for remat in (False, True):
        params = ttrainer.init_train_state(torch.Generator().manual_seed(0), cfg,
                                           lambda p: None, device="cpu")[0]
        opt = torch.optim.SGD(list(ttrainer.leaves(params)), lr=0.05)
        step = ttrainer.make_train_step(cfg, opt, remat=remat, use_dropout=True,
                                        rng=torch.Generator().manual_seed(7))
        results.append(([float(step(params, x, y)) for _ in range(2)], params_to_numpy(params)))
    (l0, p0), (l1, p1) = results
    assert l0 == l1 and l0[0] != l0[1]
    for a, b in zip(ttrainer.leaves(p0), ttrainer.leaves(p1)):
        np.testing.assert_array_equal(a, b)


@pytest.fixture
def tiny_registered(tiny_cfg, monkeypatch):
    import vit_tpu_torch.config as tconfig_mod

    monkeypatch.setitem(tconfig_mod.CONFIGS, "vit_tiny_test", tiny_cfg)
    monkeypatch.setitem(tconfig_mod.CONFIGS, "vit_long_test",
                        dataclasses.replace(tiny_cfg, image_size=512, name="vit_long_test"))
    return tiny_cfg


def _cli_losses(tmp_path, name, *flags):
    from vit_tpu_torch.cli.train import main

    log = tmp_path / f"{name}.jsonl"
    assert main(["--config", "vit_tiny_test", "--steps", "2", "--batch", "4", "--device", "cpu",
                 "--seed", "3", "--log-jsonl", str(log), *flags]) == 0
    return [float(line.split('"loss": ')[1].split(",")[0]) for line in log.read_text().splitlines()]


def test_train_cli_regularized_step(tiny_registered, tmp_path, capsys):
    reg = ["--dropout", "0.1", "--drop-path", "0.1"]
    eager = _cli_losses(tmp_path, "eager", "--ops", "eager", *reg)
    fused = _cli_losses(tmp_path, "fused", "--ops", "fused_train", *reg)
    again = _cli_losses(tmp_path, "again", "--ops", "fused_train", *reg)
    plain = _cli_losses(tmp_path, "plain", "--ops", "fused_train")
    assert "dropout: 0.1  drop_path: 0.1" in capsys.readouterr().out
    assert np.isfinite(eager + fused).all() and fused == again
    # same seed, params, data and position-site mask: the two tables draw
    # different in-block masks (Bernoulli draws vs the kernels' hash), which
    # move a 2-layer model's first loss by a few percent, not more
    assert abs(eager[0] - fused[0]) <= 0.1 * plain[0] and fused != plain


def test_train_cli_regularizer_guards(tiny_registered, capsys):
    from vit_tpu_torch.cli.train import main

    base = ["--steps", "1", "--batch", "2", "--device", "cpu", "--dropout", "0.1"]
    with pytest.raises(SystemExit):
        main(["--config", "vit_tiny_test", "--ops", "fused", *base])
    assert main(["--config", "vit_long_test", "--ops", "fused_train", *base]) == 2
    assert "seq_len <= 1024" in capsys.readouterr().err


# -- the wrappers ----------------------------------------------------------------


def test_cpu_wrappers_run_the_twin_and_count_no_launch():
    fns = (out_residual_train, ln_mlp_residual_train, ln_mlp_out_residual_bwd_train)
    counts = [fn.launches for fn in fns]
    dp = TF.drop_path_scale_rows(1, 4, 2, 5, 0.5)
    k10 = [torch.from_numpy(a) for a in (_np(1, 10, 64), _np(2, 10, 64), _np(3, 64, 64), _np(4, 64))]
    torch.testing.assert_close(out_residual_train(*k10, dp, 9, 0.1),
                               out_residual_train_plain(*k10, dp, 9, 0.1), rtol=0, atol=0)
    k11 = [torch.from_numpy(a) for a in _k11_arrays(10, 64, 256, 5)]
    torch.testing.assert_close(ln_mlp_residual_train(*k11, dp, 9, 0.1, EPS),
                               ln_mlp_residual_train_plain(*k11, dp, 9, 0.1, EPS), rtol=0, atol=0)
    k12 = [torch.from_numpy(a) for a in _k12a_arrays(10, 64, 256, 6)]
    for got, want in zip(ln_mlp_out_residual_bwd_train(*k12, dp, dp, 9, 0.1, EPS),
                         ln_mlp_out_residual_bwd_train_plain(*k12, dp, dp, 9, 0.1, EPS)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [fn.launches for fn in fns] == counts


@pytest.mark.parametrize("kernel", ["out_residual_train", "ln_mlp_residual_train",
                                    "ln_mlp_out_residual_bwd_train"])
def test_wrappers_refuse_other_devices(kernel):
    # a non-CPU tensor either launches the kernel or raises; never the twin
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    dp = m(10)
    calls = {
        "out_residual_train": lambda: out_residual_train(m(10, 64), m(10, 64), m(64, 64), m(64),
                                                         dp, 1, 0.1),
        "ln_mlp_residual_train": lambda: ln_mlp_residual_train(
            m(10, 64), m(64), m(64), m(64, 256), m(256), m(256, 64), m(64), dp, 1, 0.1, EPS),
        "ln_mlp_out_residual_bwd_train": lambda: ln_mlp_out_residual_bwd_train(
            m(10, 64), m(10, 64), m(10, 64), m(64), m(64), m(64, 256), m(256), m(256, 64),
            m(64, 64), dp, dp, 1, 0.1, EPS),
    }
    with pytest.raises(ValueError, match="CUDA or CPU"):
        calls[kernel]()
