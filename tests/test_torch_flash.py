"""The long-sequence slice against the JAX package on the CPU: K13/K14's
plain twins (flash attention forward and its VJP), the packed-QKV context,
K8/K9's twins (the split MLP and out_proj backward), and the long
inference and trainable blocks, whole-model logits and one SGD step with
``VMEM_ATTENTION_MAX_T`` lowered in both packages.

The JAX side runs its Pallas kernels in interpret mode; the port's run
through their plain twins.  Inputs are made from numpy seeds and cross as
numpy arrays; everything is fp32.

Tolerances:
  - flash forward 2e-5 absolute (tests/test_flash_attention.py's own bar):
    both sides run an fp32 online softmax, with other block sizes, so only
    the rescaling and summation order differ; the logsumexp too.  Extreme
    logits 1e-4, that file's bar for the case (see the test).
  - flash gradients 1e-4 x max(1, max|g|) per gradient: the backward
    recomputes p from the logsumexp, so the forward's last-bit differences
    pass through exp and a T-long contraction.
  - K8/K9 and the long blocks' gradients, 1e-4 absolute and relative
    (tests/test_backward.py's bar for the Pallas backward against
    autodiff); forward blocks and logits 1e-5 / 1e-4 as in
    test_torch_kernels.py and test_kernel_shapes.py; the SGD step's loss
    1e-5 and params 1e-4 as in test_torch_train.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vit_tpu.ops.pallas.backward as JB
import vit_tpu.ops.pallas.fused_block as JF
from vit_tpu.models import vit as jvit
from vit_tpu.ops.pallas.flash_attention import _flash_forward as j_flash_forward
from vit_tpu.ops.pallas.flash_attention import flash_attention as j_flash_attention
from vit_tpu.ops.pallas.flash_attention import flash_context_from_packed_qkv as j_flash_context
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu.ops.pallas import trainable as JT
from vit_tpu.runtime import trainer as jtrainer
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops import flash_attention as TFA
from vit_tpu_torch.ops import fused_block as TF
from vit_tpu_torch.ops import trainable as TT
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.ops.kernels.flash_attention import flash_attention_fwd, flash_attention_fwd_plain
from vit_tpu_torch.ops.kernels.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from vit_tpu_torch.ops.kernels.ln_mlp_residual_bwd import (
    ln_mlp_residual_bwd,
    ln_mlp_residual_bwd_plain,
)
from vit_tpu_torch.ops.kernels.out_residual_bwd import out_residual_bwd, out_residual_bwd_plain
from vit_tpu_torch.runtime import trainer as ttrainer

EPS = 1e-6


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _qkv(seed, b, h, t, dh, scale=1.0):
    return [_np(seed + i, b, h, t, dh, scale=scale) for i in range(3)]


def _grads_close(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = 1e-4 * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= tol, f"{name}: max|d| {err} > {tol}"


def _max_leaf_diff(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        return max(_max_leaf_diff(a[k], b[k]) for k in a)
    return float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())


def _jtree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


# -- K13: the forward twin ----------------------------------------------------


@pytest.mark.parametrize(
    "t,bq,bk",
    [(64, 64, 64), (128, 64, 64), (160, 64, 64), (96, 32, 96), (100, 32, 32)],
    ids=["single", "multi", "ragged160", "k_unblocked", "ragged100"],
)
def test_flash_forward_matches_pallas(t, bq, bk):
    q, k, v = _qkv(t, 2, 2, t, 32)
    want, want_lse = j_flash_forward(*(jnp.asarray(a).reshape(4, t, 32) for a in (q, k, v)),
                                        bq, bk, True, True)
    got, lse = flash_attention_fwd(_t(q), _t(k), _t(v), return_lse=True)
    np.testing.assert_allclose(got.numpy().reshape(4, t, 32), np.asarray(want), atol=2e-5)
    np.testing.assert_allclose(lse.numpy().reshape(4, t, 1), np.asarray(want_lse), atol=2e-5)
    # the public function: (..., T, dh), the twin's output
    pub = TFA.flash_attention(_t(q), _t(k), _t(v))
    np.testing.assert_array_equal(pub.numpy(), got.numpy())


def test_flash_forward_extreme_logits():
    # scores of magnitude ~ 30^2 * 16 / 4: the fp32 online softmax must not
    # overflow.  Held to 1e-4, tests/test_flash_attention.py:101's own bar
    # for this case: an fp32 ulp of a score near 3,600 is 2.4e-4, which
    # exp carries into p relatively, so the two summation orders differ by
    # that much in a near one-hot softmax
    q, k = _np(3, 1, 1, 64, 16, scale=30.0), _np(4, 1, 1, 64, 16, scale=30.0)
    v = _np(5, 1, 1, 64, 16)
    want = j_flash_attention(*(jnp.asarray(a) for a in (q, k, v)), block_q=16, block_k=16,
                               interpret=True)
    got, _ = flash_attention_fwd_plain(_t(q), _t(k), _t(v))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# -- K14: the gradient twin through FlashAttentionFn --------------------------


@pytest.mark.parametrize("t,blk", [(100, 32), (160, 64)], ids=["ragged100", "ragged160"])
def test_flash_grads_match_jax(t, blk):
    q, k, v = _qkv(10 + t, 2, 2, t, 16)
    g = _np(20 + t, 2, 2, t, 16)

    def jloss(q, k, v):
        return jnp.sum(j_flash_attention(q, k, v, block_q=blk, block_k=blk, interpret=True) * g)

    want = jax.grad(jloss, (0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_(True) for a in (q, k, v))
    (TFA.flash_attention(tq, tk, tv) * _t(g)).sum().backward()
    for name, a, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        _grads_close(a.grad.numpy(), w, name)


def test_flash_backward_twin_equals_wrapper_on_cpu():
    q, k, v = (_t(a) for a in _qkv(7, 1, 2, 70, 32))
    do = _t(_np(9, 1, 2, 70, 32))
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, do)
    for a, b in zip(got, flash_attention_bwd_plain(q, k, v, out, lse, do)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


# -- the packed-QKV context -----------------------------------------------------


def test_flash_context_from_packed_qkv_matches_jax():
    b, t, heads, dh = 2, 70, 4, 16
    qkv = _np(30, b, t, 3 * heads * dh)
    w = _np(31, b * t, heads * dh)

    def jloss(x):
        return jnp.sum(j_flash_context(x, b, t, heads, interpret=True) * w)

    jx = jnp.asarray(qkv)
    want = j_flash_context(jx, b, t, heads, interpret=True)
    want_g = jax.grad(jloss)(jx)
    tx = _t(qkv).requires_grad_(True)
    got = TFA.flash_context_from_packed_qkv(tx, b, t, heads)
    assert tuple(got.shape) == (b * t, heads * dh)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)
    (got * _t(w)).sum().backward()
    assert tuple(tx.grad.shape) == qkv.shape
    _grads_close(tx.grad.numpy(), want_g, "dqkv")


# -- K8 and K9: the split backward twins ----------------------------------------


@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_ln_mlp_residual_bwd_matches_pallas(variant):
    rows, d, f = 37, 64, 128  # ragged against 16-row blocks
    ops = [_np(40, rows, d), _np(41, rows, d, scale=2.0), _np(42, d, scale=0.2, shift=1.0),
           _np(43, d, scale=0.2), _np(44, d, f, scale=d ** -0.5), _np(45, f, scale=0.1),
           _np(46, f, d, scale=f ** -0.5)]
    want = JB.ln_mlp_residual_bwd(*(jnp.asarray(a) for a in ops), EPS, variant, block_rows=16,
                                  interpret=True)
    got = ln_mlp_residual_bwd(*(_t(a) for a in ops), EPS, variant)
    assert len(got) == len(want) == 7
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape), atol=1e-4, rtol=1e-4,
                                   err_msg=f"output {i}")


def test_out_residual_bwd_matches_pallas():
    rows, d = 37, 64
    dx1, ctx, wo = _np(50, rows, d), _np(51, rows, d), _np(52, d, d, scale=d ** -0.5)
    want = JB.out_residual_bwd(*(jnp.asarray(a) for a in (dx1, ctx, wo)), block_rows=16,
                               interpret=True)
    got = out_residual_bwd(_t(dx1), _t(ctx), _t(wo))
    assert len(got) == len(want) == 3
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape), atol=1e-4, rtol=1e-4,
                                   err_msg=f"output {i}")


def test_split_backward_forms_that_raise():
    # the pre-GELU stash is ported: the recomputed u handed in as the stash
    # gives the recompute's outputs bit for bit (the JAX parity of every
    # stash form is tests/test_torch_backward.py:test_stash_twins_match_pallas)
    dy0, x0 = _t(_np(60, 4, 8)), _t(_np(61, 4, 8))
    w10, w20 = _t(_np(62, 8, 16, scale=0.3)), _t(_np(63, 16, 8, scale=0.3))
    s0, b0, b10 = _t(_np(64, 8, shift=1.0)), _t(_np(65, 8)), _t(_np(66, 16))
    from vit_tpu_torch.ops.backward import _ln_stats

    u = (_ln_stats(x0, EPS)[0] * s0 + b0) @ w10 + b10  # the twin's own fp32 recompute
    for a, c in zip(ln_mlp_residual_bwd(dy0, x0, s0, b0, w10, b10, w20, EPS, u=u),
                    ln_mlp_residual_bwd(dy0, x0, s0, b0, w10, b10, w20, EPS)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    # residual=False (tensor parallelism's form) is ported: dy's identity
    # term leaves dx1, every other output stays
    dy, x1 = _t(_np(70, 4, 8)), _t(_np(71, 4, 8))
    w1, w2 = _t(_np(72, 8, 16, scale=0.3)), _t(_np(73, 16, 8, scale=0.3))
    s, b, b1 = _t(_np(74, 8, shift=1.0)), _t(_np(75, 8)), _t(_np(76, 16))
    with_res = ln_mlp_residual_bwd(dy, x1, s, b, w1, b1, w2, EPS)
    without = ln_mlp_residual_bwd(dy, x1, s, b, w1, b1, w2, EPS, residual=False)
    torch.testing.assert_close(without[0], with_res[0] - dy, rtol=0, atol=1e-6)
    for a, c in zip(without[1:], with_res[1:]):
        torch.testing.assert_close(a, c, rtol=0, atol=0)


def test_split_backward_cpu_wrappers_run_the_twins():
    rows, d, f = 9, 64, 128
    dy, x1, ctx = _t(_np(60, rows, d)), _t(_np(61, rows, d)), _t(_np(62, rows, d))
    s, b = _t(_np(63, d, shift=1.0)), _t(_np(64, d))
    w1, b1, w2 = _t(_np(65, d, f, scale=0.1)), _t(_np(66, f)), _t(_np(67, f, d, scale=0.1))
    wo = _t(_np(68, d, d, scale=0.1))
    counts = (ln_mlp_residual_bwd.launches, out_residual_bwd.launches)
    for a, c in zip(ln_mlp_residual_bwd(dy, x1, s, b, w1, b1, w2, EPS),
                    ln_mlp_residual_bwd_plain(dy, x1, s, b, w1, b1, w2, EPS)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    for a, c in zip(out_residual_bwd(dy, ctx, wo), out_residual_bwd_plain(dy, ctx, wo)):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    assert (ln_mlp_residual_bwd.launches, out_residual_bwd.launches) == counts


@pytest.mark.parametrize("kernel", ["flash_fwd", "flash_bwd", "k8", "k9"])
def test_new_wrappers_refuse_other_devices(kernel):
    # a non-CPU tensor either launches the kernel or raises; never the twin
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    calls = {
        "flash_fwd": lambda: flash_attention_fwd(m(1, 2, 8, 16), m(1, 2, 8, 16), m(1, 2, 8, 16)),
        "flash_bwd": lambda: flash_attention_bwd(*(m(1, 2, 8, 16) for _ in range(4)), m(1, 2, 8),
                                                 m(1, 2, 8, 16)),
        "k8": lambda: ln_mlp_residual_bwd(m(4, 8), m(4, 8), m(8), m(8), m(8, 16), m(16),
                                          m(16, 8), EPS),
        "k9": lambda: out_residual_bwd(m(4, 8), m(4, 8), m(8, 8)),
    }
    with pytest.raises(ValueError, match="CUDA or CPU"):
        calls[kernel]()


# -- the long blocks and the whole model, switch lowered in both packages -------


@pytest.fixture
def long_route(monkeypatch):
    """Route every T > 4 through the long-sequence blocks in both packages."""
    monkeypatch.setattr(JF, "VMEM_ATTENTION_MAX_T", 4)
    monkeypatch.setattr(TF, "VMEM_ATTENTION_MAX_T", 4)


def _block(d, f, seed):
    keys = ("ln1_scale", "ln1_bias", "wqkv", "bqkv", "wo", "bo",
            "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2")
    shapes = ((d,), (d,), (d, 3 * d), (3 * d,), (d, d), (d,), (d,), (d,), (d, f), (f,), (f, d), (d,))
    out = {}
    for i, (key, shape) in enumerate(zip(keys, shapes)):
        scale = shape[0] ** -0.5 if len(shape) == 2 else 0.2
        out[key] = _np(seed + i, *shape, scale=scale, shift=1.0 if "scale" in key else 0.0)
    return out


@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_long_inference_block_matches_pallas(long_route, variant):
    b, t, d, f, heads = 2, 5, 64, 256, 4
    x, blk = _np(70, b * t, d), _block(d, f, 71)
    want = JF.fused_encoder_block(jnp.asarray(x), jax.tree.map(jnp.asarray, blk), heads, t, EPS,
                                  variant, interpret=True)
    got = TF.fused_encoder_block(_t(x), {k: _t(v) for k, v in blk.items()}, heads, t, EPS, variant)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_long_trainable_block_grads_match_jax(long_route, variant):
    b, t, d, f, heads = 3, 5, 64, 256, 4
    x, weight, blk = _np(80, b * t, d, scale=0.5), _np(81, b * t, d), _block(d, f, 82)

    def jloss(xj, bj):
        return jnp.sum(JT.encoder_block_trainable(xj, bj, heads, t, EPS, variant) * weight)

    jgx, jgb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(x), jax.tree.map(jnp.asarray, blk))
    xt = _t(x).requires_grad_(True)
    bt = {k: _t(v).requires_grad_(True) for k, v in blk.items()}
    (TT.encoder_block_trainable(xt, bt, heads, t, EPS, variant) * _t(weight)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4, rtol=1e-4)
    got = {k: v.grad.numpy() for k, v in bt.items()}
    assert _max_leaf_diff(got, _jtree(jgb)) <= 1e-4


def test_long_trainable_block_bias_grads_keep_their_dtype(long_route):
    # the trap tests/test_trainable_fused.py guards in JAX: a bias gradient
    # returned in fp32 for a bf16 bias
    b, t, d, f, heads = 2, 5, 64, 128, 4
    x = torch.from_numpy(_np(90, b * t, d)).bfloat16().requires_grad_(True)
    bt = {k: torch.from_numpy(v).bfloat16().requires_grad_(True)
          for k, v in _block(d, f, 91).items()}
    TT.encoder_block_trainable(x, bt, heads, t, EPS).float().sum().backward()
    assert x.grad.dtype == torch.bfloat16
    for k, v in bt.items():
        assert v.grad is not None and v.grad.dtype == torch.bfloat16, k


@pytest.fixture(scope="module")
def jparams(tiny_cfg):
    return _jtree(jvit.init_params(jax.random.key(5), tiny_cfg))


def test_long_model_logits_match_jax(long_route, tiny_cfg, jparams):
    x = np.random.default_rng(5).normal(size=(2, 3, 32, 32)).astype(np.float32)
    want = jvit.forward(jax.tree.map(jnp.asarray, jparams), jnp.asarray(x), tiny_cfg,
                        jget_ops("fused"))
    got = tvit.forward(params_from_numpy(jparams, "cpu"), torch.from_numpy(x), tiny_cfg,
                       get_ops("fused"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_long_model_sgd_step_matches_jax(long_route, tiny_cfg, jparams):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 3, 32, 32)).astype(np.float32)
    y = rng.integers(0, tiny_cfg.num_classes, 3).astype(np.int32)
    opt = optax.sgd(0.05)
    params = jax.tree.map(jnp.asarray, jparams)
    jstep = jtrainer.make_train_step(tiny_cfg, opt, jget_ops("fused_train"), remat=False)
    jp, _, jl = jax.jit(jstep)(params, opt.init(params), jnp.asarray(x), jnp.asarray(y))

    tp = ttrainer.as_trainable(params_from_numpy(jparams, "cpu"), "cpu")
    topt = torch.optim.SGD(list(ttrainer.leaves(tp)), lr=0.05)
    tstep = ttrainer.make_train_step(tiny_cfg, topt, get_ops("fused_train"), remat=False)
    tl = float(tstep(tp, torch.from_numpy(x), torch.from_numpy(y)))
    assert abs(tl - float(jl)) <= 1e-5
    assert _max_leaf_diff(params_to_numpy(tp), _jtree(jp)) <= 1e-4


def test_regularized_block_still_raises_past_the_switch(long_route):
    blk = {k: _t(v) for k, v in _block(64, 128, 95).items()}
    with pytest.raises(ValueError, match="seq_len <= 4"):
        TT.encoder_block_train(torch.zeros(10, 64), blk, 4, 5, EPS, "exact", 1, 0.1, 0.1)
