"""Token merging (ToMe) in the port against the JAX package on the CPU:
``ops/tome.py`` (schedules, the merge matrix, the gather/scatter merge),
the hooks of K1/K15/K6 (the log-size bias on the key logits, the mean key
over heads, K6 without the residual join) and the K12b/K12c twins against
the Pallas kernels in interpret mode, the ToMe forwards (``fused``,
``quant``, ``eager``), ``InferenceEngine(tome_r=...)`` and ``vit-tpu-torch
--tome``.  Training with merging is ``test_torch_tome_train.py``.

The matching is discrete: a metric that differs in its last bit between
the packages could rank another pair first, and the outputs would then
differ by a whole token.  So every forward comparison first asserts, on
the port's own metrics, that each merge's choice has a margin above
``MARGIN``: the gap between the r-th and (r+1)-th best score, and each
merging token's best score over its runner-up.  A flip then fails as a
margin, not as a wrong logit.

Tolerances: schedules equal; the merge matrix and sizes 1e-5 (sums of
small integers: exact in practice); ctx 1e-4, k-mean 1e-5 and gradients
1e-4 (absolute and relative), the JAX package's own bars for its hooked
kernel (tests/test_tome.py); the K12b/K12c twins as the K12a twin's
(test_torch_regularized.py); logits 2e-4 (tests/test_tome.py's bar for
fused against its oracle).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops.pallas.backward as JB
import vit_tpu.ops.pallas.fused_block as JF
import vit_tpu.ops.pallas.quant_kernels as JK
from vit_tpu.config import DEIT_B_16 as J_DEIT_B_16
from vit_tpu.config import VIT_B_16 as J_VIT_B_16
from vit_tpu.config import VIT_L_16 as J_VIT_L_16
from vit_tpu.models import tome as jtome_model
from vit_tpu.models import vit as jvit
from vit_tpu.ops import quant as JQ
from vit_tpu.ops import tome as jtome
from vit_tpu_torch.eval import tome_stages
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import tome as ttome_model
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops import quant as TQ
from vit_tpu_torch.ops import tome as ttome
from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd_train as K12B
from vit_tpu_torch.ops.kernels import ln_qkv_attn as K1
from vit_tpu_torch.ops.kernels import ln_qkv_attn_bwd as K6
from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as K15
from vit_tpu_torch.ops.kernels import out_residual_bwd_train as K12C
from vit_tpu_torch.runtime.engine import InferenceEngine

EPS = 1e-6
MARGIN = 1e-5
BIG_SEED = 2 ** 31 + 77


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


@pytest.fixture(scope="module")
def cfg(tiny_cfg):
    # tiny_cfg's widths at 65 tokens and three layers, so the schedules merge
    # (tests/test_tome.py's configuration)
    return dataclasses.replace(tiny_cfg, depth=3, image_size=64, patch_size=8,
                               name="vit_tome_test")


@pytest.fixture(scope="module")
def jparams(cfg):
    return jax.tree.map(lambda a: np.array(a, np.float32), jvit.init_params(jax.random.key(0), cfg))


@pytest.fixture(scope="module")
def images(cfg):
    return np.random.default_rng(3).normal(size=(2, 3, 64, 64)).astype(np.float32)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


# -- ops/tome.py ----------------------------------------------------------------


@pytest.mark.parametrize("jcfg", [J_VIT_B_16, J_VIT_L_16, J_DEIT_B_16], ids=["b16", "l16", "deit"])
@pytest.mark.parametrize("r", [13, 14, 16])
def test_schedules_match_jax(jcfg, r):
    p = jcfg.num_prefix_tokens
    for chunk in (1, 2, 3):
        want = jtome_model.schedule(jcfg, r, chunk)
        got = ttome_model.schedule(jcfg, r, chunk)
        assert got == want
        assert ttome.merge_counts(jcfg.seq_len, jcfg.depth, r, p) == jtome.merge_counts(
            jcfg.seq_len, jcfg.depth, r, p)
    assert ttome_model.MERGE_CHUNK == jtome_model.MERGE_CHUNK
    assert ttome_model.TRAIN_MERGE_CHUNK == jtome_model.TRAIN_MERGE_CHUNK
    with pytest.raises(ValueError, match="pairs but only"):
        ttome.validate_counts([40, 40], 65, p)


@pytest.mark.parametrize("protected", [1, 2])
@pytest.mark.parametrize("t", [65, 64])
def test_merge_matrix_and_merge_tokens_match_jax(protected, t):
    b, d, r = 3, 16, 7
    x, metric = _np(1, b, t, d), _np(2, b, t, 8)
    size = np.random.default_rng(3).integers(1, 5, size=(b, t)).astype(np.float32)
    jw, js = jtome.merge_matrix(jnp.asarray(metric), jnp.asarray(size), r, protected)
    tw, ts = ttome.merge_matrix(torch.from_numpy(metric), torch.from_numpy(size), r, protected)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-5, rtol=0)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    jx, jsz = jtome.merge_tokens(jnp.asarray(x), jnp.asarray(metric), jnp.asarray(size), r,
                                 protected)
    tx, tsz = ttome.merge_tokens(torch.from_numpy(x), torch.from_numpy(metric),
                                 torch.from_numpy(size), r, protected)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tsz.numpy(), np.asarray(jsz), atol=1e-5, rtol=0)
    # the GEMM form is the gather/scatter form
    np.testing.assert_allclose(ttome.apply_merge_matrix(torch.from_numpy(x), tw, ts).numpy(),
                               tx.numpy(), atol=1e-5, rtol=0)
    # the protected prefix never merges, and the sizes are conserved
    np.testing.assert_array_equal(tx[:, :protected].numpy(), x[:, :protected])
    np.testing.assert_allclose(tsz.sum(-1).numpy(), size.sum(-1), rtol=1e-6)


def test_ties_resolve_as_jax():
    # equal scores everywhere: the first maximum and a stable ranking
    b, t, r = 2, 17, 3
    metric = np.ones((b, t, 4), np.float32)
    size = np.ones((b, t), np.float32)
    jw, _ = jtome.merge_matrix(jnp.asarray(metric), jnp.asarray(size), r, 1)
    tw, _ = ttome.merge_matrix(torch.from_numpy(metric), torch.from_numpy(size), r, 1)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    with pytest.raises(ValueError, match="r > 0"):
        ttome.merge_matrix(torch.from_numpy(metric), torch.from_numpy(size), 0)


# -- the kernels' hooks and K12b/K12c --------------------------------------------


def _k1_arrays(b, t, d, seed):
    return [_np(seed, b * t, d, scale=0.5), _np(seed + 1, d, scale=0.2, shift=1.0),
            _np(seed + 2, d, scale=0.2), _np(seed + 3, d, 3 * d, scale=d ** -0.5),
            _np(seed + 4, 3 * d, scale=0.1)]


def _log_size(b, t, seed=9):
    return np.log(np.random.default_rng(seed).integers(1, 6, size=(b, t))).astype(np.float32)


@pytest.mark.parametrize("b,t", [(2, 65), (3, 41)], ids=["t65", "ragged_t41"])
def test_k1_hooks_twin_matches_pallas(b, t):
    d, h = 64, 4
    arrays, ls = _k1_arrays(b, t, d, 10), _log_size(b, t)
    want_ctx, want_k = JF.ln_qkv_attn(*map(jnp.asarray, arrays), h, t, EPS, interpret=True,
                                      log_size=jnp.asarray(ls), return_kmean=True)
    ctx, kmean = K1.ln_qkv_attn(*map(torch.from_numpy, arrays), h, t, EPS,
                                log_size=torch.from_numpy(ls), return_kmean=True)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=1e-4, rtol=0)
    np.testing.assert_allclose(kmean.numpy(), np.asarray(want_k), atol=1e-5, rtol=0)
    # the eager reference's hooks, as tests/test_tome.py holds the JAX ones
    from vit_tpu_torch.ops import reference as R

    x, s, bias, wqkv, bqkv = map(torch.from_numpy, arrays)
    ln = R.layer_norm(x.reshape(b, t, d), s, bias, EPS)
    ref_ctx, ref_k = R.attention(ln, wqkv, bqkv, torch.eye(d), torch.zeros(d), h,
                                 logit_bias=torch.from_numpy(ls), return_kmean=True)
    np.testing.assert_allclose(ref_ctx.reshape(b * t, d).numpy(), np.asarray(want_ctx),
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(ref_k.reshape(b * t, -1).numpy(), np.asarray(want_k), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("b,t", [(2, 65), (3, 41)], ids=["t65", "ragged_t41"])
def test_k15_hooks_twin_matches_pallas(b, t):
    d, h = 64, 4
    x, s, bias, w, bqkv = _k1_arrays(b, t, d, 20)
    ls = _log_size(b, t)
    wq, ws = JQ.quantize_weight(jnp.asarray(w))
    want_ctx, want_k = JK.ln_qkv_attn_q8(jnp.asarray(x), jnp.asarray(s), jnp.asarray(bias), wq, ws,
                                         jnp.asarray(bqkv), h, t, EPS, interpret=True,
                                         log_size=jnp.asarray(ls), return_kmean=True)
    ctx, kmean = K15.ln_qkv_attn_q8(
        *map(torch.from_numpy, (x, s, bias)), torch.from_numpy(np.array(wq)),
        torch.from_numpy(np.array(ws)), torch.from_numpy(bqkv), h, t, EPS,
        log_size=torch.from_numpy(ls), return_kmean=True)
    np.testing.assert_allclose(ctx.numpy(), np.asarray(want_ctx), atol=1e-4, rtol=0)
    np.testing.assert_allclose(kmean.numpy(), np.asarray(want_k), atol=1e-5, rtol=0)


@pytest.mark.parametrize("b,t", [(2, 65), (3, 41)], ids=["t65", "ragged_t41"])
def test_k6_log_size_without_dres_twin_matches_pallas(b, t):
    d, h = 64, 4
    arrays, ls = _k1_arrays(b, t, d, 30), _log_size(b, t)
    dctx = _np(40, b * t, d)
    want = JB.ln_qkv_attn_bwd(jnp.asarray(dctx), None, *map(jnp.asarray, arrays), h, t, EPS,
                              interpret=True, log_size=jnp.asarray(ls))
    got = K6.ln_qkv_attn_bwd(torch.from_numpy(dctx), None, *map(torch.from_numpy, arrays), h, t,
                             EPS, log_size=torch.from_numpy(ls))
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w).reshape(g.shape), atol=1e-4,
                                   rtol=1e-4, err_msg=f"output {i}")


def _pairs(arrays, dtype):
    return ([jnp.asarray(a).astype(dtype) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _close(got, want, dtype):
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _f32(g), _f32(w).reshape(g.shape)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=f"output {i}")
        else:
            assert np.abs(g - w).max() <= 2e-2 * np.abs(w).max(), f"output {i}"


def _dp(seed, site, rows, t, rate):
    return (JF.drop_path_scale_rows(jnp.uint32(seed), site, rows // t, t, rate),
            torch.from_numpy(np.array(JF.drop_path_scale_rows(
                jnp.uint32(seed), site, rows // t, t, rate)).reshape(-1)))


# merged and ragged row counts: three images of a 41-token layer (123 rows,
# not a multiple of the Pallas kernels' row blocks), and 57-token layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("rows,t", [(123, 41), (114, 57)], ids=["b3_t41", "b2_t57"])
def test_k12b_k12c_twins_match_pallas(dtype, p, rows, t):
    d, f = 64, 256
    dy, x1, ctx = _np(50, rows, d), _np(51, rows, d, scale=2.0), _np(52, rows, d)
    s, bias = _np(53, d, scale=0.2, shift=1.0), _np(54, d, scale=0.2)
    w1, b1, w2 = _np(55, d, f, scale=d ** -0.5), _np(56, f, scale=0.1), _np(57, f, d, scale=f ** -0.5)
    wo = _np(58, d, d, scale=d ** -0.5)
    jdpm, tdpm = _dp(3, 5, rows, t, 0.3)
    jdpa, tdpa = _dp(3, 4, rows, t, 0.3)
    j12b, t12b = _pairs([dy, x1, s, bias, w1, b1, w2], dtype)
    want = JB.ln_mlp_residual_bwd_train(*j12b, jdpm, jnp.uint32(BIG_SEED), p, EPS, "exact",
                                        block_rows=32, interpret=True)
    got = K12B.ln_mlp_residual_bwd_train(*t12b, tdpm, BIG_SEED, p, EPS, "exact")
    assert got[0].dtype == getattr(torch, dtype) and all(g.dtype == torch.float32 for g in got[1:])
    _close(got, want, dtype)
    j12c, t12c = _pairs([dy, ctx, wo], dtype)
    want = JB.out_residual_bwd_train(*j12c, jdpa, jnp.uint32(BIG_SEED), p, block_rows=32,
                                     interpret=True)
    got = K12C.out_residual_bwd_train(*t12c, tdpa, BIG_SEED, p)
    assert got[0].dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_k12b_k12c_twins_at_zero_rates_are_k8_k9():
    from vit_tpu_torch.ops.kernels.ln_mlp_residual_bwd import ln_mlp_residual_bwd
    from vit_tpu_torch.ops.kernels.out_residual_bwd import out_residual_bwd

    rows, d, f = 30, 64, 256
    dy, x1, ctx = (torch.from_numpy(_np(60 + i, rows, d)) for i in range(3))
    s, bias = torch.from_numpy(_np(63, d, shift=1.0)), torch.from_numpy(_np(64, d))
    w1, b1 = torch.from_numpy(_np(65, d, f, scale=0.1)), torch.from_numpy(_np(66, f))
    w2, wo = torch.from_numpy(_np(67, f, d, scale=0.1)), torch.from_numpy(_np(68, d, d))
    ones = torch.ones(rows)
    for a, b in zip(K12B.ln_mlp_residual_bwd_train(dy, x1, s, bias, w1, b1, w2, ones, 5, 0.0, EPS),
                    ln_mlp_residual_bwd(dy, x1, s, bias, w1, b1, w2, EPS)):
        assert torch.equal(a, b)
    for a, b in zip(K12C.out_residual_bwd_train(dy, ctx, wo, ones, 5, 0.0),
                    out_residual_bwd(dy, ctx, wo)):
        assert torch.equal(a, b)


# -- the forwards ----------------------------------------------------------------


def assert_margins(metrics, counts, protected=1, margin=MARGIN):
    """Each merge's matching on ``metrics`` has a margin above ``margin``
    (the module docstring)."""
    merging = [c for c in counts if c > 0]
    assert len(metrics) == len(merging)
    for metric, r in zip(metrics, merging):
        mr = metric[:, protected:].double()
        mr = mr / (mr.norm(dim=-1, keepdim=True) + 1e-6)
        scores = mr[:, 0::2] @ mr[:, 1::2].transpose(-1, -2)
        top2 = scores.topk(2, dim=-1).values
        best = top2[..., 0].sort(dim=-1, descending=True).values
        assert (best[:, r - 1] - best[:, r]).min().item() > margin, "ranking margin"
        src = top2[..., 0].argsort(dim=-1, descending=True)[:, :r]
        gap = (top2[..., 0] - top2[..., 1]).gather(1, src)
        assert gap.min().item() > margin, "argmax margin"


def _port_tree(jparams, quantized=False):
    tree = params_from_numpy(jparams, "cpu")
    return TQ.quantize_params(tree) if quantized else tree


@pytest.mark.parametrize("r", [0, 4])
def test_forwards_match_jax(cfg, jparams, images, r):
    x = torch.from_numpy(images)
    tree = _port_tree(jparams)
    with torch.no_grad():
        fused, metrics = tome_stages.kernel_metrics(ttome_model.forward_fused, tree, x, cfg, r)
        eager = ttome_model.forward_eager(tree, x, cfg, r)
    assert_margins(metrics, ttome_model.schedule(cfg, r))
    jx = jnp.asarray(images)
    np.testing.assert_allclose(
        fused.numpy(), np.asarray(jtome_model.forward_fused(_j(jparams), jx, cfg, r)), atol=2e-4,
        rtol=0)
    np.testing.assert_allclose(
        eager.numpy(), np.asarray(jtome_model.forward_xla(_j(jparams), jx, cfg, r)), atol=2e-4,
        rtol=0)
    if r == 0:  # no merge: the plain eager forward, bit for bit
        assert torch.equal(eager, tvit.forward(tree, x, cfg))


def test_quant_forward_matches_jax(cfg, jparams, images):
    x = torch.from_numpy(images)
    qtree = _port_tree(jparams, quantized=True)
    with torch.no_grad():
        got, metrics = tome_stages.kernel_metrics(ttome_model.forward_quant, qtree, x, cfg, 4)
        plain = ttome_model.forward_quant(qtree, x, cfg, 0)
        from vit_tpu_torch.ops.dispatch import get_ops

        # r = 0 is the plain quant forward up to its final LayerNorm's form
        np.testing.assert_allclose(plain.numpy(), tvit.forward(qtree, x, cfg,
                                                               get_ops("quant")).numpy(),
                                   atol=1e-5, rtol=0)
    assert_margins(metrics, ttome_model.schedule(cfg, 4))
    jq = JQ.quantize_params(_j(jparams))
    want = jtome_model.forward_quant(jq, jnp.asarray(images), cfg, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)


def test_check_config_and_distilled_prefix(cfg, jparams):
    from vit_tpu_torch.ops import fused_block

    with pytest.raises(ValueError, match=">= 0"):
        ttome_model.check_config(cfg, -1)
    long = dataclasses.replace(cfg, image_size=264)  # 1,090 tokens
    with pytest.raises(ValueError, match="seq_len <= 1024"):
        ttome_model.check_config(long, 4)
    dcfg = dataclasses.replace(cfg, distilled=True)
    djp = jax.tree.map(lambda a: np.array(a, np.float32), jvit.init_params(jax.random.key(2), dcfg))
    imgs = np.random.default_rng(4).normal(size=(2, 3, 64, 64)).astype(np.float32)
    with torch.no_grad():
        got = ttome_model.forward_eager(_port_tree(djp), torch.from_numpy(imgs), dcfg, 4)
    want = jtome_model.forward_xla(_j(djp), jnp.asarray(imgs), dcfg, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    assert fused_block.VMEM_ATTENTION_MAX_T == 1024


# -- the engine and the classify CLI ---------------------------------------------


def test_engine_tome_labels_match_jax(cfg, jparams, images):
    from vit_tpu.runtime import InferenceEngine as JEngine

    for ops, jops in (("fused", "fused"), ("quant", "quant"), ("eager", "xla")):
        eng = InferenceEngine(cfg, jparams, dtype="float32", ops=ops, device="cpu", batch_pad=2,
                              tome_r=4)
        labels, top = eng.classify(images)
        jlabels, jtop = JEngine(cfg, _j(jparams), dtype="float32", ops=jops, batch_pad=2,
                                tome_r=4).classify(images)
        np.testing.assert_array_equal(labels, np.asarray(jlabels))
        np.testing.assert_allclose(top, np.asarray(jtop), atol=1e-5)
    with pytest.raises(ValueError, match="features"):
        eng.features(images)
    with pytest.raises(ValueError, match="tome_r"):
        InferenceEngine(cfg, jparams, ops="fused_train", device="cpu", tome_r=4)
    plain = InferenceEngine(cfg, jparams, dtype="float32", ops="fused", device="cpu", batch_pad=2)
    zero = InferenceEngine(cfg, jparams, dtype="float32", ops="fused", device="cpu", batch_pad=2,
                           tome_r=0)
    assert torch.equal(zero.logits(images), plain.logits(images))


def _cli_lines(out):
    return [line for line in out.splitlines() if line.startswith("[")]


def test_classify_cli_tome_matches_jax(cfg, jparams, monkeypatch, capsys, tmp_path):
    import vit_tpu.config as jconfig
    import vit_tpu_torch.config as tconfig
    from vit_tpu.cli.main import main as jmain
    from vit_tpu.io import checkpoint as jckpt
    from vit_tpu_torch.cli.main import main as tmain

    monkeypatch.setitem(jconfig.CONFIGS, cfg.name, cfg)
    monkeypatch.setitem(tconfig.CONFIGS, cfg.name, cfg)
    jckpt.save_npz(jparams, tmp_path / "w.npz")
    base = ["--config", cfg.name, "--weights", str(tmp_path / "w.npz"), "--synth", "2",
            "--dtype", "float32", "--tome", "4"]
    for ops, jops in (("fused", "fused"), ("quant", "quant")):
        assert tmain(base + ["--ops", ops, "--device", "cpu"]) == 0
        got = _cli_lines(capsys.readouterr().out)
        assert jmain(base + ["--ops", jops, "--no-compile-cache"]) == 0
        want = _cli_lines(capsys.readouterr().out)
        assert len(got) == 2
        assert [line.split("   ")[0] for line in got] == [line.split("   ")[0] for line in want]
    # refusals: a negative r, before the weights load
    for main, extra in ((tmain, ["--device", "cpu"]), (jmain, ["--no-compile-cache"])):
        assert main([*base[:-1], "-4", "--ops", "fused", *extra]) == 2
        assert ">= 0" in capsys.readouterr().err
