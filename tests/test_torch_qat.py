"""Quantization-aware training in the port (``ops/qat.py``, ``get_ops("qat")``,
``InferenceEngine(ops="qat")`` and ``vit-tpu-torch-train --ops qat``)
against the JAX package's ``vit_tpu.ops.qat`` on the CPU.

QAT is discrete: ``round(x / scale)`` flips a code by one wherever torch and
XLA sum a LayerNorm or a GEMM in another order and x / scale lay within a
few ulps of a half-integer — and torch's CPU GEMMs sum in an order that
moves with the machine's load, so even two runs of the port can differ.  So
it is compared stage by stage:

  - the fake-quant functions on the same fp32 input: values equal bit for
    bit (an fp32 divide, round-half-to-even, a clip), and their
    straight-through gradients too (the clip's even split on a bound
    included);
  - everywhere else, with a flip budget: both packages' activation
    quantizers record the int8 codes of their inputs (``_recorded``), every
    code within 1 of the other package's and at most ``FLIP_SHARE`` of a
    quantization point's codes different, counted as
    ``eval/quant_stages.py`` counts (at these widths: one code of a
    1,280-code point); the outputs at the fp32 tolerance where no code
    moved — ``attention_qat``, ``mlp_qat`` and each QAT block on the JAX
    package's input 1e-5, gradients 1e-4 x max(1, max|g|) per leaf
    (``tests/test_torch_train.py``'s fp32 bar) — and within a few code
    steps where one did (2^-6 of the largest, ``test_torch_quant.py``'s
    STEP_RTOL).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops.qat as JQAT
import vit_tpu.ops.reference as JREF
import vit_tpu_torch.ops.qat as TQAT
import vit_tpu_torch.ops.reference as TREF
from vit_tpu.io import checkpoint as ckpt
from vit_tpu.io import weights as wio
from vit_tpu.models import vit as jvit
from vit_tpu.runtime import trainer as jtrainer
from vit_tpu_torch.eval.quant_stages import FLIP_SHARE
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops import quant as TQ
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.runtime import trainer as ttrainer
from vit_tpu_torch.runtime.engine import InferenceEngine

STEP_RTOL = 2.0 ** -6


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def tree(tiny_cfg):
    return wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=1), tiny_cfg)


@pytest.fixture(scope="module")
def batch(tiny_cfg):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3, tiny_cfg.image_size, tiny_cfg.image_size)).astype(np.float32)
    return x, rng.integers(0, tiny_cfg.num_classes, 4).astype(np.int32)


def _leaf_grads(tree):
    return {k: _leaf_grads(v) if isinstance(v, dict) else v.grad.numpy() for k, v in tree.items()}


def _assert_grads(got, want, rtol):
    for k in want:
        if isinstance(want[k], dict):
            _assert_grads(got[k], want[k], rtol)
            continue
        w = np.asarray(want[k], np.float32)
        err = np.abs(got[k] - w).max()
        assert err <= rtol * max(1.0, np.abs(w).max()), (k, err)


def _recording(inner, codes: list, to_torch):
    """``inner`` (a fake_quant_act) that also appends its input's int8 codes
    (``ops/quant.quantize_activations``' rule) to ``codes``."""
    def fn(x):
        codes.append(TQ.quantize_activations(to_torch(x))[0].numpy())
        return inner(x)
    return fn


def _recorded(monkeypatch, run_torch, run_jax):
    """``run_torch()`` and ``run_jax()`` (op by op: no jit, no scan) with each
    package's activation fake quantizer recording its inputs' codes ->
    (torch result, JAX result, |code difference| per quantization point)."""
    tcodes, jcodes = [], []
    t_fq, j_fq = TQAT.fake_quant_act, JQAT.fake_quant_act
    monkeypatch.setattr(TQAT, "fake_quant_act", _recording(t_fq, tcodes, lambda v: v.detach()))
    monkeypatch.setattr(JQAT, "fake_quant_act", _recording(
        j_fq, jcodes, lambda v: torch.from_numpy(np.array(v))))
    try:
        got, want = run_torch(), run_jax()
    finally:
        monkeypatch.setattr(TQAT, "fake_quant_act", t_fq)
        monkeypatch.setattr(JQAT, "fake_quant_act", j_fq)
    assert len(tcodes) == len(jcodes) > 0
    return got, want, [np.abs(a.astype(np.int32) - b.astype(np.int32))
                       for a, b in zip(tcodes, jcodes)]


def _moved(steps) -> bool:
    """The flip budget (module docstring); True when some code moved."""
    for s in steps:
        assert s.max() <= 1 and (s != 0).mean() <= FLIP_SHARE, (s.max(), (s != 0).sum())
    return any(s.any() for s in steps)


def _assert_close(got, want, steps, tol=1e-5):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bound = STEP_RTOL * max(1.0, np.abs(want).max()) if _moved(steps) else tol
    np.testing.assert_allclose(got, want, atol=bound, rtol=0)


# -- the straight-through round and the fake quantizers ------------------------


def test_ste_round_identity_gradient():
    x = torch.from_numpy(_np(0, 16)).requires_grad_(True)
    y = TQAT.ste_round(x * 3.0)
    y.sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.full(16, 3.0, np.float32))
    np.testing.assert_array_equal(y.detach().numpy(), np.round(x.detach().numpy() * 3.0))
    # round half to even, as jnp.round
    halves = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])
    np.testing.assert_array_equal(TQAT.ste_round(halves).numpy(),
                                  np.asarray(JQAT.ste_round(jnp.asarray(halves.numpy()))))


@pytest.mark.parametrize("fn", ["act", "weight"])
@pytest.mark.parametrize("shape", [(5, 32), (3, 7, 64), (64, 192)])
def test_fake_quant_codes_values_and_grads_equal_jax(fn, shape):
    x = _np(len(shape) + shape[-1], *shape, scale=2.0)
    x.reshape(-1)[3] = 0.0
    if fn == "act":
        x[..., 1, :] = 0.0  # an all-zero row: the 1e-12 scale floor
    tfn = TQAT.fake_quant_act if fn == "act" else TQAT.fake_quant_weight
    jfn = JQAT.fake_quant_act if fn == "act" else JQAT.fake_quant_weight
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tfn(xt)
    want = np.asarray(jfn(jnp.asarray(x)))
    np.testing.assert_array_equal(got.detach().numpy(), want)
    # the values are the W8A8 quantizer's codes times its scales, bit for bit
    if fn == "act":
        q, s = TQ.quantize_activations(torch.from_numpy(x))
        deq = q.float() * s[..., None]
    else:
        q, s = TQ.quantize_weight(torch.from_numpy(x))
        deq = q.float() * s
    np.testing.assert_array_equal(got.detach().numpy(), deq.numpy())
    weight = _np(9, *shape)
    (got * torch.from_numpy(weight)).sum().backward()
    jg = jax.grad(lambda v: jnp.sum(jfn(v) * weight))(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))


def test_fake_quant_keeps_bf16():
    x = torch.from_numpy(_np(3, 6, 32)).to(torch.bfloat16)
    got = TQAT.fake_quant_act(x)
    assert got.dtype == torch.bfloat16
    want = np.asarray(JQAT.fake_quant_act(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)))
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


def _attn_args(b, t, d):
    return (_np(1, b, t, d), _np(2, d, 3 * d, scale=d ** -0.5), _np(3, 3 * d, scale=0.1),
            _np(4, d, d, scale=d ** -0.5), _np(5, d, scale=0.1))


def _mlp_args(b, t, d, f):
    return (_np(6, b, t, d), _np(7, d, f, scale=d ** -0.5), _np(8, f, scale=0.1),
            _np(9, f, d, scale=f ** -0.5), _np(10, d, scale=0.1))


def test_attention_qat_matches_jax(monkeypatch):
    args = _attn_args(3, 5, 64)
    got, want, steps = _recorded(
        monkeypatch, lambda: TQAT.attention_qat(*map(torch.from_numpy, args), 4),
        lambda: JQAT.attention_qat(*map(jnp.asarray, args), 4))
    assert not any(s.any() for s in steps)  # its one quantizer reads the input itself
    _assert_close(got, want, steps)


@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("dropout", [False, True], ids=["plain", "inner_dropout"])
def test_mlp_qat_matches_jax(variant, dropout, monkeypatch):
    args = _mlp_args(3, 5, 64, 256)
    kw_t = kw_j = {}
    if dropout:
        # one numpy mask patched into both packages' dropout (their draws
        # cannot match), so the fake quantizer after it sees the same input
        keep = np.random.default_rng(11).random((3, 5, 256)) >= 0.25
        monkeypatch.setattr(TREF, "dropout", lambda x, rate, gen: torch.where(
            torch.from_numpy(keep), x / (1.0 - rate), torch.zeros((), dtype=x.dtype)))
        monkeypatch.setattr(JREF, "dropout", lambda x, rate, rng: jnp.where(
            keep, x / (1.0 - rate), 0.0).astype(x.dtype))
        kw_t, kw_j = {"inner_dropout": (None, 0.25)}, {"inner_dropout": (None, 0.25)}
    got, want, steps = _recorded(
        monkeypatch, lambda: TQAT.mlp_qat(*map(torch.from_numpy, args), variant, **kw_t),
        lambda: JQAT.mlp_qat(*map(jnp.asarray, args), variant, **kw_j))
    assert len(steps) == 2
    _assert_close(got, want, steps)


def test_qat_mlp_equals_w8a8_reference(monkeypatch):
    # the deployed int8 GEMM composition on the same weights: the same
    # codes, up to FC1's fp32 summation order before the second quantizer
    x, w1, b1, w2, b2 = map(torch.from_numpy, _mlp_args(1, 7, 24, 96))
    codes = []
    monkeypatch.setattr(TQAT, "fake_quant_act", _recording(TQAT.fake_quant_act, codes,
                                                           lambda v: v.detach()))
    got = TQAT.mlp_qat(x, w1, b1, w2, b2)
    q1, q2 = TQ.quantize_weight(w1), TQ.quantize_weight(w2)
    h = TREF.gelu_exact(TQ.linear_w8a8(x, q1.w_q, q1.scale, b1))
    want = TQ.linear_w8a8(h, q2.w_q, q2.scale, b2)
    steps = [np.abs(c.astype(np.int32) - TQ.quantize_activations(v)[0].numpy())
             for c, v in zip(codes, (x, h))]
    _assert_close(got, want, steps, tol=1e-4)


# -- the table, block by block and end to end ----------------------------------


def test_qat_table():
    ops = get_ops("qat")
    assert ops is TQAT.QAT_OPS and ops.name == "qat"
    assert ops.attention is TQAT.attention_qat and ops.mlp is TQAT.mlp_qat
    assert ops.layer_norm is TREF.layer_norm and ops.patch_embed is TREF.patch_embed
    assert ops.encoder_block is None and ops.encoder_block_train is None


def _jax_qat_forward(cfg, jparams, x, acts=None):
    """The JAX package's QAT logits op by op (its blocks one by one, no
    scan), appending the activation before each block and after the last
    to ``acts``."""
    xs = JREF.patch_embed(x, jparams["patch_embed"]["kernel"], jparams["patch_embed"]["bias"],
                          cfg.patch_size)
    xs = JREF.add_cls_and_pos(xs, jvit.prefix_tokens(jparams), jparams["pos_embed"])
    for l in range(cfg.depth):
        if acts is not None:
            acts.append(np.array(xs))
        xs = jvit.encoder_block(xs, jax.tree.map(lambda a: a[l], jparams["blocks"]), cfg,
                                JQAT.QAT_OPS)
    if acts is not None:
        acts.append(np.array(xs))
    xs = JREF.layer_norm(xs, jparams["ln_final"]["scale"], jparams["ln_final"]["bias"],
                         cfg.layernorm_eps)
    return jvit.apply_head(xs, jparams)


def test_qat_blocks_on_jax_input_match(tiny_cfg, tree, batch, monkeypatch):
    acts = []
    _jax_qat_forward(tiny_cfg, jax.tree.map(jnp.asarray, tree), jnp.asarray(batch[0]), acts)
    params = params_from_numpy(tree, "cpu")
    for l, blk in enumerate(tvit.layers(params["blocks"])):
        got, want, steps = _recorded(
            monkeypatch,
            lambda: tvit.encoder_block(torch.from_numpy(acts[l]), blk, tiny_cfg, get_ops("qat")),
            lambda: jvit.encoder_block(jnp.asarray(acts[l]), jax.tree.map(
                lambda a: jnp.asarray(a[l]), tree["blocks"]), tiny_cfg, JQAT.QAT_OPS))
        np.testing.assert_array_equal(np.asarray(want), acts[l + 1])
        assert len(steps) == 3
        _assert_close(got, want, steps)


def test_qat_forward_matches_jax_with_flip_budget(tiny_cfg, tree, batch, monkeypatch):
    x = batch[0]
    jparams = jax.tree.map(jnp.asarray, tree)
    got, want, steps = _recorded(
        monkeypatch,
        lambda: tvit.forward(params_from_numpy(tree, "cpu"), torch.from_numpy(x), tiny_cfg,
                             get_ops("qat")),
        lambda: _jax_qat_forward(tiny_cfg, jparams, jnp.asarray(x)))
    assert len(steps) == 3 * tiny_cfg.depth
    _assert_close(got, want, steps)
    # the scanned JAX forward, and the quantizers do something
    _assert_close(np.asarray(jvit.forward(jparams, jnp.asarray(x), tiny_cfg, JQAT.QAT_OPS)),
                  want, [np.zeros(1)])
    assert np.abs(got.numpy() - np.asarray(jvit.forward(jparams, jnp.asarray(x),
                                                         tiny_cfg))).max() > 1e-4


def test_qat_grads_match_jax(tiny_cfg, tree, batch, monkeypatch):
    x, y = batch
    jparams = jax.tree.map(jnp.asarray, tree)

    def jloss(p):
        return jtrainer.cross_entropy_loss(_jax_qat_forward(tiny_cfg, p, jnp.asarray(x)),
                                           jnp.asarray(y))

    params = ttrainer.as_trainable(params_from_numpy(tree, "cpu"), "cpu")
    loss_fn = ttrainer._make_loss_fn(tiny_cfg, get_ops("qat"), remat=False)
    loss, jl, steps = _recorded(
        monkeypatch, lambda: loss_fn(params, torch.from_numpy(x), torch.from_numpy(y)),
        lambda: jloss(jparams))
    loss.backward()
    jg = jax.grad(jloss)(jparams)
    moved = _moved(steps)
    assert abs(loss.item() - float(jl)) <= (STEP_RTOL if moved else 1e-5)
    _assert_grads(_leaf_grads(params), jax.tree.map(np.asarray, jg),
                  STEP_RTOL if moved else 1e-4)


def test_qat_engine_matches_jax_engine(tiny_cfg, tree, batch):
    from vit_tpu.runtime.engine import InferenceEngine as JEngine

    x = batch[0]
    engine = InferenceEngine(tiny_cfg, tree, ops="qat", dtype="float32", device="cpu")
    assert engine._ops is TQAT.QAT_OPS
    got = engine.logits(x).numpy()
    want = np.asarray(JEngine(tiny_cfg, tree, ops="qat", dtype="float32").logits(x))
    # the engine's codes are not recorded (JAX's runs jitted): a few code
    # steps at most, and the decisive labels equal
    np.testing.assert_allclose(got, want, atol=STEP_RTOL * max(1.0, np.abs(want).max()), rtol=0)
    p = np.exp(want - want.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top2 = np.sort(p, -1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 0.01
    assert ((got.argmax(-1) == want.argmax(-1)) | ~decisive).all()


def test_qat_train_cli_first_loss_matches_jax(tiny_cfg, tmp_path, monkeypatch, capsys):
    import vit_tpu_torch.config as tconfig
    from vit_tpu.io.images import synth_images
    from vit_tpu_torch.cli.train import main

    monkeypatch.setitem(tconfig.CONFIGS, "vit_tiny_test", tiny_cfg)
    init = tmp_path / "p.npz"
    jparams = jvit.init_params(jax.random.key(3), tiny_cfg)
    ckpt.save_npz(jparams, str(init))
    # the CLI's synthetic batch, made as both packages' CLIs make it
    rng = np.random.default_rng(0)
    x = synth_images(4, tiny_cfg, seed=0)
    y = rng.integers(0, tiny_cfg.num_classes, 4).astype(np.int32)
    log = tmp_path / "t.jsonl"

    def run_cli():
        assert main(["--config", "vit_tiny_test", "--init-weights", str(init), "--steps", "3",
                     "--batch", "4", "--ops", "qat", "--device", "cpu",
                     "--log-jsonl", str(log)]) == 0
        return [json.loads(line)["loss"] for line in log.read_text().splitlines()]

    def jax_first_loss():
        return float(jtrainer.cross_entropy_loss(
            _jax_qat_forward(tiny_cfg, jparams, jnp.asarray(x)), jnp.asarray(y)))

    tcodes, jcodes = [], []
    monkeypatch.setattr(TQAT, "fake_quant_act", _recording(TQAT.fake_quant_act, tcodes,
                                                           lambda v: v.detach()))
    monkeypatch.setattr(JQAT, "fake_quant_act", _recording(
        JQAT.fake_quant_act, jcodes, lambda v: torch.from_numpy(np.array(v))))
    losses, want = run_cli(), jax_first_loss()
    out = capsys.readouterr().out
    assert "ops: qat" in out and "remat: True" in out
    assert len(losses) == 3 and losses[-1] < losses[0]
    # step 0's forward is the first of the CLI's recorded quantizer calls
    steps = [np.abs(a.astype(np.int32) - b.astype(np.int32))
             for a, b in zip(tcodes[: len(jcodes)], jcodes)]
    assert abs(losses[0] - want) <= (STEP_RTOL if _moved(steps) else 1e-4)


def test_qat_dropout_cli_runs(tiny_cfg, monkeypatch, capsys):
    import vit_tpu_torch.config as tconfig
    from vit_tpu_torch.cli.train import main

    monkeypatch.setitem(tconfig.CONFIGS, "vit_tiny_test", tiny_cfg)
    assert main(["--config", "vit_tiny_test", "--steps", "2", "--batch", "4", "--device", "cpu",
                 "--ops", "qat", "--dropout", "0.1", "--drop-path", "0.1"]) == 0
    out = capsys.readouterr().out
    assert "ops: qat" in out and "dropout: 0.1" in out


def test_qat_forward_is_deployable(tiny_cfg, tree, batch):
    # QAT then deploy: the qat forward against the quant table on the same
    # weights (the plain twins here), labels by the comparator rule
    x = torch.from_numpy(batch[0])
    params = params_from_numpy(tree, "cpu")
    qat = tvit.forward(params, x, tiny_cfg, get_ops("qat"))
    q8 = tvit.forward(TQ.quantize_params(params), x, tiny_cfg, get_ops("quant"))
    p = torch.softmax(qat, -1)
    top2 = p.topk(2, -1).values
    decisive = (top2[:, 0] - top2[:, 1]) > 0.01
    assert ((qat.argmax(-1) == q8.argmax(-1)) | ~decisive).all()
    assert (p.max(-1).values - torch.softmax(q8, -1).max(-1).values).abs().max() <= 0.01


def test_qat_block_applies_inner_dropout(tiny_cfg):
    # a regularized config reaches the qat blocks' inner dropout
    cfg = dataclasses.replace(tiny_cfg, dropout=0.1)
    gen = torch.Generator().manual_seed(0)
    x = torch.from_numpy(_np(3, 2, 5, 64))
    params = params_from_numpy(wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, 1),
                                                       tiny_cfg), "cpu")
    blk = tvit.layers(params["blocks"])[0]
    a = tvit.encoder_block(x, blk, cfg, get_ops("qat"), dropout_rng=gen)
    b = tvit.encoder_block(x, blk, cfg, get_ops("qat"))
    assert torch.isfinite(a).all() and not torch.equal(a, b)
