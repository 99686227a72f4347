"""The per-op kernel tier against the JAX package on the CPU: K21's and
K22's plain twins against ``attention_kernel.scaled_dot_product_attention``
and ``mlp_kernel.mlp`` in interpret mode, the per-op ``attention`` and its
route to K13 past the switch, the ``per_op`` forward against the JAX
``pallas`` forward, ``InferenceEngine(ops="per_op")`` and its
``phase_report`` against the JAX engine's, and the classify CLI's ``--ops
per_op`` and ``--profile`` with their refusals.

Inputs are made from numpy seeds and cross as numpy arrays.

Tolerances:
  - fp32: 2e-5 absolute for the attention core (tests/test_flash_attention.py's
    bar; both sides run fp32 softmax, only the summation order differs),
    1e-5 x max(1, max|value|) for the MLP and the per-op attention (fp32
    GEMMs in another order), 1e-5 absolute for logits and probabilities (as
    tests/test_torch_engine.py);
  - bf16: 2^-6 x max(1, max|value|) — both round at the same points, so they
    differ where a summation order flips a bf16 rounding (one ulp is at most
    2^-7 of the value), and two such steps are allowed.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops.pallas.fused_block as JF
from vit_tpu.io import weights as wio
from vit_tpu.io.images import synth_images
from vit_tpu.models import vit as jvit
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu.ops.pallas import attention_kernel as JAK
from vit_tpu.ops.pallas import mlp_kernel as JMK
from vit_tpu.runtime import InferenceEngine as JEngine
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops import fused_block as TF
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.ops.kernels import attention as KA
from vit_tpu_torch.ops.kernels import flash_attention as KFA
from vit_tpu_torch.ops.kernels import mlp as KM
from vit_tpu_torch.runtime.engine import InferenceEngine

BF16_TOL = 2.0 ** -6
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _close(got, want, dtype, fp32_tol):
    got = np.asarray(got.float() if torch.is_tensor(got) else got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(1.0, float(np.abs(want).max()))
    tol = BF16_TOL * scale if dtype == "bfloat16" else fp32_tol(scale)
    err = float(np.abs(got - want).max())
    assert err <= tol, f"max|d| {err} > {tol}"


def _fp32_abs(_scale):
    return 2e-5


def _fp32_rel(scale):
    return 1e-5 * scale


# -- K21: the attention core --------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 3, 29, 16), (1, 2, 29, 80)], ids=["dh16", "dh80"])
def test_sdpa_twin_matches_pallas(dtype, shape):
    jd, td = DTYPES[dtype]
    q, k, v = (_np(seed, *shape) for seed in (1, 2, 3))
    want = JAK.scaled_dot_product_attention(*(jnp.asarray(a, jd) for a in (q, k, v)),
                                            interpret=True)
    got = KA.scaled_dot_product_attention_plain(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert got.dtype == td
    _close(got, want, dtype, _fp32_abs)
    # the wrapper on CPU tensors is the twin, and counts no launch
    before = KA.scaled_dot_product_attention.launches
    again = KA.scaled_dot_product_attention(*(torch.from_numpy(a).to(td) for a in (q, k, v)))
    assert torch.equal(again, got) and KA.scaled_dot_product_attention.launches == before


@pytest.mark.parametrize("long", [False, True], ids=["short", "past_switch"])
def test_per_op_attention_matches_pallas(long, monkeypatch):
    """The QKV linear, K21 (K13 past the switch, as the JAX function routes
    to its flash kernel) on strided views of the packed columns, the out
    linear — against the JAX per-op attention in interpret mode."""
    b, t, d, h = 2, 17, 64, 4
    if long:
        monkeypatch.setattr(JF, "VMEM_ATTENTION_MAX_T", 8)
        monkeypatch.setattr(TF, "VMEM_ATTENTION_MAX_T", 8)
    calls = []
    plain = KFA.flash_attention_fwd_plain
    monkeypatch.setattr(KFA, "flash_attention_fwd_plain", lambda *a: calls.append(1) or plain(*a))
    x = _np(0, b, t, d)
    w = (_np(1, d, 3 * d, scale=d ** -0.5), _np(2, 3 * d, scale=0.1),
         _np(3, d, d, scale=d ** -0.5), _np(4, d, scale=0.1))
    want = JAK.attention(jnp.asarray(x), *map(jnp.asarray, w), h, interpret=True)
    got = KA.attention(torch.from_numpy(x), *map(torch.from_numpy, w), h)
    assert len(calls) == int(long)
    _close(got, want, "float32", _fp32_rel)


def test_sdpa_routes_to_flash_past_the_switch(monkeypatch):
    # tests/test_pallas.py:test_per_op_attention_long_seq_routes_to_flash,
    # on both packages: the switch read at call time
    monkeypatch.setattr(JF, "VMEM_ATTENTION_MAX_T", 16)
    monkeypatch.setattr(TF, "VMEM_ATTENTION_MAX_T", 16)
    calls = []
    plain = KFA.flash_attention_fwd_plain
    monkeypatch.setattr(KFA, "flash_attention_fwd_plain", lambda *a: calls.append(1) or plain(*a))
    q, k, v = (_np(seed, 1, 2, 24, 16) for seed in (5, 6, 7))
    want = JAK.scaled_dot_product_attention(*map(jnp.asarray, (q, k, v)), interpret=True)
    got = KA.scaled_dot_product_attention(*map(torch.from_numpy, (q, k, v)))
    assert calls == [1]
    _close(got, want, "float32", _fp32_abs)


# -- K22: the MLP -------------------------------------------------------------


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_mlp_twin_matches_pallas(dtype, variant):
    jd, td = DTYPES[dtype]
    rows, d, f = 67, 64, 256  # 67 rows: a ragged last block of 32
    a = (_np(10, rows, d, scale=2.0), _np(11, d, f, scale=d ** -0.5), _np(12, f, scale=0.1),
         _np(13, f, d, scale=f ** -0.5), _np(14, d, scale=0.1))
    want = JMK.mlp(*(jnp.asarray(x, jd) for x in a), gelu_variant=variant, block_rows=32,
                   interpret=True)
    got = KM.mlp(*(torch.from_numpy(x).to(td) for x in a), gelu_variant=variant)
    assert got.dtype == td
    _close(got, want, dtype, _fp32_rel)


def test_mlp_leading_shape_and_no_inner_dropout():
    a = (_np(20, 2, 5, 64), _np(21, 64, 128, scale=0.125), _np(22, 128), _np(23, 128, 64),
         _np(24, 64))
    t = [torch.from_numpy(x) for x in a]
    got = KM.mlp(*t)
    assert tuple(got.shape) == (2, 5, 64)
    assert torch.equal(got.reshape(10, 64), KM.mlp_plain(t[0].reshape(10, 64), *t[1:]))
    with pytest.raises(ValueError, match="regularizer hooks"):
        KM.mlp(*t, inner_dropout=(torch.Generator(), 0.1))


@pytest.mark.parametrize("kernel", ["scaled_dot_product_attention", "mlp"])
def test_wrappers_refuse_other_devices(kernel):
    # a non-CPU tensor either launches the kernel or raises; never the twin
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    calls = {
        "scaled_dot_product_attention": lambda: KA.scaled_dot_product_attention(
            m(2, 3, 5, 16), m(2, 3, 5, 16), m(2, 3, 5, 16)),
        "mlp": lambda: KM.mlp(m(10, 64), m(64, 256), m(256), m(256, 64), m(64)),
    }
    with pytest.raises(ValueError, match="CUDA or CPU"):
        calls[kernel]()


# -- the per_op table, forward and engine --------------------------------------


@pytest.fixture(scope="module")
def tree(tiny_cfg):
    return wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=1), tiny_cfg)


@pytest.fixture(scope="module")
def images(tiny_cfg):
    return synth_images(6, tiny_cfg, seed=2)


@pytest.fixture(scope="module")
def jax_pallas_fp32(tiny_cfg, tree, images):
    params = jax.tree.map(jnp.asarray, tree)
    return np.asarray(jvit.forward(params, jnp.asarray(images), tiny_cfg, jget_ops("pallas")))


def test_op_tables():
    from vit_tpu_torch.ops import fused
    from vit_tpu_torch.ops.kernels.layer_norm import layer_norm

    ops = get_ops("per_op")
    assert ops is fused.PER_OP_OPS and ops.name == "per_op"
    assert ops.layer_norm is layer_norm and ops.attention is KA.attention and ops.mlp is KM.mlp
    assert ops.encoder_block is None and ops.encoder_block_train is None
    # the JAX fused/quant tables carry the per-op kernels in these slots too
    for name in ("fused", "quant"):
        assert get_ops(name).attention is KA.attention and get_ops(name).mlp is KM.mlp


def test_per_op_forward_matches_jax_pallas(tiny_cfg, tree, images, jax_pallas_fp32):
    got = tvit.forward(params_from_numpy(tree, "cpu"), torch.from_numpy(images), tiny_cfg,
                       get_ops("per_op"))
    np.testing.assert_allclose(got.numpy(), jax_pallas_fp32, atol=1e-5, rtol=0)


def _probs(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_engine_per_op_matches_jax_engine(tiny_cfg, tree, images):
    jeng = JEngine(tiny_cfg, tree, dtype="float32", ops="pallas", batch_pad=4)
    jlabels, jtop = jeng.classify(images)
    eng = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="per_op", device="cpu",
                          batch_pad=4)
    labels, top = eng.classify(images)
    np.testing.assert_array_equal(labels, np.asarray(jlabels))
    np.testing.assert_allclose(top, np.asarray(jtop), atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="tome_r"):
        InferenceEngine(tiny_cfg, tree, ops="per_op", device="cpu", tome_r=2)


def _phases(report: str) -> dict:
    """{phase: calls} of a PhaseTimer report."""
    out = {}
    for line in report.splitlines():
        m = re.fullmatch(r"(\S+)\s+[\d.]+ ms total\s+[\d.]+ ms/call\s+x(\d+)", line.strip())
        assert m, line
        out[m.group(1)] = int(m.group(2))
    return out


@pytest.mark.parametrize("ops,jops", [("per_op", "pallas"), ("fused", "fused"),
                                      ("eager", "xla")])
def test_phase_report_matches_jax_engine(tiny_cfg, tree, images, ops, jops):
    want = _phases(JEngine(tiny_cfg, tree, dtype="float32", ops=jops, batch_pad=2)
                   .phase_report(images[:2], iters=2))
    eng = InferenceEngine(tiny_cfg, tree, dtype="float32", ops=ops, device="cpu", batch_pad=2)
    got = _phases(eng.phase_report(images[:2], iters=2))
    assert got == want
    assert got == {"patch_embed+pos": 2, "layer_norm_1": 4, "attention": 4,
                   "layer_norm_2": 4, "mlp": 4, "final_ln+head": 2}


def test_phase_report_rejects_quant(tiny_cfg, tree, images):
    eng = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="quant", device="cpu")
    with pytest.raises(NotImplementedError, match="separable"):
        eng.phase_report(images)


# -- the classify CLI ----------------------------------------------------------


@pytest.fixture
def weight_dir(tiny_cfg, tmp_path, monkeypatch):
    from vit_tpu import config
    from vit_tpu_torch import config as tconfig

    monkeypatch.setitem(config.CONFIGS, tiny_cfg.name, tiny_cfg)
    monkeypatch.setitem(tconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    d = tmp_path / "Network"
    wio.save_reference_weights(wio.synth_reference_tensors(tiny_cfg, seed=1), d, tiny_cfg)
    return d


def _cli(tiny_cfg, weight_dir, *extra):
    from vit_tpu_torch.cli.main import main

    return main(["--config", tiny_cfg.name, "--weights", str(weight_dir), "--synth", "4",
                 "--device", "cpu", "--dtype", "float32", *extra])


def test_cli_per_op_profile(tiny_cfg, weight_dir, tmp_path, capsys):
    from vit_tpu_torch.eval import comparator

    out = tmp_path / "result.txt"
    assert _cli(tiny_cfg, weight_dir, "--ops", "per_op", "--profile", "--output", str(out)) == 0
    stdout = capsys.readouterr().out
    assert "ops: per_op" in stdout
    phases = _phases("\n".join(l for l in stdout.splitlines() if " ms total " in l))
    assert phases == {"patch_embed+pos": 3, "layer_norm_1": 6, "attention": 6,
                      "layer_norm_2": 6, "mlp": 6, "final_ln+head": 3}
    # the JAX package's per-op tier on the same (6-decimal rounded) weights
    params = jax.tree.map(jnp.asarray, wio.load_reference_weights(weight_dir, tiny_cfg))
    want = _probs(np.asarray(jvit.forward(params, jnp.asarray(synth_images(4, tiny_cfg, 0)),
                                          tiny_cfg, jget_ops("pallas"))))
    lines = comparator.parse_result_file(out)
    assert [l.label for l in lines] == list(want.argmax(-1))
    np.testing.assert_allclose([l.prob for l in lines], want.max(-1), atol=2e-6, rtol=0)


@pytest.mark.parametrize("extra,msg", [
    (["--profile", "--tome", "2"], "--profile probes the full-token model"),
    (["--profile", "--ops", "quant"], "--profile needs fp weights"),
    (["--tome", "2", "--ops", "per_op"], "--tome (token merging) needs --ops fused, quant"),
], ids=["profile_tome", "profile_quant", "tome_per_op"])
def test_cli_refusals_exit_2(tiny_cfg, weight_dir, capsys, extra, msg):
    assert _cli(tiny_cfg, weight_dir, *extra) == 2
    assert msg in capsys.readouterr().err
