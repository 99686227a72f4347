"""The port's whole slice — ``fused`` forward, ``InferenceEngine`` and the
classify CLI — against the JAX package's ``fused`` path on the CPU (its
Pallas kernels in interpret mode; the port's kernels through their plain
twins), plus the port's device and no-JAX rules.

Tolerances: fp32 logits 1e-5 absolute (fp32 accumulation on both sides).
bf16: labels must agree wherever the fp32 top-1 probability beats the
top-2 by more than the comparator's 0.01 (bench.py's decisive-label rule;
elsewhere bf16 noise may flip a statistical tie).
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.eval import comparator
from vit_tpu.io import weights as wio
from vit_tpu.io.images import synth_images
from vit_tpu.models import vit as jvit
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.runtime.engine import InferenceEngine


@pytest.fixture(scope="module")
def tree(tiny_cfg):
    return wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=1), tiny_cfg)


@pytest.fixture(scope="module")
def images(tiny_cfg):
    return synth_images(6, tiny_cfg, seed=2)


@pytest.fixture(scope="module")
def jax_fused_fp32(tiny_cfg, tree, images):
    params = jax.tree.map(jnp.asarray, tree)
    return np.asarray(jvit.forward(params, jnp.asarray(images), tiny_cfg, jget_ops("fused")))


def _probs(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_fused_forward_fp32_matches_jax(tiny_cfg, tree, images, jax_fused_fp32):
    got = tvit.forward(params_from_numpy(tree, "cpu"), torch.from_numpy(images), tiny_cfg,
                       get_ops("fused"))
    np.testing.assert_allclose(got.numpy(), jax_fused_fp32, atol=1e-5, rtol=0)


@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_fused_forward_bf16_decisive_labels_match_jax(tiny_cfg, tree, images, jax_fused_fp32,
                                                      variant):
    jparams = jvit.cast_params(jax.tree.map(jnp.asarray, tree), jnp.bfloat16)
    want = np.asarray(jvit.forward(jparams, jnp.asarray(images).astype(jnp.bfloat16), tiny_cfg,
                                   jget_ops("fused"), gelu_variant=variant))
    got = tvit.forward(params_from_numpy(tree, "cpu", torch.bfloat16),
                       torch.from_numpy(images), tiny_cfg, get_ops("fused"),
                       gelu_variant=variant).numpy()
    assert np.isfinite(got).all() and got.shape == want.shape
    p32 = np.sort(_probs(jax_fused_fp32), -1)
    decisive = (p32[:, -1] - p32[:, -2]) > 0.01
    assert decisive.any()
    assert not ((got.argmax(-1) != want.argmax(-1)) & decisive).any()
    # same rounding points: the bf16 logits agree to bf16 resolution too
    np.testing.assert_allclose(got, want, atol=2e-2, rtol=2 ** -7)


@pytest.mark.parametrize("ops", ["fused", "eager"])
def test_engine_classify_matches_jax(tiny_cfg, tree, images, jax_fused_fp32, ops):
    engine = InferenceEngine(tiny_cfg, tree, dtype="float32", ops=ops, device="cpu",
                             batch_pad=4)  # 6 images pad to 8
    labels, top = engine.classify(images)
    want = _probs(jax_fused_fp32)
    np.testing.assert_array_equal(labels, want.argmax(-1))
    np.testing.assert_allclose(top, want.max(-1), atol=1e-5, rtol=0)
    np.testing.assert_allclose(engine.logits(images).numpy(), jax_fused_fp32, atol=1e-5, rtol=0)


def test_engine_features_match_jax(tiny_cfg, tree, images):
    want = jvit.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(images), tiny_cfg,
                        jget_ops("fused"), return_features=True)
    engine = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="fused", device="cpu")
    got = engine.features(torch.from_numpy(images))
    assert tuple(got.shape) == (6, tiny_cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_engine_swap_params(tiny_cfg, tree, images):
    engine = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="eager", device="cpu")
    other = wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=9), tiny_cfg)
    before = engine.logits(images)
    engine.swap_params(other)
    assert not torch.equal(before, engine.logits(images))
    bad = dict(other, head={"kernel": np.zeros((tiny_cfg.embed_dim, 3), np.float32),
                            "bias": np.zeros((3,), np.float32)})
    with pytest.raises(ValueError, match="shapes"):
        engine.swap_params(bad)


def test_engine_cuda_without_card_raises(tiny_cfg, tree, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        InferenceEngine(tiny_cfg, tree, device="cuda")


def test_engine_rejects_unknown_dtype_and_ops(tiny_cfg, tree):
    with pytest.raises(ValueError, match="dtype"):
        InferenceEngine(tiny_cfg, tree, dtype="float16", device="cpu")
    with pytest.raises(ValueError, match="unknown ops impl 'int4'"):
        InferenceEngine(tiny_cfg, tree, ops="int4", device="cpu")
    assert InferenceEngine(tiny_cfg, tree, ops="qat", device="cpu")._ops.name == "qat"


# -- CLI ---------------------------------------------------------------------


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


@pytest.mark.parametrize("ops", ["eager", "fused"])
def test_cli_writes_reference_format(tiny_cfg, weight_dir, tmp_path, capsys, ops):
    out = tmp_path / "result.txt"
    assert _cli(tiny_cfg, weight_dir, "--ops", ops, "--output", str(out), "--json") == 0
    lines = comparator.parse_result_file(out)
    assert [l.index for l in lines] == [0, 1, 2, 3]
    # the JAX package on the same (6-decimal rounded) weights and images
    params = jax.tree.map(jnp.asarray, wio.load_reference_weights(weight_dir, tiny_cfg))
    want = _probs(np.asarray(jvit.forward(params, jnp.asarray(synth_images(4, tiny_cfg, 0)),
                                          tiny_cfg)))
    assert [l.label for l in lines] == list(want.argmax(-1))
    np.testing.assert_allclose([l.prob for l in lines], want.max(-1), atol=2e-6, rtol=0)
    stdout = capsys.readouterr().out
    assert f"ops: {ops}" in stdout and '"images": 4' in stdout


def test_cli_golden_exit_code(tiny_cfg, weight_dir, tmp_path):
    golden = tmp_path / "golden.txt"
    assert _cli(tiny_cfg, weight_dir, "--output", str(golden)) == 0
    assert _cli(tiny_cfg, weight_dir, "--golden", str(golden)) == 0
    lines = comparator.parse_result_file(golden)
    lines[2] = comparator.ResultLine(2, (lines[2].label + 1) % tiny_cfg.num_classes, lines[2].prob)
    comparator.write_result_file([l.label for l in lines], [l.prob for l in lines], golden)
    assert _cli(tiny_cfg, weight_dir, "--golden", str(golden)) == 1


def test_cli_auto_ops_on_cpu_is_eager(tiny_cfg, weight_dir, capsys):
    assert _cli(tiny_cfg, weight_dir, "--ops", "auto") == 0
    assert "ops: eager" in capsys.readouterr().out


def test_cli_refuses_orbax_directory(tiny_cfg, tmp_path, capsys):
    from vit_tpu_torch.cli.main import main

    (tmp_path / "ckpt").mkdir()
    rc = main(["--weights", str(tmp_path / "ckpt"), "--synth", "1", "--device", "cpu"])
    assert rc == 2
    assert "Orbax" in capsys.readouterr().err


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import vit_tpu_torch.cli.main, vit_tpu_torch.runtime.engine, vit_tpu_torch.ops.fused\n"
        "import vit_tpu_torch.models.vit, vit_tpu_torch.io.params\n"
        "import vit_tpu_torch.cli.train, vit_tpu_torch.cli.train_setup, vit_tpu_torch.cli.train_loop\n"
        "import vit_tpu_torch.runtime.trainer, vit_tpu_torch.ops.trainable, vit_tpu_torch.ops.backward\n"
        "from vit_tpu_torch.ops.dispatch import get_ops; get_ops('fused_train')\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)
