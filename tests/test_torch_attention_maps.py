"""The port's attention probe — ``reference.attention(return_probs=True)``,
``models/vit.attention_maps``/``attention_rollout``,
``InferenceEngine.attention_maps`` and the classify CLI's ``--attn-rollout``
— against the JAX package's on the CPU, at ``tiny_cfg`` and at a tiny DeiT
config (two prefix tokens).

Tolerance: 1e-5 absolute on probabilities and rollout maps (fp32 on both
sides; each is a softmax row or a product of row-stochastic matrices, so
bounded by 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.io import weights as wio
from vit_tpu.models import vit as jvit
from vit_tpu.ops import reference as jref
from vit_tpu.runtime import InferenceEngine as JaxEngine
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops import reference as tref
from vit_tpu_torch.parallel.mesh import Mesh
from vit_tpu_torch.runtime.engine import InferenceEngine

TOL = 1e-5


@pytest.fixture(scope="module", params=["vit", "deit"])
def case(request, tiny_cfg):
    """(config, the JAX package's numpy params) for each config."""
    if request.param == "vit":
        return tiny_cfg, wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, 1),
                                                 tiny_cfg)
    cfg = dataclasses.replace(tiny_cfg, distilled=True, name="deit_tiny_test")
    return cfg, jax.tree.map(lambda a: np.array(a, np.float32),
                             jvit.init_params(jax.random.key(2), cfg))


def _x(cfg, b=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, 3, cfg.image_size, cfg.image_size)).astype(np.float32)


def test_reference_attention_return_probs_matches_jax():
    rng = np.random.default_rng(3)
    d, h, t = 32, 4, 7
    x, wqkv, bqkv = rng.normal(size=(2, t, d)), rng.normal(size=(d, 3 * d)) / d ** 0.5, \
        rng.normal(size=(3 * d,)) * 0.1
    wo, bo = rng.normal(size=(d, d)) / d ** 0.5, rng.normal(size=(d,)) * 0.1
    args = [a.astype(np.float32) for a in (x, wqkv, bqkv, wo, bo)]
    out, probs = tref.attention(*map(torch.from_numpy, args), h, return_probs=True)
    jout, jprobs = jref.attention(*map(jnp.asarray, args), h, return_probs=True)
    assert probs.dtype == torch.float32 and tuple(probs.shape) == (2, h, t, t)
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=TOL, rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=TOL, rtol=0)
    # the probabilities are the fp32 softmax from before the rounding to bf16
    _, p16 = tref.attention(*[torch.from_numpy(a).bfloat16() for a in args], h,
                            return_probs=True)
    assert p16.dtype == torch.float32


def test_attention_maps_and_rollout_match_jax(case):
    cfg, tree = case
    x = _x(cfg)
    want = np.asarray(jvit.attention_maps(jax.tree.map(jnp.asarray, tree), jnp.asarray(x), cfg))
    got = tvit.attention_maps(params_from_numpy(tree, "cpu"), torch.from_numpy(x), cfg)
    t = cfg.seq_len
    assert tuple(got.shape) == (cfg.depth, 2, cfg.num_heads, t, t) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=TOL)
    p = cfg.num_prefix_tokens
    jroll = np.asarray(jvit.attention_rollout(jnp.asarray(want), p))
    assert jroll.shape == (2, cfg.num_patches)
    # the port's rollout on the JAX probabilities, then end to end
    np.testing.assert_allclose(tvit.attention_rollout(torch.from_numpy(want.copy()), p).numpy(),
                               jroll, atol=TOL, rtol=0)
    np.testing.assert_allclose(tvit.attention_rollout(got, p).numpy(), jroll, atol=TOL, rtol=0)


def test_rollout_matches_float64_composition_and_ignores_tf32(case):
    """The row-vector chain equals the full fp64 matrix composition, and no
    float32 matmul precision setting reaches it."""
    cfg, tree = case
    probs = tvit.attention_maps(params_from_numpy(tree, "cpu"), torch.from_numpy(_x(cfg, 1, 1)),
                                cfg)
    a = probs.double().mean(dim=2)
    t = a.shape[-1]
    a = 0.5 * a + 0.5 * torch.eye(t, dtype=torch.float64)
    a = a / a.sum(-1, keepdim=True)
    r = torch.eye(t, dtype=torch.float64)
    for layer in a[:, 0]:
        r = layer @ r
    want = r[0, cfg.num_prefix_tokens:].numpy()
    before = torch.get_float32_matmul_precision()
    try:
        for precision in ("highest", "high", "medium"):
            torch.set_float32_matmul_precision(precision)
            got = tvit.attention_rollout(probs, cfg.num_prefix_tokens)[0].numpy()
            np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    finally:
        torch.set_float32_matmul_precision(before)
    assert got.sum() <= 1.0 + TOL  # rows of the full rollout are stochastic


@pytest.mark.parametrize("ops,jax_ops", [("eager", "xla"), ("fused", "fused"),
                                         ("per_op", "pallas")])
def test_engine_attention_maps_match_jax(case, ops, jax_ops):
    cfg, tree = case
    x = _x(cfg, 3, 2)
    eng = InferenceEngine(cfg, tree, dtype="float32", ops=ops, device="cpu", batch_pad=4)
    jeng = JaxEngine(cfg, jax.tree.map(jnp.asarray, tree), dtype="float32", ops=jax_ops,
                     batch_pad=4)
    g = cfg.grid_size
    roll = eng.attention_maps(x, rollout=True)
    assert tuple(roll.shape) == (3, g, g) and (roll >= 0).all()
    np.testing.assert_allclose(roll.numpy(), np.asarray(jeng.attention_maps(x, rollout=True)),
                               atol=TOL, rtol=0)
    probs = eng.attention_maps(x)
    assert probs.shape[:2] == (cfg.depth, 3)  # grain 1: no padded rows
    np.testing.assert_allclose(probs.numpy(), np.asarray(jeng.attention_maps(x)), atol=TOL,
                               rtol=0)


def test_engine_attention_maps_split_over_dp(case):
    """On a dp mesh each rank probes its slice of the batch, on the
    probabilities' batch axis: with the all-reduce a no-op (no process
    group), the two ranks' outputs sum to the single engine's."""
    cfg, tree = case
    x = _x(cfg, 3, 4)  # 3 pads to 4 over dp 2
    single = InferenceEngine(cfg, tree, dtype="float32", ops="eager", device="cpu")
    want_probs, want_roll = single.attention_maps(x), single.attention_maps(x, rollout=True)
    parts = [InferenceEngine(cfg, tree, dtype="float32", ops="eager", device="cpu",
                             mesh=Mesh({"dp": 2, "tp": 1}, rank, {})).attention_maps(x)
             for rank in range(2)]
    assert parts[0][:, 2:].abs().max() == 0 and parts[1][:, :2].abs().max() == 0
    probs = parts[0] + parts[1]
    np.testing.assert_allclose(probs.numpy(), want_probs.numpy(), atol=1e-6, rtol=0)
    g = cfg.grid_size
    np.testing.assert_allclose(
        tvit.attention_rollout(probs, cfg.num_prefix_tokens).reshape(3, g, g).numpy(),
        want_roll.numpy(), atol=1e-6, rtol=0)


def test_engine_refusals(tiny_cfg):
    tree = wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=1), tiny_cfg)
    x = _x(tiny_cfg)
    q = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="quant", device="cpu")
    with pytest.raises(ValueError, match="fp weights"):
        q.attention_maps(x)
    tome = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="fused", device="cpu", tome_r=1)
    with pytest.raises(ValueError, match="tome_r=0 engine for interpretability"):
        tome.attention_maps(x, rollout=True)
    # a tp engine probes its local heads (tp_forward.attention_maps_tp): with
    # no process group, rank 0 of tp 2 fills the first half of the head axis
    # and leaves the other rank's slots zero; its heads of the first layer
    # (before any sum over tp) are the whole probe's
    tp = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="fused", device="cpu",
                         mesh=Mesh({"dp": 1, "tp": 2}, 0, {}))
    got = tp.attention_maps(x)
    want = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="eager",
                           device="cpu").attention_maps(x)
    h = tiny_cfg.num_heads // 2
    assert got.shape == want.shape
    np.testing.assert_allclose(got[0, :, :h].numpy(), want[0, :, :h].numpy(), atol=1e-6, rtol=0)
    assert got[:, :, h:].abs().max() == 0


@pytest.fixture
def weight_dir(tiny_cfg, tmp_path, monkeypatch):
    import vit_tpu.config as jconfig
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(jconfig.CONFIGS, "vit_tiny_test", tiny_cfg)
    monkeypatch.setitem(tconfig.CONFIGS, "vit_tiny_test",
                        tconfig.ViTConfig(**dataclasses.asdict(tiny_cfg)))
    wio.save_reference_weights(wio.synth_reference_tensors(tiny_cfg, seed=1),
                               tmp_path / "Network", tiny_cfg)
    return tmp_path / "Network"


def _base(weight_dir):
    return ["--config", "vit_tiny_test", "--weights", str(weight_dir), "--synth", "3",
            "--dtype", "float32", "--batch-pad", "4"]


def test_cli_attn_rollout_matches_jax_cli(weight_dir, tmp_path, tiny_cfg, capsys):
    from vit_tpu.cli.main import main as jmain
    from vit_tpu_torch.cli.main import main as tmain

    assert jmain([*_base(weight_dir), "--ops", "xla", "--no-compile-cache",
                  "--attn-rollout", str(tmp_path / "jax.npz")]) == 0
    assert tmain([*_base(weight_dir), "--ops", "eager", "--device", "cpu",
                  "--attn-rollout", str(tmp_path / "port.npz")]) == 0
    assert "saved attention-rollout maps (3, 2, 2)" in capsys.readouterr().out
    got, want = np.load(tmp_path / "port.npz"), np.load(tmp_path / "jax.npz")
    assert sorted(got.files) == sorted(want.files) == ["labels", "maps"]
    g = tiny_cfg.grid_size
    assert got["maps"].shape == want["maps"].shape == (3, g, g)
    np.testing.assert_allclose(got["maps"], want["maps"], atol=TOL, rtol=0)
    np.testing.assert_array_equal(got["labels"], want["labels"])


@pytest.mark.parametrize("extra,msg", [
    (["--tome", "2", "--ops", "fused"], "--attn-rollout probes the full-token model"),
    (["--ops", "quant"], "--attn-rollout needs fp weights"),
    (["--profile", "--ops", "quant"], "--attn-rollout/--profile need fp weights"),
    (["--profile", "--tome", "2"], "--attn-rollout/--profile probe the full-token model"),
    (["--tp", "2"], "need one process per rank: run the CLI under `torchrun"),
], ids=["tome", "quant", "both_quant", "both_tome", "tp"])
def test_cli_attn_rollout_refusals_exit_2(weight_dir, tmp_path, capsys, monkeypatch, extra,
                                          msg):
    from vit_tpu_torch.cli.main import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert main([*_base(weight_dir), "--device", "cpu", "--attn-rollout",
                 str(tmp_path / "r.npz"), *extra]) == 2
    assert msg in capsys.readouterr().err
    assert not (tmp_path / "r.npz").exists()
