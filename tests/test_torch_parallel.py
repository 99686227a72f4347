"""The parallel slice of the port — ``parallel/`` (mesh, sharding rules,
tensor- and data-parallel forwards), ``runtime/distributed.py``,
``InferenceEngine(mesh=)``, the classify CLI's ``--tp``/``--dp``, and the
twins of K5's partial form, K18 (``ln_fc1_gelu_q8``, ``fc2_q8_partial``)
and K19 (``ln_qkv_attn_q8a``) — against the JAX package on the CPU: its
Pallas kernels in interpret mode and its ``shard_map`` forwards on the
virtual 8-device mesh, the port in one 2-rank gloo group of its own
(``torch_parallel_worker.py``, started once for the module).

Tolerances.  fp32 logits and features within 1e-5 of the JAX package's
(``tests/test_parallel.py``'s bar between sharded and single-device),
bf16 within 5e-2 (the same file's bf16 reduction-order bar).  The K18
kernels' int32 output equals the JAX kernel's bit for bit; K18a's fp32
``mid`` is held like the other W8A8 stages (``test_torch_quant.py``):
LayerNorm reduces in another order in torch and XLA, so a row's int8 code
may sit on the other side of a rounding boundary — all but 2% of the rows
within 1e-5 of the largest |value|, every row within 2^-6 of it.  K19's
attention stage on the JAX package's own packed QKV is within 1e-5 of its
kernel (the JAX package's own bar between that kernel and its mirror);
the whole twin against the whole kernel by the same moved-code rule.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import vit_tpu.ops.pallas.quant_kernels as JK
from vit_tpu.io import weights as wio
from vit_tpu.ops import quant as JQ
from vit_tpu.parallel import make_mesh as jmake_mesh
from vit_tpu.parallel import mesh_shape_for as jmesh_shape_for
from vit_tpu.parallel import param_pspecs as jparam_pspecs
from vit_tpu.runtime import InferenceEngine as JaxEngine
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.ops import quant as TQ
from vit_tpu_torch.ops.kernels.fc2_q8_partial import fc2_q8_partial
from vit_tpu_torch.ops.kernels.ln_fc1_gelu_q8 import ln_fc1_gelu_q8
from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as K15
from vit_tpu_torch.parallel import make_mesh, mesh_shape_for, param_pspecs, shard_params
from vit_tpu_torch.parallel.mesh import Mesh
from vit_tpu_torch.runtime import distributed
from vit_tpu_torch.runtime.engine import InferenceEngine

REPO = Path(__file__).resolve().parents[1]
STEP_RTOL = 2.0 ** -6
OUTLIER_ROWS = 0.02

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")


def _flat(tree, prefix):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_rows(got, want, atol):
    """All but OUTLIER_ROWS of the rows within ``atol`` of the largest
    |value|; every element within STEP_RTOL of it (a moved int8 code)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    assert np.isfinite(got).all() and got.shape == want.shape
    bad = (np.abs(got - want) > atol * scale).reshape(-1, got.shape[-1]).any(-1)
    assert bad.mean() <= OUTLIER_ROWS, f"{bad.sum()} of {len(bad)} rows"
    np.testing.assert_allclose(got, want, atol=STEP_RTOL * scale, rtol=0)


def _mlp_case():
    """The W8A8 MLP operands of ``test_parallel.py``'s
    ``test_mlp_q8_tp_kernels_match_jnp_oracle``."""
    d, f, rows = 64, 256, 40
    rng = np.random.default_rng(3)
    x = rng.normal(size=(rows, d)).astype(np.float32)
    blk = {
        "ln2_scale": (1 + 0.1 * rng.normal(size=(d,))).astype(np.float32),
        "ln2_bias": (0.1 * rng.normal(size=(d,))).astype(np.float32),
        "w1": rng.integers(-127, 128, (d, f)).astype(np.int8),
        "w1_scale": rng.uniform(0.005, 0.02, (f,)).astype(np.float32),
        "b1": (0.1 * rng.normal(size=(f,))).astype(np.float32),
        "w2": rng.integers(-127, 128, (f, d)).astype(np.int8),
        "w2_scale": rng.uniform(0.005, 0.02, (d,)).astype(np.float32),
        "b2": (0.1 * rng.normal(size=(d,))).astype(np.float32),
    }
    return x, blk


# -- the 2-rank gloo group, started once -----------------------------------------


@pytest.fixture(scope="module")
def other_params(tiny_cfg):
    return wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=9), tiny_cfg)


@pytest.fixture(scope="module")
def group(tmp_path_factory, tiny_params, tiny_images, other_params):
    """Both ranks' results of ``torch_parallel_worker.py`` on the JAX
    package's tiny params and images; the ranks must agree exactly."""
    d = tmp_path_factory.mktemp("group")
    x, blk = _mlp_case()
    np.savez(d / "in.npz", images=np.asarray(tiny_images), mlp_x=x,
             **_flat(_np_tree(tiny_params), "params/"), **_flat(other_params, "other/"),
             **_flat(blk, "mlp/"))
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--standalone", str(REPO / "tests" / "torch_parallel_worker.py"),
         str(d / "in.npz"), str(d / "out")],
        cwd=d, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    r0, r1 = (dict(np.load(d / f"out.{r}.npz")) for r in (0, 1))
    for key in r0:
        if key.endswith("coords") or key.startswith("quant_local"):
            continue
        np.testing.assert_array_equal(r0[key], r1[key], err_msg=key)
    return r0, r1


def _jax_logits(cfg, params, images, ops, dtype, mesh_shape, features=False):
    n = mesh_shape.get("dp", 1) * mesh_shape.get("tp", 1)
    mesh = jmake_mesh(mesh_shape, jax.devices()[:n])
    eng = JaxEngine(cfg, params, dtype=dtype, ops=ops, mesh=mesh, batch_pad=4)
    out = eng.features(images) if features else eng.logits(images)
    return np.asarray(jnp.asarray(out, jnp.float32))


@pytest.mark.parametrize("ops", ["fused", "quant"])
def test_tp2_fp32_matches_jax_shard_forward_tp(group, tiny_cfg, tiny_params, tiny_images, ops):
    want = _jax_logits(tiny_cfg, tiny_params, tiny_images, ops, "float32", {"dp": 1, "tp": 2})
    np.testing.assert_allclose(group[0][f"{ops}_tp2_float32"], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("ops", ["fused", "quant"])
def test_tp2_bf16_matches_jax_with_features(group, tiny_cfg, tiny_params, tiny_images, ops):
    want = _jax_logits(tiny_cfg, tiny_params, tiny_images, ops, "bfloat16", {"dp": 1, "tp": 2})
    np.testing.assert_allclose(group[0][f"{ops}_tp2_bfloat16"], want, atol=5e-2, rtol=0)
    fwant = _jax_logits(tiny_cfg, tiny_params, tiny_images, ops, "bfloat16", {"dp": 1, "tp": 2},
                        features=True)
    got = group[0][f"{ops}_tp2_bfloat16_features"]
    assert got.shape == fwant.shape == (4, tiny_cfg.embed_dim)
    np.testing.assert_allclose(got, fwant, atol=5e-2, rtol=0)


def test_tp2_fp32_features_match_single_rank(group, tiny_cfg, tiny_params, tiny_images):
    one = InferenceEngine(tiny_cfg, _np_tree(tiny_params), dtype="float32", ops="fused",
                          device="cpu", batch_pad=4)
    np.testing.assert_allclose(group[0]["fused_tp2_float32_features"],
                               one.features(tiny_images).numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("ops", ["fused", "quant", "eager"])
def test_dp2_matches_jax_shard_forward_dp(group, tiny_cfg, tiny_params, tiny_images, ops):
    jops = {"eager": "xla"}.get(ops, ops)
    want = _jax_logits(tiny_cfg, tiny_params, tiny_images, jops, "float32", {"dp": 2})
    np.testing.assert_allclose(group[0][f"{ops}_dp2_float32"], want, atol=1e-5, rtol=0)
    if ops == "fused":  # a ragged batch pads to the dp multiple
        np.testing.assert_allclose(group[0]["fused_dp2_3images"], want[:3], atol=1e-5, rtol=0)


@pytest.mark.parametrize("ops", ["fused", "quant"])
def test_tp2_long_sequences_match_jax(group, tiny_cfg, tiny_params, tiny_images, ops,
                                      monkeypatch):
    from vit_tpu.ops.pallas import fused_block as JFB

    monkeypatch.setattr(JFB, "VMEM_ATTENTION_MAX_T", 4)  # T=5 > 4, as in the worker
    want = _jax_logits(tiny_cfg, tiny_params, tiny_images, ops, "float32", {"dp": 1, "tp": 2})
    np.testing.assert_allclose(group[0][f"{ops}_tp2_long"], want, atol=1e-5, rtol=0)


def test_meshes_and_swap_params_in_the_group(group, tiny_params):
    r0, r1 = group
    assert r0["tp_coords"].tolist() == [0, 0] and r1["tp_coords"].tolist() == [0, 1]
    assert r0["dp_coords"].tolist() == [0, 0] and r1["dp_coords"].tolist() == [1, 0]
    # each rank holds whole heads: its wqkv columns are the tree's, in order
    qp = TQ.quantize_params(params_from_numpy(_np_tree(tiny_params), "cpu"))
    full, scale = qp["blocks"]["wqkv"].numpy(), qp["blocks"]["wqkv_scale"].numpy()
    half = full.shape[-1] // 2
    for r, res in enumerate((r0, r1)):
        np.testing.assert_array_equal(res["quant_local_wqkv"], full[..., r * half:(r + 1) * half])
        np.testing.assert_array_equal(res["quant_local_wqkv_scale"],
                                      scale[..., r * half:(r + 1) * half])
    np.testing.assert_array_equal(r0["quant_tp2_swapped"], r0["quant_tp2_fresh"])
    assert not np.array_equal(r0["quant_tp2_swapped"], r0["quant_tp2_float32"])


def test_mlp_q8_tp_matches_jax_ref(group):
    """The port's ``_mlp_q8_tp`` (K18 twins around the all-reduces) against
    the JAX package's oracle ``_mlp_q8_tp_ref`` over tp = 2, and its own."""
    from vit_tpu.parallel.tp_forward import _mlp_q8_tp_ref

    x, blk = _mlp_case()
    mesh = jmake_mesh({"tp": 2}, jax.devices()[:2])
    specs = {"ln2_scale": P(), "ln2_bias": P(), "w1": P(None, "tp"), "w1_scale": P("tp"),
             "b1": P("tp"), "w2": P("tp", None), "w2_scale": P(), "b2": P()}
    want = np.asarray(jax.shard_map(
        lambda xx, b: _mlp_q8_tp_ref(xx, b, 1e-6, "exact", "tp"),
        mesh=mesh, in_specs=(P(), specs), out_specs=P(), check_vma=False,
    )(jnp.asarray(x), jax.tree.map(jnp.asarray, blk)))
    np.testing.assert_allclose(group[0]["mlp_q8_tp"], want, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(group[0]["mlp_q8_tp"], group[0]["mlp_q8_tp_ref"], rtol=1e-5,
                               atol=1e-3)


# -- mesh, shapes and rules in one process ---------------------------------------


def test_mesh_shape_for_matches_jax():
    for args in ((8, 2), (8, 1), (2, 2), (4, 2, 2)):
        assert mesh_shape_for(*args) == jmesh_shape_for(*args)
    for args, match in (((8, 3), "does not divide"), ((0, 16), "dp=0"), ((8, 2, 3), "!=")):
        with pytest.raises(ValueError, match=match):
            mesh_shape_for(*args)
        with pytest.raises(ValueError, match=match):
            jmesh_shape_for(*args)


def test_make_mesh_needs_the_world_size():
    mesh = make_mesh({"dp": 1, "tp": 1})  # one process, no process group
    assert mesh.shape == {"dp": 1, "tp": 1} and mesh.coords == {"dp": 0, "tp": 0}
    with pytest.raises(ValueError, match="needs 6 ranks, have 1"):
        make_mesh({"dp": 3, "tp": 2})
    # rank order: the last axis fastest, as numpy's reshape of a device list
    assert Mesh({"dp": 2, "tp": 2}, 2, {}).coords == {"dp": 1, "tp": 0}
    assert Mesh({"dp": 2, "tp": 2}, 1, {}).coords == {"dp": 0, "tp": 1}


@pytest.mark.parametrize("quantized", [False, True], ids=["fp", "int8"])
def test_param_pspecs_match_jax(tiny_params, quantized):
    tree = _np_tree(tiny_params)
    if quantized:
        tree = _np_tree(JQ.quantize_params(jax.tree.map(jnp.asarray, tree)))
    want = jparam_pspecs(("dp", "tp"), tree)
    got = param_pspecs(("dp", "tp"), tree)
    flat_w = jax.tree.map(tuple, want, is_leaf=lambda s: isinstance(s, P))
    assert got == flat_w
    assert got["blocks"]["wqkv"] == (None, None, "tp") and got["blocks"]["wo"] == (None, "tp", None)
    assert got["pos_embed"] == ()
    assert param_pspecs(("dp",), tree)["blocks"]["wqkv"] == (None, None, None)


@pytest.mark.parametrize("tp", [2, 4])
def test_tp_shard_is_whole_heads(tiny_cfg, tiny_params, tp):
    """A contiguous block of 3D/tp packed columns is whole heads: K1's twin
    over a rank's heads gives that rank's columns of the whole context."""
    from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn_plain

    per_shard = 3 * tiny_cfg.embed_dim // tp
    assert per_shard % (3 * tiny_cfg.head_dim) == 0
    full = params_from_numpy(_np_tree(tiny_params), "cpu")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(10, 64)).astype(np.float32))
    blk = {k: v[0] for k, v in full["blocks"].items()}
    args = (x, blk["ln1_scale"], blk["ln1_bias"])
    ctx = ln_qkv_attn_plain(*args, blk["wqkv"], blk["bqkv"], tiny_cfg.num_heads, 5, 1e-6)
    width = tiny_cfg.embed_dim // tp
    for r in range(tp):
        local = shard_params(full, Mesh({"dp": 1, "tp": tp}, r, {}))["blocks"]
        assert local["wo"].shape[1:] == (width, tiny_cfg.embed_dim)
        assert local["w1"].shape[-1] == local["w2"].shape[1] == tiny_cfg.mlp_dim // tp
        got = ln_qkv_attn_plain(*args, local["wqkv"][0], local["bqkv"][0],
                                tiny_cfg.num_heads // tp, 5, 1e-6)
        torch.testing.assert_close(got, ctx[:, r * width:(r + 1) * width], rtol=0, atol=1e-6)


# -- the kernels' twins against the JAX kernels in interpret mode -----------------


@pytest.mark.parametrize("fast_erf", [False, True], ids=["as_erf", "tanh_erf"])
@pytest.mark.parametrize("tp", [1, 2])
def test_k18_twins_match_jax_kernels(fast_erf, tp):
    x, blk = _mlp_case()
    f = blk["w1"].shape[1] // tp  # this shard's hidden columns
    w1, w1s, b1, w2 = blk["w1"][:, :f], blk["w1_scale"][:f], blk["b1"][:f], blk["w2"][:f]
    T = torch.from_numpy
    jmid = np.asarray(JK.ln_fc1_gelu_q8(
        jnp.asarray(x), jnp.asarray(blk["ln2_scale"]), jnp.asarray(blk["ln2_bias"]),
        jnp.asarray(w1), jnp.asarray(w1s), jnp.asarray(b1), 1e-6, "exact", fast_erf=fast_erf,
        interpret=True))
    mid = ln_fc1_gelu_q8(T(x), T(blk["ln2_scale"]), T(blk["ln2_bias"]), T(w1), T(w1s), T(b1),
                         1e-6, "exact", fast_erf=fast_erf)
    assert mid.dtype == torch.float32 and mid.shape == (40, f)
    _close_rows(mid.numpy(), jmid, 1e-5)
    # the int32 sums of the same mid and row scales, bit for bit
    ms = np.maximum(np.abs(jmid).max(-1, keepdims=True) / np.float32(127), np.float32(1e-12))
    ms = ms.astype(np.float32)
    want = np.asarray(JK.fc2_q8_partial(jnp.asarray(jmid), jnp.asarray(ms), jnp.asarray(w2),
                                        interpret=True))
    got = fc2_q8_partial(T(jmid.copy()), T(ms), T(w2))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def _k19_data():
    """``test_quant.py``'s K19 case (t 64, d 64, 4 heads), from its seed."""
    rng = np.random.default_rng(1234)
    t, d = 64, 64
    x = rng.normal(size=(t, d)).astype(np.float32)
    wq = rng.integers(-127, 128, (d, 3 * d)).astype(np.int8)
    ws = rng.uniform(0.0002, 0.0008, (3 * d,)).astype(np.float32)
    bq = (0.01 * rng.normal(size=(3 * d,))).astype(np.float32)
    return x, np.ones((d,), np.float32), np.zeros((d,), np.float32), wq, ws, bq


@pytest.mark.parametrize("quant_pv", [True, False], ids=["q8_pv", "dtype_pv"])
def test_k19_twin_matches_jax_kernel(quant_pv):
    x, s1, b1, wq, ws, bq = _k19_data()
    want = np.asarray(JK.ln_qkv_attn_q8a(*map(jnp.asarray, (x, s1, b1, wq, ws, bq)), 4, 64, 1e-6,
                                         quant_pv=quant_pv, interpret=True))
    # stage 3 on the JAX package's own packed QKV: its bar (1e-5)
    qkv = torch.from_numpy(np.asarray(JK._qkv_q8(*map(jnp.asarray, (x, s1[None], b1[None], wq,
                                                                    ws, bq)), 1e-6)))
    codes = K15.attention_q8_codes_plain(qkv, 4, 64, quant_pv)
    ctx, p8 = K15.attention_q8_plain(codes, qkv, 4, 64, quant_pv)
    np.testing.assert_allclose(ctx.numpy(), want, atol=1e-5, rtol=1e-5)
    assert (p8 is not None) == quant_pv
    # the whole twin: LayerNorm's order may move a code
    T = torch.from_numpy
    got = K15.ln_qkv_attn_q8a(T(x), T(s1), T(b1), T(wq), T(ws), T(bq), 4, 64, 1e-6,
                              quant_pv=quant_pv)
    _close_rows(got.numpy(), want, 1e-5)
    with pytest.raises(ValueError, match="no ToMe hooks"):
        K15.ln_qkv_attn_q8a(T(x), T(s1), T(b1), T(wq), T(ws), T(bq), 4, 64, 1e-6,
                            return_kmean=True)


def test_k19_stages_on_the_cpu_are_the_twins():
    x, s1, b1, wq, ws, bq = map(torch.from_numpy, _k19_data())
    st = K15._ln_qkv_attn_q8a_stages(x, s1, b1, wq, ws, bq, 4, 64, 1e-6, True, True)
    assert {"hq", "hs", "qkv", "q8", "qs", "k8", "ks", "v8", "vs", "p8", "ctx"} <= set(st)
    assert st["p8"].shape == (1, 4, 64, 64) and st["vs"].shape == (1, 4, 16)
    assert st["p8"].min() >= 0 and st["p8"].max() == 127  # e = 1 at each row's max
    ctx, _ = K15.attention_q8_plain(st, st["qkv"], 4, 64, True, p8=st["p8"])
    torch.testing.assert_close(ctx, st["ctx"], rtol=0, atol=0)


# -- refusals, and distributed.initialize -----------------------------------------


def _fake_mesh(tp, dp=1):
    return Mesh({"dp": dp, "tp": tp}, 0, {})


def test_engine_refusals(tiny_cfg, tiny_params):
    import dataclasses

    tree = _np_tree(tiny_params)
    mesh = _fake_mesh(2)
    with pytest.raises(ValueError, match="data-parallel only"):
        InferenceEngine(tiny_cfg, tree, ops="per_op", device="cpu", mesh=mesh)
    cfg3 = dataclasses.replace(tiny_cfg, num_heads=3, name="vit_tiny_3h")
    with pytest.raises(ValueError, match="must divide"):
        InferenceEngine(cfg3, tree, ops="fused", device="cpu", mesh=mesh)
    # the plain tier splits over tp as the kernel tiers do (it was refused
    # before tp_forward.plain_tp_ops): each rank holds its shard
    eager = InferenceEngine(tiny_cfg, tree, ops="eager", device="cpu", mesh=mesh)
    assert eager._tp_shard and eager.params["blocks"]["w1"].shape[-1] == tiny_cfg.mlp_dim // 2
    with pytest.raises(ValueError, match="data-parallel only"):
        InferenceEngine(tiny_cfg, tree, ops="qat", device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="data-parallel only"):
        InferenceEngine(tiny_cfg, tree, ops="fused", device="cpu", mesh=mesh, tome_r=1)
    # as the JAX package's: quant takes a tp mesh, its int8 weights sharded
    eng = InferenceEngine(tiny_cfg, tree, ops="quant", device="cpu", mesh=mesh)
    assert eng._tp_shard and eng.params["blocks"]["wqkv"].dtype == torch.int8
    assert eng.params["blocks"]["wqkv"].shape[-1] == 3 * tiny_cfg.embed_dim // 2
    # phase_report on a tp engine runs rank 0's shard (no process group
    # here: the all-reduces over tp are no-ops) through the JAX phases
    report = InferenceEngine(tiny_cfg, tree, ops="fused", device="cpu", mesh=mesh).phase_report(
        np.zeros((1, 3, 32, 32), np.float32), iters=1)
    assert sorted(line.split()[0] for line in report.splitlines()) == sorted(
        ("patch_embed+pos", "layer_norm_1", "attention", "layer_norm_2", "mlp", "final_ln+head"))


def test_cli_refusals(tmp_path, capsys, monkeypatch):
    from vit_tpu_torch.cli.main import main

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    base = ["--config", "vit_b_16", "--weights", str(tmp_path), "--synth", "2", "--device",
            "cpu"]
    assert main([*base, "--tp", "2"]) == 2
    assert "torchrun" in capsys.readouterr().err
    assert main([*base, "--dp", "2"]) == 2
    assert "torchrun" in capsys.readouterr().err
    assert main([*base, "--tp", "2", "--tome", "4"]) == 2
    assert "shards data-parallel only (no --tp)" in capsys.readouterr().err
    # --profile with --tp runs (each rank on its shard): it needs torchrun
    assert main([*base, "--tp", "2", "--profile"]) == 2
    assert "torchrun" in capsys.readouterr().err
    # a torchrun world that is not dp x tp
    monkeypatch.setenv("WORLD_SIZE", "3")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    assert main([*base, "--tp", "2"]) == 2
    assert "does not divide" in capsys.readouterr().err


@pytest.fixture
def fresh_distributed(monkeypatch):
    monkeypatch.setattr(distributed, "_initialized", False)
    monkeypatch.setattr(distributed, "_initialized_explicit", False)
    for key in ("WORLD_SIZE", "MASTER_ADDR", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    return monkeypatch


def test_distributed_initialize_rejects_late_explicit_args(fresh_distributed):
    assert distributed.initialize() is None  # single process: a no-op that latches
    assert distributed.initialize() is None  # idempotent
    with pytest.raises(RuntimeError, match="too late"):
        distributed.initialize(coordinator_address="host:1234", num_processes=8, process_id=0)


def test_distributed_initialize_explicit_is_idempotent(fresh_distributed):
    calls = []
    fresh_distributed.setattr(distributed.dist, "init_process_group",
                              lambda *a, **kw: calls.append((a, kw)))
    args = dict(coordinator_address="host:1234", num_processes=1, process_id=0)
    assert distributed.initialize(**args, device_type="cpu") == "gloo"
    distributed.initialize(**args, device_type="cpu")  # must not raise
    assert calls == [(("gloo",), dict(init_method="tcp://host:1234", world_size=1, rank=0))]


def test_backend_choice(fresh_distributed):
    assert distributed.choose_backend(None, "cpu") == "gloo"
    assert distributed.choose_backend("gloo", "cuda") == "gloo"
    with pytest.raises(ValueError, match="needs CUDA"):
        distributed.choose_backend("nccl", "cpu")
    fresh_distributed.setenv("LOCAL_WORLD_SIZE", "2")
    fresh_distributed.setattr(distributed.torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="share 1 card"):
        distributed.choose_backend(None, "cuda")
    fresh_distributed.setattr(distributed.torch.cuda, "device_count", lambda: 2)
    assert distributed.choose_backend(None, "cuda") == "nccl"
