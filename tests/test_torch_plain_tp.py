"""Tensor parallelism on the port's plain tiers (``eager``, ``qat``:
``parallel/tp_forward.plain_tp_ops``, ``attention_maps_tp``) and the tp
engine's probes, against what GSPMD makes of the JAX package's ``xla`` and
``qat`` tiers on the virtual 8-device mesh; and ``vit_tpu_torch/dryrun.py``
against ``__graft_entry__.dryrun_multichip``.  The port runs in one 2-rank
gloo group (``torch_plain_tp_worker.py``, started once for the module).

Tolerances.  fp32 logits and features within 1e-4 of the JAX ``xla``
engine's on the same tp 2 mesh (a row-parallel product sums its two halves
in another order); the attention probabilities and the rollout within 1e-5.
One step's gradients within 1e-3 x max(1, max|g|) of ``jax.grad``'s on
every leaf, the loss within 1e-5 of it; on ``qat`` the loss within 2^-6 when
a code moves (``test_torch_qat.py``'s flip budget): here the absmaxes of
the post-GELU activation and of ``w2`` are an all-reduce MAX over tp.  With
them left rank-local the loss misses the JAX package's by more than 1e-4
(ten times the bound where no code moves), and some leaf's gradient by more
than 1e-3 of its scale.
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vit_tpu.models import vit as jvit
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu.parallel import make_mesh as jmake_mesh
from vit_tpu.runtime import trainer as jtrainer
from vit_tpu.runtime.engine import InferenceEngine as JaxEngine

import torch_parallel_train_worker as W

REPO = Path(__file__).resolve().parents[1]
STEP_RTOL = 2.0 ** -6

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v, np.float32)
    return out


@pytest.fixture(scope="module")
def case(tiny_cfg):
    from vit_tpu.io import weights as wio

    assert tiny_cfg.name == W.TINY.name  # the worker's config
    tree = wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=1), tiny_cfg)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 3, 32, 32)).astype(np.float32)
    return tree, x, rng.integers(0, tiny_cfg.num_classes, 4).astype(np.int32)


@pytest.fixture(scope="module")
def group(tmp_path_factory, case):
    """Both ranks' results of ``torch_plain_tp_worker.py``."""
    d = tmp_path_factory.mktemp("plain_tp")
    tree, x, y = case
    np.savez(d / "in.npz", **_flat(tree, "params/"), images=x, labels=y)
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO / 'tests'}", OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--standalone",
         str(REPO / "tests" / "torch_plain_tp_worker.py"), str(d / "in.npz"), str(d / "res")],
        cwd=d, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    return [dict(np.load(d / f"res.{r}.npz")) for r in (0, 1)]


@pytest.fixture(scope="module")
def jax_engine(tiny_cfg, case):
    mesh = jmake_mesh({"dp": 1, "tp": 2}, jax.devices()[:2])
    return JaxEngine(tiny_cfg, case[0], dtype="float32", ops="xla", mesh=mesh, batch_pad=4)


def test_eager_tp2_engine_holds_its_shard_and_matches_jax_xla(group, jax_engine, case, tiny_cfg):
    x = case[1]
    for r in group:
        assert r["eager_local_wqkv_shape"].tolist() == [2, 64, 96]  # (L, D, 3D/tp)
        np.testing.assert_allclose(r["eager_logits"], np.asarray(jax_engine.logits(x)),
                                   atol=1e-4, rtol=0)
        np.testing.assert_allclose(r["eager_features"], np.asarray(jax_engine.features(x)),
                                   atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["eager_maps", "fused_maps"])
def test_attention_maps_gather_every_head_as_jax(group, jax_engine, case, name):
    want = np.asarray(jax_engine.attention_maps(case[1]))
    for r in group:
        assert r[name].shape == want.shape  # (depth, B, H, T, T): every head on every rank
        np.testing.assert_allclose(r[name], want, atol=1e-5, rtol=0)


def test_attention_rollout_matches_jax(group, jax_engine, case):
    want = np.asarray(jax_engine.attention_maps(case[1], rollout=True))
    for r in group:
        np.testing.assert_allclose(r["eager_rollout"], want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("name", ["fused_report", "eager_report"])
def test_phase_report_on_a_tp_engine_has_the_jax_phases(group, jax_engine, case, name):
    def phases(text):
        return sorted(line.split()[0] for line in str(text).splitlines() if line.strip())

    want = phases(jax_engine.phase_report(case[1], iters=1))
    assert phases(group[0][name]) == want
    assert set(want) == {"patch_embed+pos", "layer_norm_1", "attention", "layer_norm_2", "mlp",
                         "final_ln+head"}


def _jax_grads(cfg, tree, x, y, ops: str):
    def loss(p):
        return jtrainer.cross_entropy_loss(jvit.forward(p, jnp.asarray(x), cfg, jget_ops(ops)),
                                           jnp.asarray(y))

    value, g = jax.value_and_grad(loss)(jax.tree.map(jnp.asarray, tree))
    return float(value), _flat(jax.tree.map(np.asarray, g))


def _res_tree(res, prefix):
    return {k[len(prefix):]: v for k, v in res.items() if k.startswith(prefix)}


@pytest.mark.parametrize("ops", ["eager", "qat"])
def test_tp2_step_grads_match_jax(group, case, tiny_cfg, ops):
    tree, x, y = case
    want_loss, want = _jax_grads(tiny_cfg, tree, x, y, "xla" if ops == "eager" else "qat")
    r0 = group[0]
    bound = 1e-5 if ops == "eager" else STEP_RTOL
    assert abs(float(r0[f"{ops}_loss"]) - want_loss) <= bound
    got = _res_tree(r0, f"{ops}_grads/")
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert np.abs(got[k] - w).max() <= 1e-3 * max(1.0, np.abs(w).max()), k
    for k in got:  # every rank gathers the same whole gradients
        np.testing.assert_array_equal(group[1][f"{ops}_grads/{k}"], got[k])


def test_qat_tp_needs_the_max_over_tp(group, case, tiny_cfg):
    # the all-reduce MAX of the post-GELU activation's and w2's absmaxes:
    # without it each rank quantizes its half on its own scale
    tree, x, y = case
    want_loss, want = _jax_grads(tiny_cfg, tree, x, y, "qat")
    r0 = group[0]
    with_max = abs(float(r0["qat_loss"]) - want_loss)
    local = abs(float(r0["qat_local_loss"]) - want_loss)
    assert with_max <= STEP_RTOL and local > 10 * max(with_max, 1e-5), (with_max, local)
    got = _res_tree(r0, "qat_local_grads/")
    worst = max(np.abs(got[k] - w).max() / max(1.0, np.abs(w).max()) for k, w in want.items())
    assert worst > 1e-3


def _statuses(line: str) -> dict:
    return dict(re.findall(r"(\w+)=(\S+)", line.split("OK:", 1)[1]))


def test_dryrun_legs_at_two_ranks_match_the_jax_dryrun(group):
    line = str(group[0]["dryrun"])
    assert str(group[0]["dryrun_stdout"]).strip() == line  # rank 0 prints the line
    assert str(group[1]["dryrun_stdout"]) == ""
    assert line.startswith("dryrun_multichip OK: ")
    got = _statuses(line)
    # __graft_entry__.dryrun_multichip at n = 2: tp = 2 (:92), so the mesh
    # {'dp': 1, 'tp': 2} and the batch max(2 * dp, 4) = 4 (:109)
    want = {
        "mesh": "{'dp':", "batch": "4",
        "fused_tp": "ok", "quant_tp": "ok",  # if tp >= 2 (:137)
        "deit_tp": "ok",  # if tp >= 2 (:158)
        "kernel_tp_train": "ok",  # if tp >= 2 (:178)
        "pp2": "ok",  # if n_devices >= 2 (:200)
        "pp3d_train_dp2xpp2xtp2": "skipped",  # if n_devices >= 8 (:230)
        "sp_ring_dp2xsp4": "skipped",  # if n_devices >= 8 (:258)
        "sp_fused_train": "skipped",  # if n_devices >= 8 (:286)
        # unconditional legs
        "mae_dpxtp": "ok", "zero1_dpxtp": "ok", "fsdp_dpxtp": "ok",
        "regularized_train_dp": "ok", "tome_train_dp": "ok", "tome_dropout_train_dp": "ok",
        "tome_droppath_lerp_train_dp": "ok",
        "pp_dropout_train": "ok",  # if n_devices >= 2 (:440)
    }
    assert "mesh={'dp': 1, 'tp': 2} batch=4 loss=" in line
    assert set(got) == set(want) | {"loss"}
    for key, value in want.items():
        assert got[key] == value, key
    assert float(got["loss"]) > 0
