"""ZeRO-1 and FSDP in the port — ``parallel/sharding.py``'s
``zero1_pspec``, ``fsdp_param_shardings`` and ``DpShards``,
``runtime/trainer.Zero1``, the FSDP step (``fsdp=``) and the train CLI's
``--zero1``/``--fsdp`` — against the JAX package's rules and CLI on the
virtual 8-device mesh, and against the port's own plain data-parallel
steps in one 4-rank gloo group (``torch_zero_worker.py``, started once for
the module; each tp column of its {'dp': 2, 'tp': 2} mesh is a dp 2 group).

Tolerances.  The rules equal the JAX package's exactly.  ZeRO-1 changes
only where AdamW runs (on each rank's slice of the whole gradients, then a
byte-exact gather), and AdamW is elementwise: losses, params, optimizer
state and archives equal the plain run's bit for bit, at dp 2 and at
dp 2 x tp 2.  FSDP at dp 2 equals it bit for bit too: the gathers are
byte-exact and the reduce-scatter adds the same two numbers as the plain
all-reduce, and so at dp 2 x tp 2 without a clip.  With ``--grad-clip``
FSDP's global norm sums each rank's slice's squares before the all-reduce,
another order of additions than the plain run's: there the CLI's losses
are within 1e-6 (plus the 1e-6 of the log's rounding), and every leaf
within 1e-6 of its scale but the key bias's columns, whose gradient is
rounding noise around an exact zero that AdamW scales up to about lr a
step (held to steps x lr, as ``test_torch_parallel_train.py`` holds them).
``--zero1 --fsdp`` is the ``--fsdp`` run bit for bit (FSDP's placement
holds the optimizer's slices already; the JAX package lets it take
precedence).  The JAX CLI's ``--zero1`` run on the same flags: losses
within 1e-5 relative.  The ``eager`` engine on dp 2 x tp 2: fp32 logits within 1e-4 of
the JAX ``xla`` engine's.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from vit_tpu.config import VIT_B_16 as J_B16
from vit_tpu.io import checkpoint as jckpt
from vit_tpu.models import mae as jmae
from vit_tpu.models import vit as jvit
from vit_tpu.parallel import make_mesh as jmake_mesh
from vit_tpu.parallel import sharding as jsharding
from vit_tpu.runtime.engine import InferenceEngine as JaxEngine
from vit_tpu_torch.parallel import sharding as tsharding
from vit_tpu_torch.parallel.mesh import Mesh

import torch_parallel_train_worker as W

REPO = Path(__file__).resolve().parents[1]
# losses within 1e-6, read from --log-jsonl, which rounds them to 6 decimals
LOG_TOL = 1e-6 + 1e-6

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


# -- the rules --------------------------------------------------------------------


def _shapes(which: str, tiny_cfg):
    if which == "tiny":
        return jax.eval_shape(lambda: jvit.init_params(jax.random.key(0), tiny_cfg))
    if which == "b16":
        return jax.eval_shape(lambda: jvit.init_params(jax.random.key(0), J_B16))
    return jax.eval_shape(lambda: jmae.init_mae_params(jax.random.key(0), J_B16,
                                                       jmae.MAEConfig()))


def _meta(tree):
    return {k: _meta(v) if isinstance(v, dict) else torch.empty(v.shape, device="meta")
            for k, v in tree.items()}


@pytest.mark.parametrize("tp", [1, 2])
@pytest.mark.parametrize("dp", [1, 2, 4])
@pytest.mark.parametrize("which", ["tiny", "b16", "mae"])
def test_fsdp_rules_equal_jax(tiny_cfg, which, dp, tp):
    shapes = _shapes(which, tiny_cfg)
    jmesh = jmake_mesh({"dp": dp, "tp": tp}, jax.devices()[:dp * tp])
    want = _flat(jax.tree.map(lambda s: tuple(s.spec), jsharding.fsdp_param_shardings(
        jmesh, shapes), is_leaf=lambda x: hasattr(x, "spec")))
    mesh = Mesh({"dp": dp, "tp": tp}, 0, {})
    whole = _meta(shapes)
    got = _flat(tsharding.fsdp_param_shardings(mesh, whole))
    assert got == want
    # a tp rank's shard gets the whole tree's rules (the axis is chosen
    # among the free axes, which the shard shares with the whole leaf)
    if tp > 1:
        assert _flat(tsharding.fsdp_param_shardings(
            mesh, tsharding.shard_params(whole, mesh))) == want


@pytest.mark.parametrize("dp", [1, 2, 3, 4])
@pytest.mark.parametrize("spec,shape", [
    ((), (768,)), ((), (12, 768)), ((None, "tp"), (12, 2304)),
    ((None, None, "tp"), (12, 768, 2304)),
    ((None, "tp", None), (12, 3072, 768)), ((), (11,)), ((), (7, 5)), (("tp",), (6, 6)),
    ((), (1, 197, 768)),
])
def test_zero1_pspec_equals_jax(spec, shape, dp):
    from jax.sharding import PartitionSpec as P

    for axis_names in (("dp", "tp"), ("tp",)):
        want = jsharding.zero1_pspec(P(*spec), shape, axis_names, dp)
        got = tsharding.zero1_pspec(spec, shape, axis_names, dp)
        assert got == tuple(want)


def test_dp_shards_round_trip_on_one_rank(tiny_cfg):
    # a mesh of one dp rank: the slices are the leaves, and gather gives
    # them back (no process group needed)
    from vit_tpu_torch.models import vit as tvit

    tree = tvit.init_params(torch.Generator().manual_seed(0), W.TINY)
    lay = tsharding.DpShards(tree, Mesh({"dp": 1, "tp": 1}, 0, {}))
    back = _flat(lay.gather(lay.slice(tree)))
    for k, v in _flat(tree).items():
        assert torch.equal(back[k], v), k


# -- the 4-rank group -------------------------------------------------------------


@pytest.fixture(scope="module")
def case(tiny_cfg):
    from vit_tpu.io import weights as wio

    assert tiny_cfg.name == W.TINY.name
    tree = wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=1), tiny_cfg)
    rng = np.random.default_rng(6)
    x = rng.normal(size=(8, 3, 32, 32)).astype(np.float32)
    return tree, x, rng.integers(0, tiny_cfg.num_classes, 8).astype(np.int32)


@pytest.fixture(scope="module")
def group(tmp_path_factory, case):
    d = tmp_path_factory.mktemp("zero")
    tree, x, y = case
    np.savez(d / "in.npz", **{k: np.asarray(v, np.float32) for k, v in _flat(
        tree, "params/").items()}, images=x, labels=y)
    jckpt.save_npz(tree, str(d / "init.npz"))
    (d / "out").mkdir()
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO / 'tests'}", OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "4", "--standalone",
         str(REPO / "tests" / "torch_zero_worker.py"), str(d / "in.npz"),
         str(d / "out" / "res")],
        cwd=d, env=env, capture_output=True, text=True, timeout=400)
    assert out.returncode == 0, out.stderr[-4000:]
    return [dict(np.load(d / "out" / f"res.{r}.npz")) for r in range(4)], d


def _run(res, name):
    return {k[len(name) + 1:]: v for k, v in res.items() if k.startswith(f"{name}/")}


def _equal(a: dict, b: dict, keys=("losses", "params/", "opt/")):
    picked = [k for k in b if k.startswith(keys)]
    assert picked and set(picked) <= set(a)
    for k in picked:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", ["dp_fused_bf16", "dp_eager", "dp_freeze", "tp_fused"])
def test_zero1_step_equals_plain_bit_for_bit(group, name):
    for res in group[0]:
        _equal(_run(res, f"{name}zero1"), _run(res, name))


@pytest.mark.parametrize("name", ["dp_fused_bf16", "dp_eager", "tp_fused"])
def test_zero1_holds_a_dp_slice_of_each_moment(group, case, tiny_cfg, name):
    # each splittable leaf's moments 1/dp of its elements, a leaf with no
    # axis that dp divides whole (the head's bias: 11 classes)
    res = group[0][0]
    plain, zero = res[f"{name}/moment_numel"], res[f"{name}zero1/moment_numel"]
    whole = [n for n, z in zip(plain, zero) if z == n]
    assert all(z * 2 == n for n, z in zip(plain, zero) if z != n)
    assert sum(whole) == tiny_cfg.num_classes  # head/bias alone
    assert res[f"{name}zero1/moment_bytes"] <= 0.55 * res[f"{name}/moment_bytes"]


@pytest.mark.parametrize("name", ["dp_eager_f", "dp_qat_f"])
def test_fsdp_at_dp2_equals_plain_bit_for_bit(group, name):
    for res in group[0]:
        _equal(_run(res, f"{name}fsdp"), _run(res, name))


@pytest.mark.parametrize("name", ["tp_eager_f", "tp_qat_f"])
def test_fsdp_at_dp2_tp2_matches_plain(group, name):
    for res in group[0]:
        _equal(_run(res, f"{name}fsdp"), _run(res, name))


@pytest.mark.parametrize("name", ["dp_eager_f", "dp_qat_f", "tp_eager_f", "tp_qat_f"])
def test_fsdp_params_hold_a_dp_slice(group, name):
    for res in group[0]:
        assert res[f"{name}fsdp/param_bytes"] <= 0.55 * res[f"{name}/param_bytes"]
        assert res[f"{name}fsdp/moment_bytes"] <= 0.55 * res[f"{name}/moment_bytes"]


def test_eager_engine_dp2_tp2_matches_jax_xla(group, case, tiny_cfg):
    tree, x, _ = case
    jmesh = jmake_mesh({"dp": 2, "tp": 2}, jax.devices()[:4])
    want = np.asarray(JaxEngine(tiny_cfg, tree, dtype="float32", ops="xla", mesh=jmesh,
                                batch_pad=4).logits(x))
    for res in group[0]:
        np.testing.assert_allclose(res["eager_dp2tp2_logits"], want, atol=1e-4, rtol=0)


# -- the train CLI ------------------------------------------------------------------


def _losses(path):
    return [json.loads(line)["loss"] for line in Path(path).read_text().splitlines()
            if "loss" in line]


def _archive(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cli_ok(group, name):
    for res in group[0]:
        assert int(res[f"cli_{name}/rc"]) == 0, name


@pytest.mark.parametrize("plain,zero", [("eager", "eager_zero1"), ("fused", "fused_zero1"),
                                        ("mae", "mae_zero1"), ("eager", "eager_fsdp"),
                                        ("eager_fsdp", "eager_zero1_fsdp"),
                                        ("resume_plain", "resume_plain_zero1"),
                                        ("resume_plain", "resume_zero1_plain"),
                                        ("resume_plain", "resume_plain_fsdp"),
                                        ("resume_plain", "resume_fsdp_plain")])
def test_train_cli_zero_runs_equal_plain_runs(group, plain, zero):
    _cli_ok(group, plain)
    _cli_ok(group, zero)
    d = group[1] / "out"
    got, want = _archive(d / f"{zero}.state.npz"), _archive(d / f"{plain}.state.npz")
    assert got.keys() == want.keys()
    exact = "fsdp" not in zero or "fsdp" in plain  # FSDP against FSDP: bit for bit
    got_l, want_l = _losses(d / f"{zero}.jsonl"), _losses(d / f"{plain}.jsonl")
    if exact:
        assert got_l == want_l
    else:  # dp 2 x tp 2 (module docstring)
        np.testing.assert_allclose(got_l, want_l, atol=LOG_TOL, rtol=0)
    for k in want:
        if exact or want[k].dtype.kind != "f":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            _within_scale(got[k], want[k], k, int(want["__step__"]))
    ema = d / f"{plain}.state.ema.npz"
    if ema.exists():
        g, w = _archive(d / f"{zero}.state.ema.npz"), _archive(ema)
        for k in w:
            if exact:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                _within_scale(g[k], w[k], k, int(want["__step__"]))


def _key_columns(cfg):
    """Mask of the packed QKV's key columns ((head, {q,k,v}, dh) order)."""
    dh = cfg.embed_dim // cfg.num_heads
    return (np.arange(3 * cfg.embed_dim) // dh) % 3 == 1


def _within_scale(got, want, k, steps):
    """Within 1e-6 of the leaf's scale; the key bias's columns, whose
    gradient is rounding noise around an exact zero that AdamW scales up to
    about lr a step, within steps x lr (module docstring)."""
    if k.endswith("blocks/bqkv"):
        kc = _key_columns(W.TINY)
        bound = steps * 1e-3 + 1e-6
        assert np.abs(got[..., kc]).max() <= bound and np.abs(want[..., kc]).max() <= bound
        got, want = got[..., ~kc], want[..., ~kc]
    assert np.abs(got - want).max() <= 1e-6 * max(1.0, np.abs(want).max()), k


def test_train_cli_qat_fsdp_matches_plain(group):
    _cli_ok(group, "qat")
    _cli_ok(group, "qat_fsdp")
    d = group[1] / "out"
    np.testing.assert_allclose(_losses(d / "qat_fsdp.jsonl"), _losses(d / "qat.jsonl"),
                               atol=LOG_TOL, rtol=0)
    got, want = _archive(d / "qat_fsdp.state.npz"), _archive(d / "qat.state.npz")
    for k in want:
        if want[k].dtype.kind == "f":
            _within_scale(got[k], want[k], k, 3)


def test_train_cli_zero1_matches_the_jax_cli(group, tiny_cfg):
    import vit_tpu.config as jconfig
    from vit_tpu.cli.train import main as jmain

    _, d = group
    jconfig.CONFIGS[tiny_cfg.name] = tiny_cfg
    try:
        rc = jmain(["--config", tiny_cfg.name, "--init-weights", str(d / "init.npz"),
                    "--batch", "4", "--lr", "0.001", "--weight-decay", "0.05", "--dp", "2",
                    "--tp", "2", "--ops", "xla", "--steps", "3", "--zero1",
                    "--wd-exempt-norm-bias", "--grad-clip", "0.05", "--skip-nonfinite",
                    "--ema-decay", "0.9", "--no-compile-cache",
                    "--log-jsonl", str(d / "jax_zero1.jsonl")])
    finally:
        jconfig.CONFIGS.pop(tiny_cfg.name, None)
    assert rc == 0
    want = _losses(d / "jax_zero1.jsonl")
    got = _losses(d / "out" / "eager_zero1.jsonl")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=0)
    # the stdout names the flags' effect once, on rank 0
    assert "grad-clip: global norm 0.05" in str(group[0][0]["cli_eager_zero1/stdout"])
