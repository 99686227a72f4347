"""Pipeline parallelism in the port (``vit_tpu_torch/parallel/pipeline.py``)
and the train CLI's ``--pp``/``--microbatches`` against the JAX package on
the CPU: its ``shard_forward_pp``/``make_pp_train_step`` on the virtual
8-device mesh (Pallas in interpret mode), the port in one 4-rank gloo group
(``torch_pp_sp_worker.py pp``, started once for the module: two pipelines of
pp 2, pp 4, dp 2 x pp 2 and pp 2 x tp 2), and against the port's own
single-rank steps, which catch a replicated leaf's gradient counted twice or
not at all.

Tolerances (``tests/test_pipeline.py``'s): forwards 1e-5, the microbatch
count 1e-6, SGD steps loss 1e-6 and every leaf 1e-4 (atol and rtol); the
CLI as ``test_torch_parallel_train.py`` holds its AdamW runs (loss 1e-4,
leaves 1e-4 with the key bias within its Adam bound).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from vit_tpu.config import ViTConfig as JViTConfig
from vit_tpu.io import checkpoint as jckpt
from vit_tpu.models import vit as jvit
from vit_tpu.ops import quant as jquant
from vit_tpu.parallel import make_mesh as jmake_mesh
from vit_tpu.parallel.pipeline import make_pp_train_step as jmake_pp_train_step
from vit_tpu.parallel.pipeline import pp_param_pspecs as jpp_param_pspecs
from vit_tpu.parallel.pipeline import shard_forward_pp as jshard_forward_pp
from vit_tpu_torch.cli import common
from vit_tpu_torch.cli.train import main as tmain
from vit_tpu_torch.io import checkpoint as tckpt
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.parallel.mesh import Mesh
from vit_tpu_torch.parallel.pipeline import make_pp_train_step, shard_forward_pp
from vit_tpu_torch.runtime import trainer as ttrainer

import torch_pp_sp_worker as W

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")

JCFG = JViTConfig(**dataclasses.asdict(W.PP))


def _leaf_close(got: dict, want: dict, atol: float, rtol: float = 0.0, adam_steps: int = 0):
    W.leaf_close(got, want, W.PP, atol, rtol, adam_steps)


@pytest.fixture(scope="module")
def data():
    """The params (the JAX package's initializer), images and labels."""
    rng = np.random.default_rng(5)
    return {"params": W.flatten(jax.device_get(jvit.init_params(jax.random.key(0), JCFG))),
            "images": rng.normal(size=(8, 3, 32, 32)).astype(np.float32),
            "labels": rng.integers(0, W.PP.num_classes, 8).astype(np.int32)}


@pytest.fixture(scope="module")
def group(tmp_path_factory, data):
    """The four ranks' results of ``torch_pp_sp_worker.py pp``."""
    d = tmp_path_factory.mktemp("pp_group")
    jckpt.save_npz(W.unflatten(data["params"]), str(d / "init.npz"))
    arrays = {f"params/{k}": v for k, v in data["params"].items()}
    arrays.update(images=data["images"], labels=data["labels"])
    return W.start_group("pp", d, arrays), d


def _jtree(data):
    return jax.tree.map(jnp.asarray, W.unflatten(data["params"]))


def _place(params, mesh):
    specs = jpp_param_pspecs(params, mesh.axis_names)
    return jax.device_put(params, jax.tree.map(lambda s: NamedSharding(mesh, s), specs,
                                               is_leaf=lambda x: isinstance(x, PartitionSpec)))


@pytest.fixture(scope="module")
def jax_ref(data):
    """The JAX package's pipelined forwards and SGD steps, each once."""
    params = _jtree(data)
    x, y = jnp.asarray(data["images"]), jnp.asarray(data["labels"])
    pp2 = jmake_mesh({"pp": 2}, jax.devices()[:2])
    pp4 = jmake_mesh({"pp": 4}, jax.devices()[:4])
    pptp = jmake_mesh({"pp": 2, "tp": 2}, jax.devices()[:4])
    out = {}
    for name, mesh, m, ops, tree in (
            ("eager_pp2", pp2, 4, "xla", params), ("eager_pp4", pp4, 4, "xla", params),
            ("fused_pp2", pp2, 4, "fused", params), ("fused_pp2tp2", pptp, 2, "fused", params),
            ("quant_pp2tp2", pptp, 2, "quant",
             jquant.cast_quantized_params(jquant.quantize_params(params), jnp.float32))):
        fwd = jax.jit(jshard_forward_pp(JCFG, mesh, num_microbatches=m, ops_name=ops))
        out[name] = np.asarray(fwd(_place(tree, mesh), x))
    for name, mesh, m, ops in (("train_eager_pp2", pp2, 4, "xla"),
                               ("train_fused_pp2", pp2, 4, "fused_train"),
                               ("train_fused_pp2tp2", pptp, 2, "fused_train")):
        opt = optax.sgd(W.SGD_LR)
        p = _place(params, mesh)
        step = jmake_pp_train_step(JCFG, opt, mesh, num_microbatches=m, ops_name=ops)
        p_out, _, loss = step(p, opt.init(p), x, y)
        out[name] = (W.flatten(jax.device_get(p_out)), float(loss))
    return out


def _port_single(data, cfg=W.PP, ops="fused_train", **kw):
    """The port's single-rank SGD step on the same params and batch."""
    params = ttrainer.as_trainable(params_from_numpy(W.unflatten(data["params"]), "cpu"), "cpu")
    step = ttrainer.make_train_step(cfg, W.sgd(params), get_ops(ops), remat=False, **kw)
    loss = step(params, torch.from_numpy(data["images"]), torch.from_numpy(data["labels"]))
    return W.flatten(params_to_numpy(params)), float(loss)


def test_ranks_agree(group):
    # every gathered leaf and logit the same bits on every rank (the two
    # pp 2 pipelines included)
    ranks, _ = group
    for key in ranks[0]:
        if key.startswith(("cli", "local_wqkv")):
            continue
        for r in ranks[1:]:
            np.testing.assert_array_equal(ranks[0][key], r[key], err_msg=key)


@pytest.mark.parametrize("name,jname", [
    ("eager_pp2", "eager_pp2"), ("eager_pp4", "eager_pp4"), ("fused_pp2", "fused_pp2"),
    ("fused_pp4", "fused_pp2"), ("eager_dp2pp2", "eager_pp2"),
    ("fused_pp2tp2", "fused_pp2tp2"), ("fused_train_pp2tp2", "fused_pp2tp2"),
    ("quant_pp2tp2", "quant_pp2tp2")])
def test_forward_matches_jax_shard_forward_pp(group, jax_ref, name, jname):
    got = group[0][0][f"{name}/logits"]
    assert got.shape == (8, W.PP.num_classes)
    np.testing.assert_allclose(got, jax_ref[jname], atol=1e-5, rtol=0)


def test_microbatch_count_does_not_change_the_result(group):
    r0 = group[0][0]
    np.testing.assert_allclose(r0["eager_pp2_m2/logits"], r0["eager_pp2_m8/logits"], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("name", ["train_eager_pp2", "train_fused_pp2", "train_fused_pp2tp2"])
def test_train_step_matches_jax_make_pp_train_step(group, jax_ref, name):
    want, want_loss = jax_ref[name]
    r0 = group[0][0]
    assert abs(float(r0[f"{name}/loss"]) - want_loss) <= 1e-6
    _leaf_close(W.res_tree(r0, name), want, 1e-4, 1e-4)


@pytest.mark.parametrize("name,ops", [("train_eager_pp2", "eager"),
                                      ("train_fused_pp2", "fused_train"),
                                      ("train_fused_dp2pp2", "fused_train"),
                                      ("train_fused_pp2tp2", "fused_train")])
def test_train_step_matches_single_rank(group, data, name, ops):
    # the embeddings (stage 0's alone), the final LN and the heads (every
    # stage's) counted once each
    want, want_loss = _port_single(data, ops=ops)
    r0 = group[0][0]
    assert abs(float(r0[f"{name}/loss"]) - want_loss) <= 1e-6
    _leaf_close(W.res_tree(r0, name), want, 1e-4, 1e-4)


def test_grad_clip_takes_the_norm_over_every_stage(group, data):
    # 0.05 binds: a norm over one stage's blocks, or the whole leaves counted
    # once a stage, moves every update by its ratio
    want, want_loss = _port_single(data, ops="eager", grad_clip=0.05)
    free, _ = _port_single(data, ops="eager")
    start = data["params"]
    assert max(np.abs(free[k] - start[k]).max() - np.abs(want[k] - start[k]).max()
               for k in want) > 1e-3
    r0 = group[0][0]
    assert abs(float(r0["train_clip_pp2/loss"]) - want_loss) <= 1e-6
    _leaf_close(W.res_tree(r0, "train_clip_pp2"), want, 1e-5)


@pytest.mark.parametrize("ops", ["eager", "fused_train"])
def test_regularized_one_microbatch_matches_single_rank(group, data, ops):
    # absolute-layer seeds and drop-path rates on both stages: one
    # microbatch regenerates the single-rank step's masks
    want, want_loss = _port_single(data, W.REG, ops, use_dropout=True,
                                   rng=torch.Generator().manual_seed(21))
    r0 = group[0][0]
    assert abs(float(r0[f"drop_{ops}_m1/loss"]) - want_loss) <= 1e-6
    _leaf_close(W.res_tree(r0, f"drop_{ops}_m1"), want, 1e-4, 1e-4)


def test_regularized_microbatches_draw_their_own_masks(group):
    r0 = group[0][0]
    a, b = float(r0["drop_m2/loss"]), float(r0["drop_m2_again/loss"])
    assert np.isfinite(a) and a == b  # deterministic in the rng
    assert abs(a - float(r0["drop_fused_train_m1/loss"])) > 1e-6  # other masks
    # zero rates: the regularized schedule is the plain one, bit for bit
    assert float(r0["zero_rates_m2/loss"]) == float(r0["plain_m2/loss"])
    zero, plain = W.res_tree(r0, "zero_rates_m2"), W.res_tree(r0, "plain_m2")
    for k in plain:
        np.testing.assert_array_equal(zero[k], plain[k], err_msg=k)


def test_stages_split_and_gather_back(group):
    r0, r1, r2, r3 = group[0]
    assert all(bool(r["roundtrip_pp4"]) and bool(r["roundtrip_pp2tp2"]) for r in group[0])
    assert r0["local_wqkv_pp4"].tolist() == [1, 64, 192]  # one layer a stage
    assert r1["local_wqkv_pp2tp2"].tolist() == [2, 64, 96]  # two layers, half the heads


# -- the train CLI ---------------------------------------------------------------


def _losses(path):
    return [json.loads(line)["loss"] for line in Path(path).read_text().splitlines()]


@pytest.fixture(scope="module")
def jax_cli(group, tmp_path_factory):
    """The JAX CLI at --pp 2 --dp 2 for 4 steps: its losses and saved tree."""
    import vit_tpu.config as jconfig
    from vit_tpu.cli.train import main as jmain

    _, d = group
    out = tmp_path_factory.mktemp("jax_pp_cli")
    jconfig.CONFIGS[JCFG.name] = JCFG
    try:
        assert jmain(["--config", JCFG.name, "--init-weights", str(d / "init.npz"), "--steps",
                      "4", "--batch", "4", "--ops", "xla", "--no-compile-cache", "--dp", "2",
                      "--pp", "2", "--microbatches", "2", "--log-jsonl", str(out / "l.jsonl"),
                      "--save", str(out / "p.npz")]) == 0
    finally:
        jconfig.CONFIGS.pop(JCFG.name, None)
    return _losses(out / "l.jsonl"), out / "p.npz"


def test_train_cli_pp_matches_jax_cli(group, jax_cli, data):
    # 3 steps with --save-state, then --resume for the 4th: the JAX CLI's 4
    # straight steps (the archive a one-card one: whole leaves)
    ranks, d = group
    for name in ("cli", "cli_resumed"):
        assert all(int(r[f"{name}/rc"]) == 0 for r in ranks)
        assert all(int(r[f"{name}/stdout_lines"]) == 0 for r in ranks[1:])  # rank 0 prints
    out = str(ranks[0]["cli/stdout"])
    assert "pipeline: 2 stage(s), 2 microbatches" in out
    assert "mesh: {'dp': 2, 'pp': 2} over 4 rank(s), backend gloo" in out
    assert "resumed from" in str(ranks[0]["cli_resumed/stdout"])
    got = _losses(d / "out" / "cli.jsonl") + _losses(d / "out" / "cli_resumed.jsonl")
    want, jnpz = jax_cli
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _leaf_close(W.flatten(jckpt.load_npz(str(d / "out" / "cli_resumed.npz"))),
                W.flatten(jckpt.load_npz(str(jnpz))), 1e-4, adam_steps=4)
    # the archive holds whole leaves and moments: the one-card template's
    template = ttrainer.opt_state_shapes(params_from_numpy(W.unflatten(data["params"]), "cpu"))
    params, _, step = tckpt.load_train_state(str(d / "out" / "state.npz"), template)
    assert step == 3 and np.asarray(params["blocks"]["wqkv"]).shape == (4, 64, 192)


# -- the refusals, in the JAX package's words ----------------------------------------


def _mesh(shape):
    return Mesh(shape, 0, {})  # no process group: the refusals come first


@pytest.mark.parametrize("make,message", [
    (lambda: shard_forward_pp(W.PP, _mesh({"dp": 2}), 2), "has no 'pp' axis"),
    (lambda: shard_forward_pp(W.PP, _mesh({"pp": 2, "tp": 2}), 2, ops_name="fused",
                              use_dropout=True), "no regularized train variant"),
    (lambda: shard_forward_pp(W.PP, _mesh({"pp": 2}), 2, ops_name="fused",
                              use_dropout=True), "pp dropout/drop-path needs ops"),
    (lambda: shard_forward_pp(W.PP, _mesh({"pp": 2, "tp": 2}), 2, ops_name="eager"),
     "tp composition needs 'fused'/'fused_train'/'quant'"),
    (lambda: shard_forward_pp(W.PP, _mesh({"pp": 2}), 2, ops_name="quant"),
     "without a 'tp' axis use 'eager'/'fused'/'fused_train'"),
    (lambda: shard_forward_pp(dataclasses.replace(W.PP, depth=3), _mesh({"pp": 2}), 2),
     "pp=2 must divide depth=3"),
    (lambda: shard_forward_pp(W.PP, _mesh({"pp": 2, "tp": 3}), 2, ops_name="fused"),
     "tp=3 must divide num_heads=4"),
    (lambda: shard_forward_pp(W.PP, _mesh({"pp": 2}), 4)(None, torch.zeros(6, 3, 32, 32)),
     "num_microbatches 4 must divide the per-dp-shard batch 6"),
    (lambda: make_pp_train_step(W.PP, None, _mesh({"pp": 2}), 2, ops_name="fused"),
     "pp training needs 'eager' or 'fused_train'"),
    (lambda: make_pp_train_step(W.PP, None, _mesh({"pp": 2}), 2, use_dropout=True),
     "use_dropout needs rng"),
], ids=["no_pp_axis", "dropout_tp", "dropout_fused", "tp_eager", "quant_no_tp", "depth",
        "tp_heads", "microbatches", "train_fused", "dropout_rng"])
def test_library_refusals(make, message):
    with pytest.raises(ValueError, match=message):
        make()


@pytest.fixture
def fake_mesh(monkeypatch):
    """The CLI's mesh of the flags, without a process group."""
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(tconfig.CONFIGS, W.PP.name, W.PP)
    deit = dataclasses.replace(W.PP, distilled=True, name="deit_tiny_pp")
    monkeypatch.setitem(tconfig.CONFIGS, deit.name, deit)

    def resolve(dp, tp, device, backend=None, pp=1, sp=1):
        shape = {"dp": dp or 1, "pp": pp, **({"tp": tp} if tp > 1 else {})}
        return Mesh(shape, 0, {}), device

    monkeypatch.setattr(common, "resolve_mesh", resolve)
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, op=None, group=None: None)


BASE = ["--config", W.PP.name, "--steps", "1", "--batch", "4", "--device", "cpu"]


@pytest.mark.parametrize("flags,message", [
    (["--mixed-precision"], "error: --pp supports the plain optimizer at the params' dtype "
     "(no --mixed-precision/--optimizer fused_adamw)"),
    (["--optimizer", "fused_adamw", "--ops", "fused_train"],
     "error: --pp supports the plain optimizer at the params' dtype"),
    (["--ops", "qat"], "error: --pp supports --ops eager or fused_train"),
    (["--tp", "2", "--ops", "eager"],
     "error: --pp with --tp requires --ops fused_train (the tensor-parallel fused block)"),
    (["--microbatches", "3"], "error: dp=1 must divide --batch 4, and --microbatches 3 must "
     "divide the per-shard batch 4"),
    (["--tome", "2"], "error: --tome training requires --ops fused_train or eager on a dp mesh"),
    (["--mae"], "error: --mae is self-supervised pretraining"),
    (["--augment", "flip"],
     "error: --augment/--grad-accum support the dp paths only (no --pp/--tp/--sp)"),
    (["--grad-accum", "2"],
     "error: --augment/--grad-accum support the dp paths only (no --pp/--tp/--sp)"),
    (["--config", "deit_tiny_pp", "--distill-teacher", "teacher.npz"],
     "error: --distill-teacher composes with --dp/--tp only (no --pp/--sp)"),
], ids=["mixed_precision", "fused_adamw", "qat", "tp_eager", "microbatches", "tome", "mae",
        "augment", "grad_accum", "distill"])
def test_cli_refusals_in_jax_words(fake_mesh, capsys, flags, message):
    assert tmain([*BASE, "--pp", "2", *flags]) == 2
    assert message in capsys.readouterr().err


def test_cli_refuses_pp_not_dividing_depth(fake_mesh, capsys):
    assert tmain([*BASE, "--pp", "3"]) == 2
    assert "error: --pp 3 must divide depth 4" in capsys.readouterr().err


def test_cli_pp_needs_a_torchrun_world(monkeypatch, capsys):
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(tconfig.CONFIGS, W.PP.name, W.PP)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmain([*BASE, "--pp", "2"]) == 2
    assert "--pp 2 need one process per rank" in capsys.readouterr().err


def test_train_parser_takes_the_pipeline_flags():
    from vit_tpu.cli.train_args import build_parser as jbuild

    from vit_tpu_torch.cli.train_args import build_parser

    args, jargs = build_parser().parse_args([]), jbuild().parse_args([])
    assert (args.pp, args.microbatches, args.sp) == (jargs.pp, jargs.microbatches, jargs.sp)
    args = build_parser().parse_args(["--pp", "2", "--microbatches", "8"])
    assert (args.pp, args.microbatches) == (2, 8)
