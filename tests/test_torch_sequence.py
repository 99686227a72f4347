"""Sequence parallelism in the port (``vit_tpu_torch/parallel/sequence.py``:
ring attention, ``shard_forward_sp``, ``make_sp_train_step``), the mesh's
cyclic shift and broadcast, and the train CLI's ``--sp`` against the JAX
package on the CPU: its ``shard_forward_sp``/``make_sp_train_step`` on the
virtual 8-device mesh (Pallas in interpret mode) and its single-device
forward, the port in one 4-rank gloo group (``torch_pp_sp_worker.py sp``,
started once for the module: two rings of sp 2, sp 4 and dp 2 x sp 2), and
against the port's own single-rank steps.

Tolerances (``tests/test_sequence_parallel.py``'s): forwards 1e-5, the
4,097-token ring 2e-4, SGD steps loss 1e-6 and every leaf 1e-4 (atol and
rtol); bf16 mixed precision as ``test_torch_train.py`` holds it (loss 2e-2,
each leaf's update within 2e-2 of its largest); the CLI as
``test_torch_parallel_train.py`` holds its AdamW runs.
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

from vit_tpu.config import ViTConfig as JViTConfig
from vit_tpu.io import checkpoint as jckpt
from vit_tpu.models import vit as jvit
from vit_tpu.ops import reference as jref
from vit_tpu.parallel import make_mesh as jmake_mesh
from vit_tpu.parallel.sequence import make_sp_train_step as jmake_sp_train_step
from vit_tpu.parallel.sequence import shard_forward_sp as jshard_forward_sp
from vit_tpu_torch.cli import common, train_setup
from vit_tpu_torch.cli.train import main as tmain
from vit_tpu_torch.cli.train_args import build_parser
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.parallel.mesh import Mesh
from vit_tpu_torch.parallel.sequence import make_sp_train_step, shard_forward_sp
from vit_tpu_torch.runtime import trainer as ttrainer

import torch_pp_sp_worker as W

pytestmark = pytest.mark.skipif(jax.device_count() < 8, reason="needs 8 (virtual) devices")

def _jcfg(cfg):
    return JViTConfig(**dataclasses.asdict(cfg))


_flat, _tree, _res_tree = W.flatten, W.unflatten, W.res_tree


def _leaf_close(got, want, atol, rtol=0.0, adam_steps=0):
    W.leaf_close(got, want, W.SP, atol, rtol, adam_steps)


def _images(seed, n, cfg):
    return np.random.default_rng(seed).normal(
        size=(n, 3, cfg.image_size, cfg.image_size)).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    """Params (the JAX package's initializer) and batches of every case."""
    rng = np.random.default_rng(0)
    out = {"sp/params": _flat(jax.device_get(jvit.init_params(jax.random.key(6),
                                                              _jcfg(W.SP)))),
           "sp/images": _images(7, 4, W.SP),
           "sp/labels": rng.integers(0, W.SP.num_classes, 4).astype(np.int32)}
    for i, (name, cfg) in enumerate(W.SP_CONFIGS.items()):
        out[f"{name}/params"] = _flat(jax.device_get(
            jvit.init_params(jax.random.key(10 + i), _jcfg(cfg))))
        out[f"{name}/images"] = _images(20 + i, 1 if name == "sp_long" else 2, cfg)
    out["ring"] = {"x": rng.normal(size=(2, 22, 64)).astype(np.float32),
                   "wqkv": (rng.normal(size=(64, 192)) * 0.1).astype(np.float32),
                   "bqkv": (rng.normal(size=(192,)) * 0.1).astype(np.float32),
                   "wo": (rng.normal(size=(64, 64)) * 0.1).astype(np.float32),
                   "bo": (rng.normal(size=(64,)) * 0.1).astype(np.float32)}
    special = rng.normal(size=(4, 3, 5)).astype(np.float32)
    special[0, 0, :4] = (-0.0, np.inf, -np.inf, np.nan)
    special[2, 1, 1] = np.float32(1e-40)  # a subnormal
    out["shift/f32"] = special
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory, data):
    """The four ranks' results of ``torch_pp_sp_worker.py sp``."""
    d = tmp_path_factory.mktemp("sp_group")
    jckpt.save_npz(_tree(data["sp/params"]), str(d / "init.npz"))
    arrays = {}
    for key, value in data.items():
        if isinstance(value, dict):
            arrays.update({f"{key}/{k}": v for k, v in value.items()})
        else:
            arrays[key] = value
    return W.start_group("sp", d, arrays), d


def _jparams(data, name):
    return jax.tree.map(jnp.asarray, _tree(data[f"{name}/params"]))


@pytest.fixture(scope="module")
def jax_ref(data):
    """The JAX package's sequence-parallel forwards and SGD steps, and its
    single-device forwards, each once."""
    sp4 = jmake_mesh({"sp": 4}, jax.devices()[:4])
    sp2 = jmake_mesh({"sp": 2}, jax.devices()[:2])
    jcfg = _jcfg(W.SP)
    params, x = _jparams(data, "sp"), jnp.asarray(data["sp/images"])
    y = jnp.asarray(data["sp/labels"])
    out = {"sp": np.asarray(jax.jit(jshard_forward_sp(jcfg, sp4))(params, x))}
    for name, cfg in W.SP_CONFIGS.items():
        xc = jnp.asarray(data[f"{name}/images"])
        if name in ("sp64", "sp96"):
            fwd = jax.jit(jshard_forward_sp(_jcfg(cfg), sp4))
        else:  # the distilled and the 4,097-token configs: the single device's
            fwd = jax.jit(jvit.logits_fn(_jcfg(cfg)))
        out[name] = np.asarray(fwd(_jparams(data, name), xc))
    for name, mesh, kw in (("train_eager_sp4", sp4, {}),
                           ("train_fused_sp4", sp4, {"ops_name": "fused_train"}),
                           ("train_bf16_eager_sp2", sp2, {"compute_dtype": jnp.bfloat16})):
        opt = optax.sgd(0.1)
        step = jmake_sp_train_step(jcfg, opt, mesh, **kw)
        p, _, loss = step(params, opt.init(params), x, y)
        out[name] = (_flat(jax.device_get(p)), float(loss))
    return out


def _port_single(data, compute_dtype=None):
    """The port's single-rank eager SGD step (lr 0.1) on the same batch."""
    params = ttrainer.as_trainable(params_from_numpy(_tree(data["sp/params"]), "cpu"), "cpu")
    step = ttrainer.make_train_step(W.SP, W.sgd(params, 0.1), get_ops("eager"), remat=False,
                                    compute_dtype=compute_dtype)
    loss = step(params, torch.from_numpy(data["sp/images"]), torch.from_numpy(data["sp/labels"]))
    return _flat(params_to_numpy(params)), float(loss)


def test_ranks_agree(group):
    # the logits and the params after every step the same bits on every rank
    ranks, _ = group
    for key in ranks[0]:
        if key.startswith(("cli", "ring/", "shift/", "bcast/")):
            continue
        for r in ranks[1:]:
            np.testing.assert_array_equal(ranks[0][key], r[key], err_msg=key)


def test_ring_attention_matches_plain_attention_with_padding_keys(group, data):
    # 22 tokens padded to 24 over sp 4: the padded keys masked, the padded
    # query rows dropped
    ring = data["ring"]
    got = np.concatenate([r["ring/out"] for r in group[0]], axis=1)[:, :22]
    want = np.asarray(jref.attention(*(jnp.asarray(ring[k]) for k in
                                       ("x", "wqkv", "bqkv", "wo", "bo")), 4))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_shift_is_bit_exact(group, data, dtype):
    # signed zero, infinities, NaN and a subnormal cross unchanged
    ranks, _ = group
    sent = data["shift/f32"].view(np.int32)
    for r in range(4):
        if dtype == "f32":  # rank r receives rank r - 1's
            np.testing.assert_array_equal(ranks[r]["shift/f32"], sent[(r - 1) % 4])
        else:  # offset -1: rank r receives rank r + 1's
            np.testing.assert_array_equal(ranks[r]["shift/bf16"],
                                          ranks[(r + 1) % 4]["shift/sent_bf16"])


def test_shift_backward_is_the_reverse_shift(group):
    # sum(w_r * x_{r-1}) over ranks: d/dx_r = w_{r+1}, rank r + 1's weights
    ranks, _ = group
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["shift/grad"],
                                      np.arange(4.0, dtype=np.float32) * ((r + 1) % 4 + 1))


def test_broadcast_sends_the_source_and_keeps_its_gradient_there(group):
    ranks, _ = group
    for r in range(4):
        np.testing.assert_array_equal(ranks[r]["bcast/value"], np.full(3, 2.0, np.float32))
        np.testing.assert_array_equal(ranks[r]["bcast/grad"], np.full(3, 2.0 if r == 1 else 0.0,
                                                                      np.float32))


@pytest.mark.parametrize("name,jname,tol", [
    ("eager_sp4", "sp", 1e-5), ("fused_train_sp4", "sp", 1e-5), ("eager_dp2sp2", "sp", 1e-5),
    ("sp64", "sp64", 1e-5), ("sp96", "sp96", 1e-5), ("deit", "deit", 1e-5),
    ("sp_long", "sp_long", 2e-4)],
    ids=["eager_sp4_padding_shard", "fused_train_sp4", "dp2_x_sp2", "image64_partial_padding",
         "image96_row_window", "distilled_two_prefix_tokens", "tokens4097_sp4"])
def test_forward_matches_jax(group, jax_ref, name, jname, tol):
    got = group[0][0][f"{name}/logits"]
    assert got.shape == jax_ref[jname].shape
    np.testing.assert_allclose(got, jax_ref[jname], atol=tol, rtol=0)


@pytest.mark.parametrize("name", ["train_eager_sp4", "train_fused_sp4"])
def test_train_step_matches_jax_make_sp_train_step(group, jax_ref, name):
    want, want_loss = jax_ref[name]
    r0 = group[0][0]
    assert abs(float(r0[f"{name}/loss"]) - want_loss) <= 1e-6
    _leaf_close(_res_tree(r0, name), want, 1e-4, 1e-4)


@pytest.mark.parametrize("name", ["train_eager_sp4", "train_fused_sp4", "train_fused_dp2sp2"])
def test_train_step_matches_single_rank(group, data, name):
    # the ring's backward and the sums over sp: every leaf but the heads
    # holds a shard's part
    want, want_loss = _port_single(data)
    r0 = group[0][0]
    assert abs(float(r0[f"{name}/loss"]) - want_loss) <= 1e-6
    _leaf_close(_res_tree(r0, name), want, 1e-4, 1e-4)


def _updates_close(got, want, start, rel):
    for k in want:
        step = np.abs(want[k] - start[k]).max()
        assert np.abs(got[k] - want[k]).max() <= rel * step + 1e-6, k


@pytest.mark.parametrize("ops", ["eager", "fused_train"])
def test_bf16_mixed_step_matches_single_rank_and_jax(group, data, jax_ref, ops):
    name = f"train_bf16_{ops}_sp2"
    got = _res_tree(group[0][0], name)
    assert all(v.dtype == np.float32 for v in got.values())  # fp32 masters
    loss = float(group[0][0][f"{name}/loss"])
    start = _flat(_tree(data["sp/params"]))
    for want, want_loss in (_port_single(data, torch.bfloat16), jax_ref["train_bf16_eager_sp2"]):
        assert abs(loss - want_loss) <= 2e-2
        _updates_close(got, want, start, 2e-2)


# -- the train CLI ---------------------------------------------------------------


def _losses(path):
    return [json.loads(line)["loss"] for line in Path(path).read_text().splitlines()]


def test_train_cli_sp_matches_jax_cli(group, tmp_path):
    import vit_tpu.config as jconfig
    from vit_tpu.cli.train import main as jmain

    ranks, d = group
    jcfg = _jcfg(W.SP)
    jconfig.CONFIGS[jcfg.name] = jcfg
    try:
        assert jmain(["--config", jcfg.name, "--init-weights", str(d / "init.npz"), "--steps",
                      "3", "--batch", "4", "--ops", "xla", "--no-compile-cache", "--dp", "2",
                      "--sp", "2", "--label-smoothing", "0.1",
                      "--log-jsonl", str(tmp_path / "l.jsonl"),
                      "--save", str(tmp_path / "p.npz")]) == 0
    finally:
        jconfig.CONFIGS.pop(jcfg.name, None)
    assert all(int(r["cli/rc"]) == 0 for r in ranks)
    assert all(int(r["cli/stdout_lines"]) == 0 for r in ranks[1:])  # rank 0 alone prints
    out = str(ranks[0]["cli/stdout"])
    assert "sequence parallel: ring size 2 (ops eager)" in out
    assert "mesh: {'dp': 2, 'sp': 2} over 4 rank(s), backend gloo" in out
    got, want = _losses(d / "out" / "cli.jsonl"), _losses(tmp_path / "l.jsonl")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    _leaf_close(_flat(jckpt.load_npz(str(d / "out" / "cli.npz"))),
                _flat(jckpt.load_npz(str(tmp_path / "p.npz"))), 1e-4, adam_steps=3)


# -- the refusals, in the JAX package's words ----------------------------------------


def _mesh(shape):
    return Mesh(shape, 0, {})


@pytest.mark.parametrize("make,message", [
    (lambda: shard_forward_sp(W.SP, _mesh({"sp": 2}), ops_name="fused"),
     "sp ops 'fused': use 'eager' or 'fused_train'"),
    (lambda: shard_forward_sp(W.SP, _mesh({"dp": 2})), "has no 'sp' axis"),
    (lambda: make_sp_train_step(W.SP_CONFIGS["deit"], None, _mesh({"sp": 18})),
     "sp=18 leaves 1 tokens/shard < 2 prefix tokens"),
], ids=["ops", "no_sp_axis", "prefix"])
def test_library_refusals(make, message):
    with pytest.raises(ValueError, match=message):
        make()


@pytest.fixture
def fake_mesh(monkeypatch):
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(tconfig.CONFIGS, W.SP.name, W.SP)
    deit = W.SP_CONFIGS["deit"]
    monkeypatch.setitem(tconfig.CONFIGS, deit.name, deit)

    def resolve(dp, tp, device, backend=None, pp=1, sp=1):
        return Mesh({"dp": dp or 1, "sp": sp}, 0, {}), device

    monkeypatch.setattr(common, "resolve_mesh", resolve)
    monkeypatch.setattr(torch.distributed, "all_reduce", lambda t, op=None, group=None: None)


BASE = ["--config", W.SP.name, "--steps", "1", "--batch", "4", "--device", "cpu"]


@pytest.mark.parametrize("flags,message", [
    (["--pp", "2"], "error: --sp composes with --dp only (no --pp/--tp)"),
    (["--tp", "2"], "error: --sp composes with --dp only (no --pp/--tp)"),
    (["--optimizer", "fused_adamw"], "error: --sp supports the plain optimizer"),
    (["--ops", "qat"], "error: --sp requires --ops eager or fused_train"),
    (["--dropout", "0.1"], "error: --dropout/--drop-path require --ops eager, qat, or "
     "fused_train on a dp or dp x pp mesh (no --tp/--sp)"),
    (["--drop-path", "0.1"], "error: --dropout/--drop-path require --ops eager, qat, or "
     "fused_train on a dp or dp x pp mesh (no --tp/--sp)"),
    (["--tome", "2"], "error: --tome training requires --ops fused_train or eager on a dp mesh"),
    (["--mae"], "error: --mae is self-supervised pretraining"),
    (["--augment", "flip"],
     "error: --augment/--grad-accum support the dp paths only (no --pp/--tp/--sp)"),
    (["--grad-accum", "2"],
     "error: --augment/--grad-accum support the dp paths only (no --pp/--tp/--sp)"),
    (["--config", "deit_tiny_sp", "--distill-teacher", "teacher.npz"],
     "error: --distill-teacher composes with --dp/--tp only (no --pp/--sp)"),
], ids=["pp", "tp", "fused_adamw", "qat", "dropout", "drop_path", "tome", "mae", "augment",
        "grad_accum", "distill"])
def test_cli_refusals_in_jax_words(fake_mesh, capsys, flags, message):
    assert tmain([*BASE, "--sp", "2", *flags]) == 2
    assert message in capsys.readouterr().err


def test_sp_on_ops_auto_takes_the_eager_tier():
    args = build_parser().parse_args(["--sp", "2"])
    train_setup._mesh_flags(args)
    assert args.ops == "eager"
    args = build_parser().parse_args(["--sp", "2", "--ops", "fused_train"])
    train_setup._mesh_flags(args)
    assert args.ops == "fused_train"


def test_cli_sp_needs_a_torchrun_world(monkeypatch, capsys):
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(tconfig.CONFIGS, W.SP.name, W.SP)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert tmain([*BASE, "--sp", "2"]) == 2
    assert "--sp 2 need one process per rank" in capsys.readouterr().err


def test_cli_sp_mesh_must_fill_the_world(monkeypatch):
    # {dp, sp} from the flags, the JAX package's shape, exactly the world
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("MASTER_ADDR", "localhost")
    with pytest.raises(common.MeshError, match=r"mesh \{'dp': 3, 'sp': 2\} needs 6 ranks"):
        common.resolve_mesh(3, 1, "cpu", sp=2)
    assert common._train_shape(4, None, 1, 1, 4) == {"sp": 4}
    assert common._train_shape(4, None, 1, 1, 2) == {"dp": 2, "sp": 2}
    assert common._train_shape(8, None, 2, 2, 1) == {"dp": 2, "pp": 2, "tp": 2}
    assert common._train_shape(2, None, 1, 2, 1) == {"dp": 1, "pp": 2}

