"""DeiT distillation in the port (``trainer.distillation_loss``,
``make_distill_train_step``, ``vit-tpu-torch-train --distill-*``) against
the JAX package on the CPU.

The student is a tiny distilled config (``tests/test_deit.py``'s: CLS and
distillation tokens, two heads); the teacher its non-distilled twin.  The
JAX side runs its Pallas kernels in interpret mode, the port its kernels'
plain twins.

Tolerances: the loss on the same logits 1e-6 (fp32, the same operations);
gradients 1e-4 x max(1, max|g|) per leaf (``tests/test_torch_train.py``'s
fp32 bar); the ``fused`` teacher's logits 1e-5 (``test_torch_engine.py``'s
bar); the ``quant`` teacher's by ``test_torch_quant.py``'s rule for
discrete stages: decisive labels equal, every logit within a few code steps
(2^-6 of the largest); the train CLIs' losses 1e-4.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.io import checkpoint as jckpt
from vit_tpu.models import vit as jvit
from vit_tpu.ops import quant as jquant
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu.runtime import trainer as jtrainer
from vit_tpu_torch.cli import train_setup
from vit_tpu_torch.cli.train_args import build_parser
from vit_tpu_torch.config import ViTConfig
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops import quant as tquant
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.runtime import trainer as ttrainer

STEP_RTOL = 2.0 ** -6
DEIT = ViTConfig(image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
                 num_classes=11, distilled=True, name="deit_tiny_test")
TEACHER = dataclasses.replace(DEIT, distilled=False, name="teacher_tiny")


def _np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def student():
    return _np(jvit.init_params(jax.random.key(4), DEIT))


@pytest.fixture(scope="module")
def teacher():
    return _np(jvit.init_params(jax.random.key(11), TEACHER))


@pytest.fixture(scope="module")
def batch():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(6, 3, 32, 32)).astype(np.float32)
    return x, rng.integers(0, DEIT.num_classes, 6).astype(np.int32)


@pytest.fixture
def registered(monkeypatch, tmp_path, teacher):
    import vit_tpu.config as jconfig
    import vit_tpu_torch.config as tconfig

    for mod in (jconfig, tconfig):
        monkeypatch.setitem(mod.CONFIGS, DEIT.name, DEIT)
    jckpt.save_npz(teacher, tmp_path / "teacher.npz")
    return tmp_path / "teacher.npz"


def _leaf_grads(tree):
    return {k: _leaf_grads(v) if isinstance(v, dict) else v.grad.numpy() for k, v in tree.items()}


def _assert_grads(got, want, rtol):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_grads(got[k], want[k], rtol)
            continue
        err = np.abs(got[k] - want[k]).max()
        assert err <= rtol * max(1.0, np.abs(want[k]).max()), (k, err)


# -- the loss --------------------------------------------------------------


@pytest.mark.parametrize("hard,tau,alpha,smoothing", [
    (True, 1.0, 0.5, 0.0), (True, 1.0, 0.3, 0.1), (False, 1.0, 0.5, 0.0), (False, 3.0, 0.7, 0.0),
    (False, 0.5, 1.0, 0.1)])
def test_distillation_loss_matches_jax(hard, tau, alpha, smoothing):
    rng = np.random.default_rng(7)
    cls, dist, teach = (rng.normal(size=(8, 11)).astype(np.float32) * 3 for _ in range(3))
    labels = rng.integers(0, 11, 8).astype(np.int32)
    want = float(jtrainer.distillation_loss(*map(jnp.asarray, (cls, dist, labels, teach)),
                                            alpha=alpha, hard=hard, tau=tau,
                                            label_smoothing=smoothing))
    got = ttrainer.distillation_loss(*map(torch.from_numpy, (cls, dist, labels, teach)),
                                     alpha=alpha, hard=hard, tau=tau, label_smoothing=smoothing)
    assert got.dtype == torch.float32 and abs(got.item() - want) <= 1e-6


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hard_labels_take_the_first_maximum(dtype):
    # a bf16 teacher's logits tie; jnp.argmax takes the lowest index
    teach = np.array([[1, 3, 3, 0], [2, 2, 2, 2], [0, 0, 1, 1], [5, 1, 5, 5]], np.float32)
    rng = np.random.default_rng(1)
    cls, dist = rng.normal(size=(2, 4, 4)).astype(np.float32)
    labels = np.array([0, 1, 2, 3], np.int32)
    want = float(jtrainer.distillation_loss(*map(jnp.asarray, (cls, dist, labels, teach))))
    got = ttrainer.distillation_loss(*map(torch.from_numpy, (cls, dist, labels)),
                                     torch.from_numpy(teach).to(dtype))
    assert abs(got.item() - want) <= 1e-6
    # the labels: each row's first maximum (0 1 2 0), not another tied one
    other = float(jtrainer.distillation_loss(*map(jnp.asarray, (cls, dist, labels)),
                                             jnp.asarray(teach[:, ::-1])))
    assert abs(got.item() - other) > 1e-3


# -- the step's gradients against jax.grad -----------------------------------


@pytest.mark.parametrize("ops,hard", [("eager", True), ("eager", False), ("fused_train", True),
                                      ("fused_train", False)])
def test_distill_step_grads_match_jax(student, teacher, batch, ops, hard):
    x, y = batch
    jops, t_jops = ((jget_ops("xla"), jget_ops("xla")) if ops == "eager"
                    else (jget_ops("fused_train"), jget_ops("fused")))
    jt = jax.tree.map(jnp.asarray, teacher)

    def jloss(p):
        t_logits = jax.lax.stop_gradient(jvit.forward(jt, jnp.asarray(x), TEACHER, t_jops))
        cls, dist = jvit.forward(p, jnp.asarray(x), DEIT, jops, separate_heads=True)
        return jtrainer.distillation_loss(cls, dist, jnp.asarray(y), t_logits, alpha=0.5,
                                          hard=hard, tau=2.0)

    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, student))
    params = ttrainer.as_trainable(params_from_numpy(student, "cpu"), "cpu")
    tt = params_from_numpy(teacher, "cpu")
    t_ops = get_ops("eager" if ops == "eager" else "fused")
    graph = []

    def teacher_fwd(images):
        graph.append(torch.is_grad_enabled())
        return tvit.forward(tt, images, TEACHER, t_ops)

    # lr 0: the step leaves the params alone and its gradients in .grad
    step = ttrainer.make_distill_train_step(
        DEIT, torch.optim.SGD(list(ttrainer.leaves(params)), lr=0.0), teacher_fwd, get_ops(ops),
        remat=ops == "eager", alpha=0.5, hard=hard, tau=2.0)
    loss = step(params, torch.from_numpy(x), torch.from_numpy(y))
    assert graph == [False]  # the teacher records no graph
    assert abs(loss.item() - float(jl)) <= 1e-5
    grads = _leaf_grads(params)
    assert min(np.abs(grads[h]["kernel"]).max() for h in ("head", "head_dist")) > 0
    _assert_grads(grads, _np(jg), 1e-4)


def test_distill_step_refuses_a_plain_student():
    with pytest.raises(ValueError, match="distilled student config"):
        ttrainer.make_distill_train_step(TEACHER, None, lambda x: x)


# -- the teacher tables -------------------------------------------------------


def _setup_teacher(path, ops, *extra):
    args = build_parser().parse_args(["--config", DEIT.name, "--distill-teacher", str(path),
                                      "--ops", ops, "--device", "cpu", *extra])
    compute = torch.bfloat16 if args.mixed_precision else None
    return train_setup._teacher(args, DEIT, ops, torch.device("cpu"), compute)


def _teacher_run(monkeypatch, fwd, x):
    """fwd(x) -> (its logits, the params tree and op table its forward got)."""
    seen = []
    forward = tvit.forward

    def spy(p, images, cfg, ops, *a, **k):
        seen.append((p, ops))
        return forward(p, images, cfg, ops, *a, **k)

    monkeypatch.setattr(tvit, "forward", spy)
    logits = fwd(torch.from_numpy(x))
    monkeypatch.setattr(tvit, "forward", forward)
    assert len(seen) == 1
    return logits, *seen[0]


def _leaf_dtypes(tree):
    return {v.dtype for v in ttrainer.leaves(tree)}


def test_fused_teacher_matches_jax_fused(registered, teacher, batch, capsys, monkeypatch):
    x = batch[0]
    got, params, ops = _teacher_run(monkeypatch, _setup_teacher(registered, "fused_train"), x)
    assert "[teacher on fused kernels]" in capsys.readouterr().out
    assert ops is get_ops("fused") and _leaf_dtypes(params) == {torch.float32}
    want = np.asarray(jvit.forward(jax.tree.map(jnp.asarray, teacher), jnp.asarray(x), TEACHER,
                                   jget_ops("fused")))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    # mixed precision: the teacher's leaves cast to bf16 once, at setup
    got16, params16, _ = _teacher_run(
        monkeypatch, _setup_teacher(registered, "fused_train", "--mixed-precision"), x)
    assert _leaf_dtypes(params16) == {torch.bfloat16} and got16.dtype == torch.float32
    np.testing.assert_allclose(got16.numpy(), want, atol=2.0 ** -6 * max(1.0, np.abs(want).max()),
                               rtol=0)


@pytest.mark.parametrize("mixed", [False, True], ids=["fp32", "bf16"])
def test_int8_teacher_matches_jax_quant(registered, teacher, batch, capsys, mixed, monkeypatch):
    extra = ["--distill-teacher-int8"] + (["--mixed-precision"] if mixed else [])
    x = batch[0]
    got, params, ops = _teacher_run(
        monkeypatch, _setup_teacher(registered, "fused_train", *extra), x)
    assert "[teacher on W8A8 kernels]" in capsys.readouterr().out
    assert ops is get_ops("quant")
    # the engine's order: quantize from fp32 (the JAX package's codes and
    # scales bit for bit), then cast the other leaves
    jq = jquant.quantize_params(jax.tree.map(jnp.asarray, teacher))
    for name in ("wqkv", "w1", "w2"):
        assert params["blocks"][name].dtype == torch.int8
        np.testing.assert_array_equal(params["blocks"][name].numpy(),
                                      np.asarray(jq["blocks"][name]))
        np.testing.assert_array_equal(params["blocks"][name + "_scale"].numpy(),
                                      np.asarray(jq["blocks"][name + "_scale"]))
    assert params["blocks"]["wo"].dtype == params["pos_embed"].dtype == (
        torch.bfloat16 if mixed else torch.float32)
    if mixed:
        jq = jquant.cast_quantized_params(jq, jnp.bfloat16)
    want = np.asarray(jvit.forward(jq, jnp.asarray(x), TEACHER, jget_ops("quant")), np.float32)
    fp = np.asarray(jvit.forward(jax.tree.map(jnp.asarray, teacher), jnp.asarray(x), TEACHER))
    p = np.exp(fp - fp.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    top2 = np.sort(p, -1)[:, -2:]
    decisive = top2[:, 1] - top2[:, 0] > 0.01
    assert ((got.float().numpy().argmax(-1) == want.argmax(-1)) | ~decisive).all()
    assert np.abs(got.float().numpy() - want).max() <= STEP_RTOL * max(1.0, np.abs(want).max())


def test_eager_and_qat_students_get_the_eager_teacher(registered, teacher, batch, capsys,
                                                     monkeypatch):
    want = np.asarray(jvit.forward(jax.tree.map(jnp.asarray, teacher), jnp.asarray(batch[0]),
                                   TEACHER))
    for student_ops in ("eager", "qat"):
        got, params, ops = _teacher_run(monkeypatch, _setup_teacher(registered, student_ops),
                                        batch[0])
        out = capsys.readouterr().out
        assert "distillation: teacher deit_tiny_test_teacher from" in out and "[teacher" not in out
        assert ops is get_ops("eager") and _leaf_dtypes(params) == {torch.float32}
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


# -- the train CLI -------------------------------------------------------------


def _losses(path):
    return [json.loads(line)["loss"] for line in path.read_text().splitlines()]


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_distill_cli_matches_jax_cli(registered, student, tmp_path, capsys, soft):
    from vit_tpu.cli.train import main as jmain
    from vit_tpu_torch.cli.train import main as tmain

    init = tmp_path / "s.npz"
    jckpt.save_npz(student, init)
    common = ["--config", DEIT.name, "--init-weights", str(init), "--steps", "3", "--batch", "4",
              "--ops", "fused_train", "--distill-teacher", str(registered),
              "--distill-alpha", "0.4", *(["--distill-soft", "--distill-tau", "2"] if soft else [])]
    assert tmain([*common, "--device", "cpu", "--log-jsonl", str(tmp_path / "t.jsonl"),
                  "--save", str(tmp_path / "t.npz")]) == 0
    out = capsys.readouterr().out
    assert "[teacher on fused kernels]" in out and "step    2" in out
    mode = "soft KD (tau=2.0)" if soft else "hard (CE vs teacher argmax)"
    assert f"alpha=0.4, {mode}" in out
    assert jmain([*common, "--dp", "1", "--no-compile-cache", "--log-jsonl",
                  str(tmp_path / "j.jsonl")]) == 0
    got, want = _losses(tmp_path / "t.jsonl"), _losses(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    saved = np.load(tmp_path / "t.npz")
    assert "dist_token" in saved.files and "head_dist/kernel" in saved.files


def test_distill_cli_int8_teacher_runs(registered, capsys):
    from vit_tpu_torch.cli.train import main

    assert main(["--config", DEIT.name, "--steps", "2", "--batch", "4", "--device", "cpu",
                 "--ops", "fused_train", "--mixed-precision", "--distill-teacher",
                 str(registered), "--distill-teacher-int8"]) == 0
    out = capsys.readouterr().out
    assert "[teacher on W8A8 kernels]" in out and "step    1" in out


def _refusal(main, args, capsys):
    rc = main(args)
    return rc, capsys.readouterr().err.strip().splitlines()[-1]


# refusals whose words the JAX package's CLI prints as they are: (args, the
# start of the error line)
SHARED = {
    "plain_student": (["--config", "vit_b_16", "--batch", "8"],
                      "error: --distill-teacher needs a distilled student --config (deit_*), "
                      "got vit_b_16"),
    "teacher_image_size": (["--distill-config", "vit_b_16"],
                           "error: teacher config vit_b_16 is 224px but the student trains at "
                           "32px"),
    "tome": (["--tome", "2"], "error: --tome training does not compose with --mae/"),
}


@pytest.mark.parametrize("case", list(SHARED))
def test_distill_cli_refusals_in_jax_words(registered, capsys, case):
    from vit_tpu.cli.train import main as jmain
    from vit_tpu_torch.cli.train import main as tmain

    extra, words = SHARED[case]
    base = ["--config", DEIT.name, "--steps", "1", "--batch", "4", "--distill-teacher",
            str(registered)]
    rc, line = _refusal(tmain, [*base, "--device", "cpu", "--ops", "eager", *extra], capsys)
    jrc, jline = _refusal(jmain, [*base, "--dp", "1", "--no-compile-cache", "--ops", "xla",
                                  *extra], capsys)
    assert rc == jrc == 2 and line == jline and line.startswith(words)


def test_distill_cli_int8_without_teacher_in_jax_words(registered, capsys):
    from vit_tpu.cli.train import main as jmain
    from vit_tpu_torch.cli.train import main as tmain

    base = ["--config", DEIT.name, "--steps", "1", "--batch", "4", "--distill-teacher-int8"]
    rc, line = _refusal(tmain, [*base, "--device", "cpu"], capsys)
    jrc, jline = _refusal(jmain, [*base, "--dp", "1", "--no-compile-cache"], capsys)
    assert rc == jrc == 2 and line == jline
    assert line.startswith("error: --distill-teacher-int8 modifies the teacher path")


@pytest.mark.parametrize("extra,words", [
    (["--ops", "eager", "--distill-teacher-int8"],
     "error: --distill-teacher-int8 requires --ops fused_train"),
    (["--grad-accum", "2"], "error: --distill-teacher composes with none of --grad-accum/"),
    (["--dropout", "0.1"], "error: --distill-teacher composes with none of --grad-accum/"),
    (["--drop-path", "0.1"], "error: --distill-teacher composes with none of --grad-accum/"),
    (["--mae"], "error: --mae is self-supervised pretraining"),
], ids=["int8_eager", "grad_accum", "dropout", "drop_path", "mae"])
def test_distill_cli_refusals(registered, capsys, extra, words):
    from vit_tpu_torch.cli.train import main

    rc, line = _refusal(main, ["--config", DEIT.name, "--steps", "1", "--batch", "4",
                               "--device", "cpu", "--distill-teacher", str(registered), *extra],
                        capsys)
    assert rc == 2 and line.startswith(words)


def test_distill_teacher_head_width_validated(registered, tmp_path, capsys):
    from vit_tpu.cli.train import main as jmain
    from vit_tpu_torch.cli.train import main as tmain

    wide = dataclasses.replace(TEACHER, num_classes=DEIT.num_classes + 7, name="teacher_wide")
    jckpt.save_npz(jvit.init_params(jax.random.key(12), wide), tmp_path / "wide.npz")
    base = ["--config", DEIT.name, "--steps", "1", "--batch", "8", "--distill-teacher",
            str(tmp_path / "wide.npz")]
    rc, line = _refusal(tmain, [*base, "--device", "cpu"], capsys)
    jrc, jline = _refusal(jmain, [*base, "--dp", "1", "--no-compile-cache"], capsys)
    assert rc == jrc == 2 and line == jline
    assert line == ("error: teacher head has 18 classes but the student trains 11 — the "
                    "distillation targets must share the student's label space")
