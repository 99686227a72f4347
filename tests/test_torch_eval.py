"""The port's evaluation and measurement helpers against the JAX package on
the CPU: ``eval/accuracy.py``, the ``vit-tpu-torch-eval`` CLI, the oracle
copy (``models/oracle.py``), ``ViTConfig.flops_per_image`` and the
profiler's roofline, timing recipes and trace, and ``version.py``.

Inputs come from numpy seeds and the JAX package's initializer, written as
shards, an input-100.bin batch with a label file, and PNG class folders.
Tolerances: the eval CLIs' top-1 and top-5 equal and mean top-probability
within 1e-6 (``--ops eager --dtype float32`` against the JAX CLI's ``--ops
xla``); the oracle copy bit for bit in float64; the port's fp32 eager
logits within 1e-5 of the oracle's (its own bar, BENCH_r05, is 1.07e-6 at
B/16 on the TPU's fp32).
"""

import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch

from vit_tpu import config as jconfig
from vit_tpu.eval import accuracy as jacc
from vit_tpu.io import checkpoint as jckpt
from vit_tpu.io.images import save_image_bin
from vit_tpu.models import oracle as joracle
from vit_tpu.models import vit as jvit
from vit_tpu.runtime import profiler as jprof
from vit_tpu_torch import config as tconfig
from vit_tpu_torch.eval import accuracy as tacc
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import oracle as toracle
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.runtime import profiler as tprof


def _jtree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.fixture(scope="module")
def tree(tiny_cfg):
    return _jtree(jvit.init_params(jax.random.key(3), tiny_cfg))


@pytest.fixture(scope="module")
def images(tiny_cfg):
    return np.random.default_rng(5).normal(
        size=(14, 3, tiny_cfg.image_size, tiny_cfg.image_size)).astype(np.float32)


# -- accuracy ---------------------------------------------------------------------


class _FixedEngine:
    """Hands out fixed probabilities, batch by batch, as a torch tensor
    (the port's engine) or a numpy array (the JAX engine's ``np.asarray``
    of a device array)."""

    def __init__(self, probs, as_tensor):
        self.probs, self.as_tensor, self.i = probs, as_tensor, 0

    def probabilities(self, imgs):
        out = self.probs[self.i : self.i + len(imgs)]
        self.i += len(imgs)
        return torch.from_numpy(out) if self.as_tensor else out


def _probs_with_ties(n=23, k=11, seed=0):
    rng = np.random.default_rng(seed)
    p = rng.random((n, k)).astype(np.float32)
    p[::3, 2] = p[::3, 7] = p[::3].max(-1) + 0.5  # top-1 ties
    p[1::4, :6] = 0.25  # ties across the top-5 boundary
    return p / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("batch_size", [None, 1, 5, 23])
def test_evaluate_matches_jax(batch_size):
    probs = _probs_with_ties()
    labels = np.random.default_rng(1).integers(0, 11, len(probs))
    labels[::3] = 7
    imgs = np.zeros((len(probs), 1))
    got = tacc.evaluate(_FixedEngine(probs, True), imgs, labels, batch_size)
    want = jacc.evaluate(_FixedEngine(probs, False), imgs, labels, batch_size)
    assert got.as_dict() == want.as_dict() and got.n == 23
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_evaluate_batches_takes_tensor_labels_and_refuses_nothing():
    probs = _probs_with_ties(n=10)
    labels = np.arange(10) % 11
    batches = [(np.zeros((4, 1)), torch.from_numpy(labels[:4])),
               (np.zeros((6, 1)), labels[4:])]
    got = tacc.evaluate_batches(_FixedEngine(probs, True), batches)
    want = jacc.evaluate_batches(_FixedEngine(probs, False),
                                 [(x, np.asarray(y)) for x, y in batches])
    assert got == tacc.AccuracyReport(**dataclasses.asdict(want))
    for mod in (tacc, jacc):
        with pytest.raises(ValueError, match="no batches"):
            mod.evaluate_batches(None, [])


# -- the eval CLI against the JAX CLI ------------------------------------------------


@pytest.fixture
def registered(tiny_cfg, monkeypatch):
    monkeypatch.setitem(jconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    monkeypatch.setitem(tconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    return tiny_cfg


@pytest.fixture(scope="module")
def data(tmp_path_factory, tiny_cfg, tree, images):
    """Weights, labeled shards, an input-100.bin batch with labels, and a
    4-class PNG folder; half the labels are the fp32 forward's top-1."""
    from PIL import Image

    d = tmp_path_factory.mktemp("eval")
    jckpt.save_npz(tree, str(d / "w.npz"))
    top1 = np.asarray(jvit.logits_fn(tiny_cfg)(tree, images)).argmax(-1)
    labels = np.random.default_rng(6).integers(0, tiny_cfg.num_classes, len(images))
    labels[::2] = top1[::2]
    labels = labels.astype("<i4")
    (d / "shards").mkdir()
    for name, lo, hi in (("a", 0, 5), ("b", 5, 14)):
        save_image_bin(images[lo:hi], d / "shards" / f"{name}.bin")
        labels[lo:hi].tofile(d / "shards" / f"{name}.labels.bin")
    save_image_bin(images, d / "in.bin")
    labels.tofile(d / "labels.bin")
    rng = np.random.default_rng(7)
    for c in range(4):
        (d / "folder" / f"class{c}").mkdir(parents=True)
        for j in range(2 + c % 2):
            Image.fromarray(rng.integers(0, 256, (40 + 3 * j, 36, 3), dtype=np.uint8)).save(
                d / "folder" / f"class{c}" / f"{j}.png")
    return d


def _eval_both(cfg, d, source, capsys, extra=()):
    """The port's CLI (``--device cpu --ops eager``) and the JAX CLI (``--ops
    xla``) in fp32 on ``source`` -> (port payload, JAX payload)."""
    from vit_tpu.cli.eval import main as jmain
    from vit_tpu_torch.cli.eval import main as tmain

    common = ["--config", cfg.name, "--weights", str(d / "w.npz"), "--dtype", "float32",
              "--json", *source, *extra]
    assert tmain([*common, "--device", "cpu", "--ops", "eager"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jmain([*common, "--ops", "xla", "--no-compile-cache"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return got, want


def _same_report(got, want, n):
    assert got["n"] == want["n"] == n
    assert got["top1"] == want["top1"] and got["top5"] == want["top5"]
    assert abs(got["mean_top_prob"] - want["mean_top_prob"]) <= 1e-6
    assert set(got) == set(want)
    assert (got["model"], got["ops"], got["dtype"]) == ("vit_tiny_test", "eager", "float32")


@pytest.mark.parametrize("source,extra,n", [
    ("data_dir", ("--batch", "4"), 14),
    ("data_dir", ("--batch", "5", "--limit", "11"), 11),
    ("input", ("--batch", "6"), 14),
    ("image_dir", ("--batch", "4"), 10),
], ids=["data_dir", "data_dir_limit", "input", "image_dir"])
def test_eval_cli_matches_jax(registered, data, capsys, source, extra, n):
    args = {"data_dir": ["--data-dir", str(data / "shards")],
            "input": ["--input", str(data / "in.bin"), "--labels", str(data / "labels.bin")],
            "image_dir": ["--image-dir", str(data / "folder")]}[source]
    got, want = _eval_both(registered, data, args, capsys, extra)
    _same_report(got, want, n)
    if source != "image_dir":  # the shard labels are half the forward's top-1
        assert got["top1"] >= 0.5


def test_eval_cli_text_line_and_streams_through_prefetch(registered, data, capsys, monkeypatch):
    from vit_tpu_torch.cli.eval import main
    from vit_tpu_torch.runtime import prefetch

    calls = []
    orig = prefetch.prefetch_to_device

    def spy(*a, **k):
        calls.append(k)
        return orig(*a, **k)

    monkeypatch.setattr(prefetch, "prefetch_to_device", spy)
    assert main(["--config", registered.name, "--weights", str(data / "w.npz"), "--device",
                 "cpu", "--data-dir", str(data / "shards"), "--batch", "4", "--ops",
                 "fused"]) == 0
    out = capsys.readouterr().out.strip()
    assert out.startswith("vit_tiny_test ops=fused dtype=bfloat16: top-1 ")
    assert "top-5" in out and "mean top-prob" in out and out.endswith("img/s)")
    assert "(14 images, " in out
    assert calls == [{"size": 2, "device": torch.device("cpu")}]


@pytest.mark.parametrize("flags,message", [
    (["--input", "IN"], "--input requires --labels"),
    (["--data-dir", "SHARDS", "--tome", "-1"], "--tome must be >= 0"),
    (["--data-dir", "SHARDS", "--tome", "2", "--ops", "per_op"], "--tome needs --ops"),
    (["--input", "IN", "--labels", "SHORT"], "13 labels != 14 images"),
    (["--data-dir", "SHARDS", "--tp", "2"], "torchrun"),
    (["--image-dir", "FOLDER", "--num-classes", "3"], "4 class folders > 3 model classes"),
])
def test_eval_cli_refusals(registered, data, capsys, flags, message):
    from vit_tpu_torch.cli.eval import main

    np.zeros(13, "<i4").tofile(data / "short.bin")
    sub = {"IN": data / "in.bin", "SHARDS": data / "shards", "SHORT": data / "short.bin",
           "FOLDER": data / "folder"}
    flags = [str(sub.get(f, f)) for f in flags]
    assert main(["--config", registered.name, "--weights", str(data / "w.npz"), "--device",
                 "cpu", *flags]) == 2
    assert message in capsys.readouterr().err


def test_eval_cli_cuda_without_a_card_exits_nonzero(registered, data, capsys, monkeypatch):
    from vit_tpu_torch.cli.eval import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--config", registered.name, "--weights", str(data / "w.npz"),
                 "--data-dir", str(data / "shards")]) != 0
    assert "error:" in capsys.readouterr().err


# -- the oracle copy --------------------------------------------------------------------


@pytest.fixture(scope="module")
def deit_cfg(tiny_cfg):
    return dataclasses.replace(tiny_cfg, patch_size=8, distilled=True, name="deit_tiny_test")


@pytest.mark.parametrize("which", ["vit", "deit"])
def test_oracle_copy_equals_the_original_in_float64(tiny_cfg, deit_cfg, images, which):
    cfg = tiny_cfg if which == "vit" else deit_cfg
    tree = _jtree(jvit.init_params(jax.random.key(9), cfg))
    x = images[:3]
    want = joracle.forward(tree, x, cfg)
    got = toracle.forward(tree, x, cfg)
    assert got.dtype == np.float64 and got.shape == (3, cfg.num_classes)
    np.testing.assert_array_equal(got, want)
    # the port's torch params (fp32 on the CPU) give the same bits
    np.testing.assert_array_equal(toracle.forward(params_from_numpy(tree, "cpu"), x, cfg), want)
    np.testing.assert_array_equal(toracle.forward_one(tree, x[0], cfg), want[0])
    np.testing.assert_array_equal(toracle.probabilities(got), joracle.probabilities(want))
    np.testing.assert_array_equal(toracle.forward(tree, x, cfg, np.float32),
                                  joracle.forward(tree, x, cfg, np.float32))


def test_fp32_eager_is_within_1e5_of_the_oracle(tiny_cfg, tree, images):
    with torch.no_grad():
        got = tvit.forward(params_from_numpy(tree, "cpu"), torch.from_numpy(images),
                           tiny_cfg).numpy()
    assert np.abs(got - toracle.forward(tree, images, tiny_cfg)).max() <= 1e-5


# -- flops, roofline, timing, trace, version ------------------------------------------


@pytest.mark.parametrize("name", sorted(jconfig.CONFIGS))
def test_flops_per_image_matches_jax(name):
    assert tconfig.get_config(name).flops_per_image() == jconfig.get_config(name).flops_per_image()


def test_roofline_on_the_h100_peaks():
    cfg = tconfig.VIT_B_16
    r = tprof.roofline(cfg, 100, 0.0132)
    assert set(r) == {"flops", "tflops_per_sec", "mfu", "images_per_sec",
                      "images_per_sec_per_chip"}
    assert r["flops"] == 100 * cfg.flops_per_image()
    assert r["tflops_per_sec"] == pytest.approx(r["flops"] / 0.0132 / 1e12)
    assert r["mfu"] == pytest.approx(r["tflops_per_sec"] / 989.0)
    assert tprof.roofline(cfg, 100, 0.0132, dtype="int8")["mfu"] == pytest.approx(
        r["tflops_per_sec"] / 1979.0)
    four = tprof.roofline(cfg, 100, 0.0132, dtype="fp32", n_chips=4)
    assert four["mfu"] == pytest.approx(r["tflops_per_sec"] / (4 * 67.0))
    assert four["images_per_sec_per_chip"] == pytest.approx(100 / 0.0132 / 4)
    # the JAX package's keys but its share's name, on the same flop count
    want = jprof.roofline(jconfig.VIT_B_16, 100, 0.0132)
    assert want["flops"] == r["flops"] and want["tflops_per_sec"] == r["tflops_per_sec"]
    for chip, dtype in (("v5e", "bf16"), ("h100", "fp16"), ("h10", "bf16")):
        with pytest.raises(KeyError, match="no peak"):
            tprof.roofline(cfg, 1, 1.0, chip=chip, dtype=dtype)


def test_timing_spread_matches_jax():
    def fn(n):
        fn.calls.append(n)
        return [3.0, 1.0, 2.0, 5.0, 4.0][len(fn.calls) - 1]

    fn.calls = []
    got = tprof.timing_spread(fn, 7, samples=5)
    calls = fn.calls
    fn.calls = []
    assert got == jprof.timing_spread(fn, 7, samples=5) == (3.0, 1.0, 5.0)
    assert calls == fn.calls == [7] * 5

    def step(n, a, b):
        return float(n + a), a + 1, b * 2

    got = tprof.timing_spread_stateful(step, 2, (0, 1), samples=3)
    assert got == jprof.timing_spread_stateful(step, 2, (0, 1), samples=3)


def test_forward_and_train_step_timing_on_the_cpu(tiny_cfg, tree, images):
    calls = []

    def forward():
        calls.append(1)
        return torch.ones(2)

    med, lo, hi = tprof.forward_timing(forward, iters=4, warm=2, samples=3)
    assert len(calls) == 2 + 3 * 4 and 0 < lo <= med <= hi

    from vit_tpu_torch.runtime import trainer

    params = trainer.as_trainable(params_from_numpy(tree, "cpu"), "cpu", torch.float32)
    opt = torch.optim.SGD(list(trainer.leaves(params)), lr=0.05)
    step = trainer.make_train_step(tiny_cfg, opt, remat=False)
    x = torch.from_numpy(images[:4])
    y = torch.arange(4, dtype=torch.int32)
    med, lo, hi, loss = tprof.train_step_timing(step, params, x, y, iters=2, warm=1)
    assert 0 < lo <= med <= hi and np.isfinite(loss)
    assert loss < float(step(params, x, y)) + 1.0  # 7 SGD steps ran on the same batch


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(None) as prof:
        assert prof is None
    with tprof.trace(str(tmp_path / "t")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
        time.sleep(0.001)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)
    assert prof.key_averages() is not None


def test_version_is_the_jax_packages():
    from vit_tpu.version import __version__ as want
    from vit_tpu_torch.version import __version__ as got

    assert got == want
