"""The port's data pipeline against the JAX package on the CPU: the native
reader (``io/native.py``), the datasets (``io/dataset.py``), the train-mode
preprocessing and ``folder_dataset``, the prefetch (``runtime/prefetch.py``)
and the train CLI's ``--data-dir``/``--image-dir``/``--eval-data-dir``.

Inputs are made from numpy seeds: shards written in the input-100.bin
format with int32 label files, and a 3-class folder of PNGs written with
PIL.  Reads are compared bit for bit and every ``batches`` mode index for
index.  The train CLIs are held to each other as ``tests/test_torch_train.py``
holds the static-batch CLIs: per-step loss 1e-4, and the eval lines equal.
The prefetch's stream discipline needs the card (``tests/test_torch_cuda.py``).
"""

import itertools
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from vit_tpu.io import checkpoint as jckpt
from vit_tpu.io import dataset as jds
from vit_tpu.io import native as jnative
from vit_tpu.io import preprocess as jpre
from vit_tpu.io.images import load_image_bin
from vit_tpu_torch.io import dataset as tds
from vit_tpu_torch.io import native as tnative
from vit_tpu_torch.io import preprocess as tpre
from vit_tpu_torch.io.images import save_image_bin
from vit_tpu_torch.runtime.prefetch import batched, prefetch_to_device

REPO = Path(__file__).resolve().parents[1]
SHARD_SIZES = (7, 5, 9)


def _write_shards(d: Path, cfg, seed: int, sizes=SHARD_SIZES, labels=True) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for i, n in enumerate(sizes):
        x = rng.normal(size=(n, 3, cfg.image_size, cfg.image_size)).astype(np.float32)
        save_image_bin(x, d / f"shard{i}.bin")
        if labels:
            rng.integers(0, cfg.num_classes, n).astype("<i4").tofile(d / f"shard{i}.labels.bin")
    return d


@pytest.fixture(scope="module")
def shards(tmp_path_factory, tiny_cfg):
    return _write_shards(tmp_path_factory.mktemp("shards"), tiny_cfg, seed=0)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """3 class folders of PNGs of assorted sizes (and one non-image file)."""
    from PIL import Image

    root = tmp_path_factory.mktemp("folder")
    rng = np.random.default_rng(1)
    for c, name in enumerate(("cat", "dog", "emu")):
        (root / name).mkdir()
        for j in range(3 + c):
            h, w = (int(v) for v in rng.integers(24, 61, 2))
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(
                root / name / f"{j}.png")
    (root / "dog" / "notes.txt").write_text("not an image")
    return root


# -- the native reader ---------------------------------------------------------


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's binding on a library built here from the same
    source with native/Makefile's flags (its loader reads native/ by
    default, which a checkout does not build)."""
    out = tmp_path_factory.mktemp("jaxlib") / "libvitio.so"
    subprocess.run(["g++", *tnative.CXXFLAGS, "-shared", "-o", str(out),
                    str(REPO / "native" / "vitio.cpp")], check=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jnative, "_LIB_PATHS", (out,))
    mp.setattr(jnative, "_lib", None)
    mp.setattr(jnative, "_load_attempted", False)
    assert jnative.gather_available()
    yield jnative
    mp.undo()


def test_native_flags_are_the_makefiles():
    text = (REPO / "native" / "Makefile").read_text()
    line = next(ln for ln in text.splitlines() if ln.startswith("CXXFLAGS"))
    assert tuple(line.split("?=")[1].split()) == tnative.CXXFLAGS
    assert tnative.library_path().parent == REPO / "build" / "vit_tpu_torch"
    assert tnative.available() and tnative.gather_available()


def test_native_gather_matches_memmap_and_jax(shards, jax_native):
    ds = tds.BinShardDataset(shards)
    rng = np.random.default_rng(2)
    take = rng.permutation(len(ds))[:13]
    args = ([str(p) for p in ds.paths], ds._shard_of[take], ds._offset_of[take], ds.sample_bytes)
    got = tnative.gather_read(*args, threads=3)
    np.testing.assert_array_equal(got, jax_native.gather_read(*args, threads=3))
    want = np.stack([ds._mmap(int(ds._shard_of[i]))[
        int(ds._offset_of[i] - 16) // ds.sample_bytes] for i in take])
    assert got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="outside paths"):
        tnative.gather_read(args[0], args[1] + 5, args[2], args[3])
    with pytest.raises(ValueError, match="length mismatch"):
        tnative.gather_read(args[0], args[1], args[2][:-1], args[3])


@pytest.mark.parametrize("round6", [True, False])
def test_native_reads_match_jax_and_numpy(tmp_path, shards, jax_native, round6):
    path = tmp_path / "w.bin"
    w = np.random.default_rng(3).normal(size=1001).astype("<f4")
    w.tofile(path)
    got = tnative.read_fp32(path, round_to_6dp=round6)
    np.testing.assert_array_equal(got, jax_native.read_fp32(path, round_to_6dp=round6))
    if not round6:
        np.testing.assert_array_equal(got, w)
    img = tnative.read_image_bin(shards / "shard1.bin")
    np.testing.assert_array_equal(img, load_image_bin(shards / "shard1.bin"))
    np.testing.assert_array_equal(img, jax_native.read_image_bin(shards / "shard1.bin"))
    with pytest.raises(FileNotFoundError):
        tnative.read_image_bin(tmp_path / "absent.bin")


def test_native_builds_atomically_and_refuses_a_broken_source(tmp_path, monkeypatch):
    """Concurrent first uses build into place without a partial file; a
    compile that fails raises."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "build")
    paths, errors = [], []

    def first_use():
        try:
            paths.append(tnative.build())
        except Exception as e:  # noqa: BLE001 - surfaced by the assert below
            errors.append(e)

    threads = [threading.Thread(target=first_use) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    assert len(set(paths)) == 1 and paths[0].exists()
    assert [p.name for p in (tmp_path / "build").iterdir()] == [paths[0].name]

    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="building the native reader failed"):
        tnative.build()


def test_without_a_compiler_the_dataset_reads_through_numpy(shards, monkeypatch):
    monkeypatch.setattr(tnative, "compiler", lambda: None)
    tnative._load.cache_clear()
    try:
        assert not tnative.available() and not tnative.gather_available()
        with pytest.raises(RuntimeError, match="not available"):
            tnative.read_fp32(shards / "shard0.bin")
        ds = tds.BinShardDataset(shards)
        take = np.array([20, 0, 7, 3, 12])
        np.testing.assert_array_equal(ds.read(take), jds.BinShardDataset(shards).read(take))
    finally:
        tnative._load.cache_clear()


# -- the datasets --------------------------------------------------------------


def test_bin_shards_match_jax(shards):
    got, want = tds.BinShardDataset(shards, threads=2), jds.BinShardDataset(shards)
    assert len(got) == len(want) == sum(SHARD_SIZES)
    assert got.paths == want.paths and got.counts == want.counts
    assert got.sample_shape == want.sample_shape and got.sample_bytes == want.sample_bytes
    assert got.has_labels and want.has_labels
    np.testing.assert_array_equal(got.labels(), want.labels())
    take = np.random.default_rng(4).permutation(len(got))
    assert got.read(take).tobytes() == want.read(take).tobytes()
    assert got.read([]).shape == (0, *got.sample_shape)
    with pytest.raises(IndexError):
        got.read([len(got)])


BATCH_MODES = {
    "shuffle": dict(batch_size=4, epochs=2),
    "ordered": dict(batch_size=4, shuffle=False, epochs=2),
    "remainder": dict(batch_size=4, epochs=3, drop_remainder=False),
    "seed": dict(batch_size=5, seed=9, epochs=2),
    "shard0": dict(batch_size=2, shard=(0, 3), epochs=2),
    "shard2": dict(batch_size=3, shard=(2, 3), epochs=3, drop_remainder=False),
    "skip": dict(batch_size=4, skip_batches=3, epochs=2),
    "skip_epochs": dict(batch_size=4, skip_batches=11, epochs=4),
    "skip_shard": dict(batch_size=2, shard=(1, 2), skip_batches=7, epochs=3),
    "whole": dict(batch_size=21, epochs=2),
}


def _same_batches(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for (gx, gy), (wx, wy) in zip(got, want):
        assert gx.tobytes() == wx.tobytes()
        np.testing.assert_array_equal(gy, wy)


@pytest.mark.parametrize("mode", sorted(BATCH_MODES))
def test_batches_match_jax_index_for_index(shards, mode):
    kw = BATCH_MODES[mode]
    _same_batches(tds.BinShardDataset(shards).batches(**kw),
                  jds.BinShardDataset(shards).batches(**kw))


def test_batch_indices_are_the_batches_rows(shards):
    ds = tds.BinShardDataset(shards)
    for take, (x, y) in zip(ds.batch_indices(4, seed=2, epochs=2),
                            ds.batches(4, seed=2, epochs=2)):
        np.testing.assert_array_equal(x, ds.read(take))
        np.testing.assert_array_equal(y, ds.labels()[take])


@pytest.mark.parametrize("kw,err", [
    (dict(batch_size=0), ValueError), (dict(batch_size=22), ValueError),
    (dict(batch_size=4, shard=(3, 3)), ValueError), (dict(batch_size=8, shard=(0, 3)), ValueError),
])
def test_batches_refuse_what_jax_refuses(shards, kw, err):
    with pytest.raises(err) as got:
        next(tds.BinShardDataset(shards).batches(**kw))
    with pytest.raises(err) as want:
        next(jds.BinShardDataset(shards).batches(**kw))
    assert str(got.value) == str(want.value)


def _faulty(d: Path, cfg, fault: str) -> Path:
    _write_shards(d, cfg, seed=5, sizes=(3, 4), labels=fault != "unlabeled")
    if fault == "count":
        np.zeros(2, "<i4").tofile(d / "shard1.labels.bin")
    elif fault == "range":
        np.full(4, cfg.num_classes, "<i4").tofile(d / "shard1.labels.bin")
    elif fault == "mixed":
        (d / "shard1.labels.bin").unlink()
    elif fault == "truncated":
        raw = (d / "shard1.bin").read_bytes()
        (d / "shard1.bin").write_bytes(raw[:-8])
    elif fault == "shape":
        save_image_bin(np.zeros((2, 3, 8, 8), np.float32), d / "shard2.bin")
        np.zeros(2, "<i4").tofile(d / "shard2.labels.bin")
    return d


@pytest.mark.parametrize("fault", ["count", "range", "mixed", "truncated", "shape", "unlabeled"])
def test_dataset_faults_match_jax(tmp_path, tiny_cfg, fault):
    d = _faulty(tmp_path / "d", tiny_cfg, fault)
    kw = dict(require_labels=True, num_classes=tiny_cfg.num_classes)
    with pytest.raises((ValueError, FileNotFoundError)) as got:
        tds.BinShardDataset(d, **kw)
    with pytest.raises((ValueError, FileNotFoundError)) as want:
        jds.BinShardDataset(d, **kw)
    assert type(got.value) is type(want.value) and str(got.value) == str(want.value)
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError, match="no .bin shards"):
        tds.BinShardDataset(tmp_path / "empty")


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_image_folder_matches_jax(folder, mode):
    got = tds.ImageFolderDataset(folder, 32, threads=2, mode=mode)
    want = jds.ImageFolderDataset(folder, 32, mode=mode)
    assert got.paths == want.paths and got.class_names == want.class_names == ["cat", "dog", "emu"]
    np.testing.assert_array_equal(got.labels(), want.labels())
    assert len(got) == 12 and got.has_labels
    take = np.arange(len(got))[::-1]
    assert got.read(take).tobytes() == want.read(take).tobytes()
    _same_batches(got.batches(5, seed=1, epochs=2, drop_remainder=False),
                  want.batches(5, seed=1, epochs=2, drop_remainder=False))


def test_preprocess_train_mode_and_folder_dataset_match_jax(folder, tmp_path):
    path = folder / "emu" / "0.png"
    for size, resize in ((32, None), (24, 30)):
        np.testing.assert_array_equal(tpre.preprocess_image(path, size, resize),
                                      jpre.preprocess_image(path, size, resize))
    got = tpre.preprocess_image(path, 40, mode="train")
    assert got.shape == (3, 40, 40)
    np.testing.assert_array_equal(got, jpre.preprocess_image(path, 40, mode="train"))
    for kw in (dict(mode="crop"), dict(mode="train", resize_size=36)):
        with pytest.raises(ValueError) as e1:
            tpre.preprocess_image(path, 32, **kw)
        with pytest.raises(ValueError) as e2:
            jpre.preprocess_image(path, 32, **kw)
        assert str(e1.value) == str(e2.value)
    paths, labels, names = tpre.folder_dataset(folder)
    want = jpre.folder_dataset(folder)
    assert paths == want[0] and names == want[2]
    np.testing.assert_array_equal(labels, want[1])
    (tmp_path / "empty").mkdir()
    with pytest.raises(tpre.PreprocessError, match="no class subdirectories"):
        tpre.folder_dataset(tmp_path / "empty")


# -- the prefetch on the CPU ------------------------------------------------------


def _prefetch_threads():
    return [t for t in threading.enumerate() if t.name == "prefetch_to_device"]


def test_prefetch_keeps_order_and_hands_off_on_the_cpu():
    items = [(np.full((2, 3), i, np.float32), np.array([i, -i], np.int32)) for i in range(7)]
    items.append({"x": np.arange(4), "none": None})
    got = list(prefetch_to_device(iter(items), size=2, device="cpu"))
    assert len(got) == 8
    for i, (x, y) in enumerate(got[:7]):
        assert isinstance(x, torch.Tensor) and x.device.type == "cpu"
        np.testing.assert_array_equal(x.numpy(), items[i][0])
        np.testing.assert_array_equal(y.numpy(), items[i][1])
    assert got[-1]["none"] is None and got[-1]["x"].tolist() == [0, 1, 2, 3]
    assert [b.tolist() for b in batched(np.arange(7), 3)] == [[0, 1, 2], [3, 4, 5], [6]]
    assert [b.tolist() for b in batched(np.arange(7), 3, drop_remainder=True)] == [
        [0, 1, 2], [3, 4, 5]]
    with pytest.raises(ValueError, match="size must be >= 1"):
        next(prefetch_to_device(iter(items), size=0, device="cpu"))


def test_prefetch_raises_the_producers_exception():
    def items():
        yield np.zeros(2)
        yield np.ones(2)
        raise OSError("disk gone")

    stream = prefetch_to_device(items(), size=1, device="cpu")
    assert next(stream).tolist() == [0, 0] and next(stream).tolist() == [1, 1]
    with pytest.raises(OSError, match="disk gone"):
        next(stream)
    assert not _prefetch_threads()


def test_prefetch_close_stops_the_producer():
    drawn = []

    def endless():
        i = 0
        while True:
            drawn.append(i)
            yield np.array([i])
            i += 1

    stream = prefetch_to_device(endless(), size=2, device="cpu")
    assert next(stream).tolist() == [0]
    stream.close()
    assert not _prefetch_threads()
    assert len(drawn) <= 4  # the consumer's item, the queue's 2, one being put


def test_prefetch_defaults_to_the_cpu_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (x,) = list(prefetch_to_device([np.ones(3)]))
    assert x.device.type == "cpu"


# -- the train CLI's data flags against the JAX CLI ------------------------------


@pytest.fixture
def registered(tiny_cfg, monkeypatch):
    import vit_tpu.config as jconfig
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(jconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    monkeypatch.setitem(tconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    return tiny_cfg


@pytest.fixture(scope="module")
def init_npz(tmp_path_factory, tiny_cfg):
    import jax

    from vit_tpu.models import vit as jvit

    path = tmp_path_factory.mktemp("init") / "init.npz"
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32),
                        jvit.init_params(jax.random.key(3), tiny_cfg))
    jckpt.save_npz(tree, str(path))
    return path


def _records(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def _both_clis(tmp_path, flags, capsys):
    """Run the port's and the JAX package's train CLI on ``flags`` ->
    ((port records, port stdout), (JAX records, JAX stdout))."""
    from vit_tpu.cli.train import main as jmain
    from vit_tpu_torch.cli.train import main as tmain

    assert tmain([*flags, "--device", "cpu", "--log-jsonl", str(tmp_path / "t.jsonl")]) == 0
    tout = capsys.readouterr().out
    assert jmain([*flags, "--dp", "1", "--no-compile-cache",
                  "--log-jsonl", str(tmp_path / "j.jsonl")]) == 0
    jout = capsys.readouterr().out
    return (_records(tmp_path / "t.jsonl"), tout), (_records(tmp_path / "j.jsonl"), jout)


def _train_flags(cfg, init, steps=5):
    return ["--config", cfg.name, "--init-weights", str(init), "--steps", str(steps),
            "--batch", "4", "--ops", "fused_train", "--seed", "7"]


def _lines(out: str, key: str):
    return [line for line in out.splitlines() if key in line]


def test_train_cli_data_dir_matches_jax(registered, shards, init_npz, tmp_path, capsys):
    # 5 steps of 4 over 21 images: the stream crosses into the second epoch
    flags = [*_train_flags(registered, init_npz), "--data-dir", str(shards),
             "--data-threads", "2"]
    (got, tout), (want, jout) = _both_clis(tmp_path, flags, capsys)
    assert len(got) == len(want) == 5
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want],
                               atol=1e-4, rtol=0)
    assert _lines(tout, "data: ") == ["data: 21 images in 3 shard(s), native reader, 2 threads"]
    # the JAX package's line names the reader its own checkout has built
    assert _lines(jout, "data: ")[0].startswith("data: 21 images in 3 shard(s), ")


def test_train_cli_eval_data_dir_matches_jax(registered, shards, init_npz, tmp_path, capsys):
    held = _write_shards(tmp_path / "held", registered, seed=11, sizes=(6, 5))
    flags = [*_train_flags(registered, init_npz), "--data-dir", str(shards),
             "--eval-data-dir", str(held), "--eval-every", "2", "--eval-batches", "2"]
    (got, tout), (want, jout) = _both_clis(tmp_path, flags, capsys)
    evals = [r for r in got if "eval_top1" in r]
    assert evals == [r for r in want if "eval_top1" in r]
    assert [r["step"] for r in evals] == [1, 3, 5] and evals[-1]["final"] is True
    assert _lines(tout, "eval") == _lines(jout, "eval")
    assert "eval: 8 held-out images every 2 steps" in tout
    assert _lines(tout, "final eval top-1")[0].endswith("(params)")
    np.testing.assert_allclose([r["loss"] for r in got if "loss" in r],
                               [r["loss"] for r in want if "loss" in r], atol=1e-4, rtol=0)


def test_train_cli_image_dir_matches_jax(registered, folder, init_npz, tmp_path, capsys):
    flags = [*_train_flags(registered, init_npz, steps=3), "--image-dir", str(folder)]
    (got, tout), (want, _) = _both_clis(tmp_path, flags, capsys)
    np.testing.assert_allclose([r["loss"] for r in got], [r["loss"] for r in want],
                               atol=1e-4, rtol=0)
    assert "data: 12 raw images in 3 class folders, PIL decoder, 8 threads" in tout


@pytest.mark.parametrize("extra,message", [
    (["--eval-data-dir", "SHARDS"], "--eval-data-dir requires --eval-every N"),
    (["--eval-data-dir", "SHARDS", "--eval-every", "1", "--batch", "32"],
     "21 eval image(s) < --batch 32"),
    (["--data-dir", "SHARDS", "--batch", "32"], "21 image(s) < --batch 32"),
    (["--mae", "--eval-data-dir", "SHARDS", "--eval-every", "1"], "--eval-data-dir"),
])
def test_train_cli_data_refusals(registered, shards, capsys, extra, message):
    from vit_tpu_torch.cli.train import main

    flags = [a.replace("SHARDS", str(shards)) for a in extra]
    assert main(["--config", registered.name, "--steps", "1", "--batch", "4",
                 "--device", "cpu", *flags]) == 2
    assert message in capsys.readouterr().err


def test_train_cli_dp2_and_tp2_read_the_one_card_runs_batches(registered, shards, init_npz,
                                                              tmp_path, capsys):
    """Two gloo ranks (``tests/torch_parallel_train_worker.py --cli``) step
    on the one-device run's global batches: at --dp 2 each reads its half
    and the dp-averaged losses are the one-device losses; at --tp 2 both
    read every row, and the held-out eval, on the tree gathered by every
    rank, scores as the one-device run's."""
    from vit_tpu_torch.cli.train import main

    held = _write_shards(tmp_path / "held", registered, seed=11, sizes=(6, 5))
    flags = [*_train_flags(registered, init_npz), "--data-dir", str(shards)]
    evals = ["--eval-data-dir", str(held), "--eval-every", "2"]
    assert main([*flags, *evals, "--device", "cpu",
                 "--log-jsonl", str(tmp_path / "one.jsonl")]) == 0
    capsys.readouterr()
    env = dict(os.environ, PYTHONPATH=f"{REPO}:{REPO / 'tests'}", OMP_NUM_THREADS="1")
    env.pop("WORLD_SIZE", None)
    ranks = ["--device", "cpu", "--dist-backend", "gloo"]
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2", "--standalone",
         str(REPO / "tests" / "torch_parallel_train_worker.py"), "--cli",
         *flags, *ranks, "--dp", "2", "--log-jsonl", str(tmp_path / "dp.jsonl"), "--and",
         *flags, *evals, *ranks, "--tp", "2", "--log-jsonl", str(tmp_path / "tp.jsonl")],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("data: 21 images in 3 shard(s)") == 2  # rank 0 alone prints
    one, dp, tp = (_records(tmp_path / f"{n}.jsonl") for n in ("one", "dp", "tp"))
    losses = [r["loss"] for r in one if "loss" in r]
    assert len(losses) == len(dp) == 5
    np.testing.assert_allclose([r["loss"] for r in dp], losses, atol=1e-5, rtol=0)
    np.testing.assert_allclose([r["loss"] for r in tp if "loss" in r], losses, atol=1e-5, rtol=0)
    assert [r for r in tp if "eval_top1" in r] == [r for r in one if "eval_top1" in r]
    assert len([r for r in tp if "eval_top1" in r]) == 3


def test_train_cli_rows_of_each_rank(registered, shards, monkeypatch):
    """Each dp rank reads only its rows of the one-device run's batch."""
    from vit_tpu_torch.cli import train_setup
    from vit_tpu_torch.cli.train_args import build_parser
    from vit_tpu_torch.parallel.mesh import Mesh

    reads = []
    orig = tds.BinShardDataset.read
    monkeypatch.setattr(tds.BinShardDataset, "read",
                        lambda self, idx: reads.append(np.asarray(idx)) or orig(self, idx))
    args = build_parser().parse_args(["--data-dir", str(shards), "--batch", "4", "--seed", "7"])
    whole = list(itertools.islice(tds.BinShardDataset(shards).batch_indices(4, seed=7), 3))
    for rank in (0, 1):
        reads.clear()
        mesh = Mesh({"dp": 2, "tp": 1}, rank, {})
        stream = train_setup._build_data(args, registered, mesh, torch.device("cpu"), 0)
        got = [next(stream) for _ in range(3)]
        stream.close()
        for take, idx, (x, y) in zip(whole, reads, got):
            np.testing.assert_array_equal(idx, take[2 * rank : 2 * rank + 2])
            assert x.shape == (2, 3, 32, 32) and y.shape == (2,)
