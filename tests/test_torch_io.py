"""The port's configuration and file formats against the JAX package's
(``vit_tpu.config``, ``vit_tpu.io.images`` / ``checkpoint`` / ``labels``,
``vit_tpu.eval.comparator``), and the import boundary: ``chip_smoke.py``
and the port's classify and train paths load nothing of the JAX package.
Values are compared exactly: both sides run the same numpy code paths."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from vit_tpu import config as jconfig
from vit_tpu.eval import comparator
from vit_tpu.io import checkpoint as jckpt
from vit_tpu.io import images as jimages
from vit_tpu.io import labels as jlabels
from vit_tpu_torch import config as tconfig
from vit_tpu_torch.io import checkpoint as tckpt
from vit_tpu_torch.io import images as timages
from vit_tpu_torch.io import results

REPO = Path(__file__).resolve().parents[1]
PROPERTIES = ("grid_size", "num_patches", "num_prefix_tokens", "seq_len", "head_dim",
              "mlp_dim", "patch_dim")


@pytest.mark.parametrize("name", sorted(jconfig.CONFIGS))
def test_config_matches_jax(name):
    got, want = tconfig.get_config(name), jconfig.get_config(name)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for prop in PROPERTIES:
        assert getattr(got, prop) == getattr(want, prop)


def test_config_registry_and_overrides():
    from vit_tpu.cli.common import resolve_config

    assert set(tconfig.CONFIGS) == set(jconfig.CONFIGS)
    assert (dataclasses.asdict(tconfig.resolve_config("deit_s_16", 5))
            == dataclasses.asdict(resolve_config("deit_s_16", 5)))
    with pytest.raises(KeyError, match="unknown config"):
        tconfig.get_config("vit_unknown")
    with pytest.raises(ValueError, match="not a multiple"):
        tconfig.VIT_B_16.with_image_size(100)


def test_images_match_jax(tmp_path):
    cfg = dataclasses.replace(tconfig.VIT_B_16, image_size=32)
    np.testing.assert_array_equal(timages.synth_images(3, cfg, seed=7),
                                  jimages.synth_images(3, cfg, seed=7))
    path = tmp_path / "in.bin"
    jimages.save_image_bin(jimages.synth_images(2, cfg, seed=8), path)
    np.testing.assert_array_equal(timages.load_image_bin(path), jimages.load_image_bin(path))
    path.write_bytes(path.read_bytes()[:100])
    with pytest.raises(ValueError, match="expected"):
        timages.load_image_bin(path)


def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"blocks": {"wqkv": rng.normal(size=(2, 4, 12)).astype(np.float32),
                       "b1": rng.normal(size=(2, 8)).astype(np.float32)},
            "cls_token": rng.normal(size=4).astype(np.float32),
            "head": {"kernel": rng.normal(size=(4, 3)).astype(np.float32),
                     "bias": np.zeros(3, np.float32)}}


def _assert_same_tree(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_same_tree(got[k], v)
        else:
            np.testing.assert_array_equal(got[k], v)


@pytest.mark.parametrize("writer", [tckpt, jckpt], ids=["port", "jax"])
def test_npz_reads_back_in_both_packages(tmp_path, writer):
    tree, path = _tree(0), tmp_path / "params"  # suffixless: written to exactly this name
    writer.save_npz(tree, path)
    for reader in (tckpt, jckpt):
        _assert_same_tree(reader.load_npz(path), tree)
    assert not tckpt.is_train_state(path)


def test_train_state_params(tmp_path):
    tree, path = _tree(1), tmp_path / "state.npz"
    jckpt.save_train_state(tree, (np.zeros(3, np.float32),), 5, path)
    assert tckpt.is_train_state(path)
    _assert_same_tree(tckpt.load_params_from_state(path), tree)


def test_result_lines_match_comparator(tmp_path):
    labels, probs = [3, 999, 0], [0.5, 0.01234567, 1.0]
    for i, (label, prob) in enumerate(zip(labels, probs)):
        assert results.format_result_line(i, label, prob) == comparator.format_result_line(i, label, prob)
    mine, theirs = tmp_path / "a.txt", tmp_path / "b.txt"
    results.write_result_file(labels, probs, mine)
    comparator.write_result_file(labels, probs, theirs)
    assert mine.read_text() == theirs.read_text()
    assert ([tuple(r) for r in results.parse_result_file(mine)]
            == [(r.index, r.label, r.prob) for r in comparator.parse_result_file(mine)])


@pytest.mark.parametrize("source", ["packaged", "text", "c_source", "placeholder"])
def test_labels_match_jax(tmp_path, monkeypatch, source):
    monkeypatch.delenv("VIT_TPU_LABELS_SOURCE", raising=False)
    path, n = None, 1000
    if source == "text":
        path, n = tmp_path / "names.txt", 3
        path.write_text("tench\n\ngoldfish\nshark\nextra\n")
    elif source == "c_source":
        path, n = tmp_path / "Main.c", 3
        path.write_text('int x[] = {1};\nconst char *names[] = {"a", "b \\"q\\"", "c", "d"};\n')
    elif source == "placeholder":
        n = 1500  # more classes than the packaged table covers
    got = results.load_labels(None if path is None else str(path), n)
    assert got == jlabels.load_labels(None if path is None else str(path), n)
    assert len(got) == n
    if path is not None:
        with pytest.raises(ValueError, match="need"):
            results.load_labels(str(path), 10)


@pytest.mark.parametrize("script", ["chip_smoke.py", "tests/test_torch_cuda.py"])
def test_card_scripts_import_nothing_of_the_jax_package(script):
    """What runs on the card names no module of JAX or of the JAX package,
    at the top or inside a function."""
    modules = []
    for node in ast.walk(ast.parse((REPO / script).read_text())):
        if isinstance(node, ast.Import):
            modules += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            modules.append(node.module or "")
    assert not [m for m in modules if m.split(".")[0] in ("vit_tpu", "jax", "jaxlib")]
    assert any(m.startswith("vit_tpu_torch") for m in modules)


def test_main_paths_load_nothing_of_the_jax_package(tmp_path):
    """chip_smoke, then the train CLI (fused_train, --save) and the classify
    CLI on its npz (fused, --output) on the CPU: no vit_tpu or jax module
    gets loaded."""
    code = f"""
import sys
sys.path.insert(0, {str(REPO)!r})
import chip_smoke
from vit_tpu_torch import config
from vit_tpu_torch.cli import main as classify, profile_train, train
cfg = config.ViTConfig(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                       num_classes=11, name="vit_tiny_test")
config.CONFIGS[cfg.name] = cfg
d = {str(tmp_path)!r}
assert train.main(["--config", cfg.name, "--steps", "1", "--batch", "2", "--ops", "fused_train",
                   "--device", "cpu", "--save", d + "/p.npz"]) == 0
assert classify.main(["--config", cfg.name, "--weights", d + "/p.npz", "--synth", "2",
                      "--ops", "fused", "--device", "cpu", "--output", d + "/r.txt"]) == 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("vit_tpu", "jax", "jaxlib"))
assert not loaded, loaded
"""
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300, cwd=tmp_path)
