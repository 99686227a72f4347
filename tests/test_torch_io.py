"""The port's configuration and file formats against the JAX package's
(``vit_tpu.config``, ``vit_tpu.io.images`` / ``checkpoint`` / ``labels``,
``vit_tpu.eval.comparator``), and the import boundary: ``chip_smoke.py``
and the port's classify and train paths load nothing of the JAX package.
Values are compared exactly: both sides run the same numpy code paths."""

import ast
import dataclasses
import os
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
from vit_tpu_torch.eval import comparator as tcomp
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
    assert ([tuple(r) for r in tcomp.parse_result_file(mine)]
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


def _imported_modules(path):
    """Every module an ``import`` of the file names, at the top or inside
    a function."""
    modules = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            modules += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            modules.append(node.module or "")
    return modules


def _jax_side(modules):
    return [m for m in modules if m.split(".")[0] in ("vit_tpu", "jax", "jaxlib")]


@pytest.mark.parametrize("script", ["chip_smoke.py", "tests/test_torch_cuda.py",
                                    "tests/torch_pp_sp_worker.py",
                                    "tests/torch_serve_worker.py"])
def test_card_scripts_import_nothing_of_the_jax_package(script):
    """What runs on the card (and the pipeline, sequence and serving tests'
    rank workers) names no module of JAX or of the JAX package, at the top
    or inside a function."""
    modules = _imported_modules(REPO / script)
    assert not _jax_side(modules)
    assert any(m.startswith("vit_tpu_torch") for m in modules)


PORT_FILES = sorted(str(p.relative_to(REPO)) for p in (REPO / "vit_tpu_torch").rglob("*.py"))


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_module_imports_nothing_of_the_jax_package(path):
    assert not _jax_side(_imported_modules(REPO / path))


# -- the classify CLI's readers against the JAX package's --------------------


def _ref_dir(tmp_path, cfg, seed=1, drop=()):
    from vit_tpu.io import weights as jweights

    d = tmp_path / "Network"
    tensors = jweights.synth_reference_tensors(cfg, seed=seed)
    for idx in drop:
        del tensors[idx]
    jweights.save_reference_weights(tensors, d, cfg)
    return d


@pytest.mark.parametrize("round6,drop", [(True, ()), (False, ()), (True, (1, 6, 17))],
                         ids=["round6", "raw", "synth_fill"])
def test_weight_dir_reads_like_jax(tmp_path, tiny_cfg, round6, drop):
    from vit_tpu.io import weights as jweights
    from vit_tpu_torch.io import weights as tweights

    d = _ref_dir(tmp_path, tiny_cfg, drop=drop)
    kw = dict(round_to_6dp=round6, allow_synth=bool(drop))
    _assert_same_tree(tweights.load_reference_weights(d, tiny_cfg, **kw),
                      jweights.load_reference_weights(d, tiny_cfg, **kw))
    got, want = tweights.synth_reference_tensors(tiny_cfg, 3), jweights.synth_reference_tensors(tiny_cfg, 3)
    assert got.keys() == want.keys() and all(np.array_equal(got[k], want[k]) for k in want)
    x = np.random.default_rng(0).normal(size=1000).astype(np.float32) * 3
    np.testing.assert_array_equal(tweights.round6(x), jweights.round6(x))
    if drop:
        with pytest.raises(FileNotFoundError, match="missing Weight_1_"):
            tweights.load_reference_weights(d, tiny_cfg)


def test_pth_and_every_route_load_like_jax(tmp_path, tiny_cfg):
    import torch

    from vit_tpu.io import weights as jweights
    from vit_tpu.io.load_any import load_params_any as jload
    from vit_tpu.io.torch_convert import save_pth
    from vit_tpu_torch.io.load_any import load_params_any as tload

    params = jweights.params_from_tensors(jweights.synth_reference_tensors(tiny_cfg, seed=2), tiny_cfg)
    save_pth(params, tmp_path / "model.pth", tiny_cfg)
    jckpt.save_npz(params, tmp_path / "p.npz")
    d = _ref_dir(tmp_path, tiny_cfg, drop=(5,))
    for source, kw in ((tmp_path / "model.pth", {}), (tmp_path / "p.npz", {}),
                       (d, dict(allow_synth=True)), (d, dict(allow_synth=True, round_to_6dp=False))):
        _assert_same_tree(tload(source, tiny_cfg, **kw), jload(source, tiny_cfg, **kw))
    sd = torch.load(tmp_path / "model.pth", weights_only=True)
    del sd["encoder.ln.weight"]
    torch.save(sd, tmp_path / "bad.pth")
    with pytest.raises(KeyError, match="encoder.ln.weight"):
        tload(tmp_path / "bad.pth", tiny_cfg)
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        tload(tmp_path / "orbax", tiny_cfg)
    with pytest.raises(ValueError, match="unrecognized weight source"):
        tload(tmp_path / "weights.txt", tiny_cfg)
    with pytest.raises(ValueError, match="head geometry"):
        tload(tmp_path / "model.pth", dataclasses.replace(tiny_cfg, native_checkpoints=False))


def _pngs(tmp_path):
    from PIL import Image

    rng = np.random.default_rng(4)
    paths = []
    for name, (w, h) in (("a_wide.png", (53, 37)), ("b_tall.png", (30, 61))):
        Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(tmp_path / name)
        paths.append(tmp_path / name)
    return paths


def test_preprocess_matches_jax(tmp_path, tiny_cfg):
    from vit_tpu.io import preprocess as jpre
    from vit_tpu_torch.io import preprocess as tpre

    paths = _pngs(tmp_path)
    (tmp_path / "notes.txt").write_text("not an image")
    got, got_names = tpre.load_and_preprocess([str(tmp_path)], tiny_cfg)
    want, want_names = jpre.load_and_preprocess([str(tmp_path)], tiny_cfg)
    assert got.shape == (2, 3, 32, 32) and got_names == want_names == [str(p) for p in paths]
    np.testing.assert_array_equal(got, want)
    arr = np.random.default_rng(5).integers(0, 256, (40, 45, 3), dtype=np.uint8)
    np.testing.assert_array_equal(tpre.preprocess_image(arr, 24, 30), jpre.preprocess_image(arr, 24, 30))
    with pytest.raises(FileNotFoundError):
        tpre.collect_image_paths([str(tmp_path / "absent.png")])


def test_comparator_matches_jax(tmp_path):
    golden = tmp_path / "golden.txt"
    comparator.write_result_file([3, 7, 9, 1, 4], [0.5, 0.25, 0.9, 0.3, 0.6], golden)
    got = tmp_path / "got.txt"
    got.write_text("[0] label: 3 / prob: 0.505000\n[1] label: 8 / prob: 0.250000\n"
                   "[2] label: 9 / prob: 0.950000\n\n[3] label: 1 / prob: nan\n")
    for count in (None, 1, 3, 6):
        want = [(m.index, m.kind, m.got and tuple(dataclasses.astuple(m.got)),
                 m.want and tuple(dataclasses.astuple(m.want)))
                for m in comparator.compare_files(got, golden, count=count)]
        mine = [(m.index, m.kind, m.got and tuple(m.got), m.want and tuple(m.want))
                for m in tcomp.compare_files(got, golden, count=count)]
        assert mine == want
        assert ([str(m) for m in tcomp.compare_results(tcomp.parse_result_file(got),
                                                       tcomp.parse_result_file(golden), count)]
                == [str(m) for m in comparator.compare_results(comparator.parse_result_file(got),
                                                               comparator.parse_result_file(golden), count)])


def test_main_paths_load_nothing_of_the_jax_package(tmp_path, tiny_cfg):
    """chip_smoke, then on the CPU: the train CLI (fused_train, --save; and
    regularized, eager and fused_train; with --optimizer fused_adamw; with
    --ops qat; with --mae and --save-backbone; with --distill-teacher on
    the fused and the int8 teacher; and with --tome, plain and
    regularized), and the classify CLI on its npz, on
    a Weight_*.bin directory, on a .pth, on --images, with --golden, with
    --ops quant, with --ops per_op --profile, with --attn-rollout and with
    --tome on fused and quant, and under torch.distributed.run on 2 ranks
    with --tp 2 (fused and quant) and the train CLI with --pp 2 (eager and
    fused_train) and --sp 2 (eager and fused_train) and the serve CLI's
    --selftest with --tp 2; the serve CLI's --selftest, saturated and
    paced; the train CLI's --data-dir with --eval-data-dir and its
    --image-dir; the eval CLI on shards (fused, quant) and on an image folder
    with --tome: no vit_tpu or jax module gets loaded."""
    from vit_tpu.io import weights as jweights
    from vit_tpu.io.torch_convert import save_pth

    _ref_dir(tmp_path, tiny_cfg, drop=(4, 9))
    save_pth(jweights.params_from_tensors(jweights.synth_reference_tensors(tiny_cfg, 1), tiny_cfg),
             tmp_path / "model.pth", tiny_cfg)
    _pngs(tmp_path)
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
run = ["--config", cfg.name, "--device", "cpu"]
assert train.main([*run, "--steps", "1", "--batch", "2", "--ops", "fused_train",
                   "--save", d + "/p.npz"]) == 0
for ops in ("eager", "fused_train"):
    assert train.main([*run, "--steps", "1", "--batch", "2", "--ops", ops,
                       "--dropout", "0.1", "--drop-path", "0.1"]) == 0
assert train.main([*run, "--steps", "2", "--batch", "2", "--ops", "fused_train",
                   "--optimizer", "fused_adamw", "--schedule", "warmup_cosine"]) == 0
assert train.main([*run, "--steps", "1", "--batch", "2", "--ops", "qat"]) == 0
assert train.main([*run, "--steps", "1", "--batch", "2", "--ops", "fused_train", "--mae",
                   "--mask-ratio", "0.5", "--mae-decoder", "32,1,2",
                   "--save-backbone", d + "/bb.npz"]) == 0
deit = config.ViTConfig(image_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
                        num_classes=11, distilled=True, name="deit_tiny_test")
config.CONFIGS[deit.name] = deit
for extra in ([], ["--distill-teacher-int8"]):
    assert train.main(["--config", deit.name, "--device", "cpu", "--steps", "1", "--batch", "2",
                       "--ops", "fused_train", "--distill-teacher", d + "/bb.npz",
                       "--distill-config", cfg.name, *extra]) == 0
assert classify.main([*run, "--weights", d + "/p.npz", "--synth", "2", "--ops", "fused",
                      "--output", d + "/r.txt"]) == 0
assert classify.main([*run, "--weights", d + "/Network", "--allow-synth-weights",
                      "--synth", "2", "--ops", "fused"]) == 0
assert classify.main([*run, "--weights", d + "/model.pth", "--images", d + "/a_wide.png",
                      d + "/b_tall.png", "--output", d + "/img.txt"]) == 0
assert classify.main([*run, "--weights", d + "/model.pth", "--images", d,
                      "--golden", d + "/img.txt"]) == 0
for dtype in ("bfloat16", "float32"):
    assert classify.main([*run, "--weights", d + "/p.npz", "--synth", "2", "--ops", "quant",
                          "--dtype", dtype]) == 0
assert classify.main([*run, "--weights", d + "/p.npz", "--synth", "2", "--ops", "per_op",
                      "--profile"]) == 0
assert classify.main([*run, "--weights", d + "/p.npz", "--synth", "2",
                      "--attn-rollout", d + "/roll.npz"]) == 0
from vit_tpu_torch.cli import serve
for extra in ([], ["--selftest-rate", "200"]):
    assert serve.main([*run, "--weights", d + "/p.npz", "--selftest", "4", "--max-batch", "4",
                       "--batch-pad", "4", *extra]) == 0
import os
import numpy as np
from PIL import Image
from vit_tpu_torch.cli import eval as evaluate
from vit_tpu_torch.io.images import synth_images
os.makedirs(d + "/shards")
x = synth_images(6, cfg, seed=3)
with open(d + "/shards/s.bin", "wb") as fh:
    np.array(x.shape, "<i4").tofile(fh)
    x.astype("<f4").tofile(fh)
(np.arange(6) % 11).astype("<i4").tofile(d + "/shards/s.labels.bin")
for c in ("a", "b"):
    os.makedirs(d + "/classes/" + c)
    for j in range(2):
        Image.new("RGB", (40, 36 + j), (60 * j, 90, 30)).save(d + "/classes/" + c + "/%d.png" % j)
assert train.main([*run, "--steps", "2", "--batch", "2", "--ops", "fused_train",
                   "--data-dir", d + "/shards", "--eval-data-dir", d + "/shards",
                   "--eval-every", "1"]) == 0
assert train.main([*run, "--steps", "1", "--batch", "2", "--image-dir", d + "/classes"]) == 0
for ops in ("fused", "quant"):
    assert evaluate.main([*run, "--weights", d + "/p.npz", "--data-dir", d + "/shards",
                          "--ops", ops, "--batch", "4"]) == 0
assert evaluate.main([*run, "--weights", d + "/p.npz", "--image-dir", d + "/classes",
                      "--tome", "1", "--ops", "fused"]) == 0
tome = config.ViTConfig(image_size=64, patch_size=8, embed_dim=64, depth=2, num_heads=4,
                        num_classes=11, name="vit_tome_test")  # 65 tokens: merges happen
config.CONFIGS[tome.name] = tome
run = ["--config", tome.name, "--device", "cpu", "--tome", "4"]
for extra in ([], ["--dropout", "0.1", "--drop-path", "0.1"]):
    assert train.main([*run, "--steps", "1", "--batch", "2", "--ops", "fused_train",
                       "--save", d + "/t.npz", *extra]) == 0
for ops in ("fused", "quant"):
    assert classify.main([*run, "--weights", d + "/t.npz", "--synth", "2", "--ops", ops]) == 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("vit_tpu", "jax", "jaxlib"))
assert not loaded, loaded
"""
    out = subprocess.run([sys.executable, "-c", code], timeout=300, cwd=tmp_path,
                         capture_output=True, text=True)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "comparator: 0 error(s) over 2 line(s)" in out.stdout
    rank = tmp_path / "rank.py"
    rank.write_text(f"""
import sys
sys.path.insert(0, {str(REPO)!r})
from vit_tpu_torch import config
from vit_tpu_torch.cli import main as classify
cfg = config.ViTConfig(image_size=32, patch_size=16, embed_dim=64, depth=2, num_heads=4,
                       num_classes=11, name="vit_tiny_test")
config.CONFIGS[cfg.name] = cfg
for ops in ("fused", "quant"):
    assert classify.main(["--config", cfg.name, "--device", "cpu", "--tp", "2", "--ops", ops,
                          "--weights", {str(tmp_path / "p.npz")!r}, "--synth", "2"]) == 0
from vit_tpu_torch.cli import serve
assert serve.main(["--config", cfg.name, "--device", "cpu", "--tp", "2", "--ops", "fused",
                   "--weights", {str(tmp_path / "p.npz")!r}, "--selftest", "3", "--max-batch",
                   "4", "--batch-pad", "4"]) == 0
from vit_tpu_torch.cli import train
for flags in (["--pp", "2", "--microbatches", "1"], ["--sp", "2"]):
    for ops in ("eager", "fused_train"):
        assert train.main(["--config", cfg.name, "--device", "cpu", "--steps", "1", "--batch",
                           "2", "--ops", ops, *flags]) == 0
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("vit_tpu", "jax", "jaxlib"))
assert not loaded, loaded
""")
    env = {k: v for k, v in os.environ.items() if k != "WORLD_SIZE"}
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", "2", str(rank)], timeout=120, cwd=tmp_path,
                         capture_output=True, text=True, env=dict(env, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr[-3000:]
    # rank 0's line of each --tp 2 run: the classify CLI's two, the serve CLI's
    assert out.stdout.count("mesh: {'dp': 1, 'tp': 2} over 2 rank(s), backend gloo") == 3
    assert out.stdout.count("[1] label:") == 2  # rank 0's lines only
    assert "pipeline: 2 stage(s), 1 microbatches" in out.stdout
    assert out.stdout.count('"metric": "serving images/sec') == 1  # rank 0's line only
    assert "sequence parallel: ring size 2 (ops fused_train)" in out.stdout
