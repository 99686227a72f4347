"""The port's checkpoint conversion and resolution transfer against the JAX
package's, on the CPU: ``io/images.save_image_bin``/``preprocess``,
``io/torch_convert``, ``io/hf_convert``, ``io/interpolate``, the
``vit-tpu-torch-convert`` CLI against ``vit-tpu-convert``, and the classify
CLI's ``--interpolate-pos-from`` and ``--ops auto`` against the JAX CLI's.

Tolerances: the converters and the image helpers move fp32 values without
arithmetic, so they must match bit for bit (files byte for byte).  The
torch-exact bicubic (float64 weights cast to fp32, fp32 contraction):
1e-6 of the table's largest |value| (fp32 summation order).  The other
``jax.image.resize`` methods: 1e-5 of it (the weights are computed in fp32
on both sides, the Lanczos kernels through numpy's and XLA's fp32 sine).
The forward at the new resolution: 1e-5, the eager/xla logits bar of
``tests/test_torch_engine.py``.
"""

import contextlib
import dataclasses
import io
import shutil
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.config as jconfig
import vit_tpu_torch.config as tconfig
from vit_tpu.cli import convert as jconvert
from vit_tpu.cli import main as jmain
from vit_tpu.io import hf_convert as jhf
from vit_tpu.io import images as jimages
from vit_tpu.io import interpolate as jinterp
from vit_tpu.io import torch_convert as jtc
from vit_tpu.io import weights as jwio
from vit_tpu.models import vit as jvit
from vit_tpu_torch.cli import convert as tconvert
from vit_tpu_torch.cli import main as tmain
from vit_tpu_torch.io import hf_convert as thf
from vit_tpu_torch.io import images as timages
from vit_tpu_torch.io import interpolate as tinterp
from vit_tpu_torch.io import torch_convert as ttc
from vit_tpu_torch.io import weights as twio
from vit_tpu_torch.io.params import params_from_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.utils.tree import flatten_tree


def _same_leaves(got, want):
    got, want = flatten_tree(dict(got)), flatten_tree(dict(want))
    assert got.keys() == want.keys()
    for k in want:
        g = got[k].float().numpy() if isinstance(got[k], torch.Tensor) else np.asarray(got[k])
        np.testing.assert_array_equal(g, np.asarray(want[k], np.float32), err_msg=k)


@pytest.fixture
def configs(tiny_cfg, monkeypatch):
    """The tiny config at 32 px (grid 2) and 48 px (grid 3), a 7-class head
    of it, and a tiny DeiT, registered in both packages."""
    big = dataclasses.replace(tiny_cfg, image_size=48, name="vit_tiny48_test")
    deit = dataclasses.replace(tiny_cfg, distilled=True, name="deit_tiny_test")
    for cfg in (tiny_cfg, big, deit):
        monkeypatch.setitem(jconfig.CONFIGS, cfg.name, cfg)
        monkeypatch.setitem(tconfig.CONFIGS, cfg.name, tconfig.ViTConfig(**dataclasses.asdict(cfg)))
    return tiny_cfg, big, deit


# -- the image helpers ---------------------------------------------------------


def test_image_helpers_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 3, 5, 4)).astype(np.float32)
    jimages.save_image_bin(x, tmp_path / "j.bin")
    timages.save_image_bin(x, tmp_path / "t.bin")
    assert (tmp_path / "j.bin").read_bytes() == (tmp_path / "t.bin").read_bytes()
    np.testing.assert_array_equal(timages.load_image_bin(tmp_path / "t.bin"), x)
    raw = rng.integers(0, 256, size=(2, 7, 6, 3), dtype=np.uint8)
    got, want = timages.preprocess(raw), jimages.preprocess(raw)
    assert got.dtype == want.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)


# -- torchvision state dicts -----------------------------------------------------


def test_state_dict_and_reference_bins_match_jax(tiny_cfg, tmp_path):
    params = jwio.params_from_tensors(jwio.synth_reference_tensors(tiny_cfg, 5), tiny_cfg)
    want = jtc.state_dict_from_params(params, tiny_cfg)
    got = ttc.state_dict_from_params(params, tiny_cfg)
    assert list(got) == list(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["class_token"].shape == (1, 1, 64)
    assert got["encoder.pos_embedding"].shape == (1, tiny_cfg.seq_len, 64)
    for _, name, _ in twio.reference_tensor_specs(tiny_cfg):
        assert ttc.state_dict_key(name) == jtc.state_dict_key(name)
    # export_reference_bins: the same files, byte for byte
    sd = {k: torch.from_numpy(v) for k, v in want.items()}
    jtc.export_reference_bins(sd, tmp_path / "j", tiny_cfg)
    ttc.export_reference_bins(sd, tmp_path / "t", tiny_cfg)
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "t").iterdir())
    for n in names:
        assert (tmp_path / "j" / n).read_bytes() == (tmp_path / "t" / n).read_bytes(), n
    _same_leaves(ttc.params_from_state_dict(sd, tiny_cfg, round_to_6dp=True),
                 jtc.params_from_state_dict(sd, tiny_cfg, round_to_6dp=True))
    # a missing key and a distilled config: the JAX package's errors
    del sd["encoder.ln.bias"]
    for fn in (ttc.tensors_from_state_dict, jtc.tensors_from_state_dict):
        with pytest.raises(KeyError, match="state dict missing 'encoder.ln.bias'"):
            fn(sd, tiny_cfg)
    deit = dataclasses.replace(tiny_cfg, distilled=True)
    msgs = []
    for fn in (ttc.tensors_from_state_dict, jtc.tensors_from_state_dict):
        with pytest.raises(ValueError) as e:
            fn(sd, deit)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_pth_round_trips_between_the_packages(tiny_cfg, tmp_path):
    params = jwio.params_from_tensors(jwio.synth_reference_tensors(tiny_cfg, 6), tiny_cfg)
    ttc.save_pth(params, tmp_path / "port.pth", tiny_cfg)
    jtc.save_pth(params, tmp_path / "jax.pth", tiny_cfg)
    sd = torch.load(tmp_path / "port.pth", weights_only=True)
    assert all(v.dtype == torch.float32 for v in sd.values())
    _same_leaves(jtc.load_pth(tmp_path / "port.pth", tiny_cfg), params)
    _same_leaves(ttc.load_pth(tmp_path / "jax.pth", tiny_cfg), params)
    _same_leaves(ttc.load_pth(tmp_path / "port.pth", tiny_cfg), params)


# -- HuggingFace state dicts ---------------------------------------------------------


def _hf_state_dict(cfg, layout: str, seed: int = 0) -> dict:
    """A HF-layout state dict (keys as ``vit_tpu/io/hf_convert.py`` reads
    them) of seeded numpy arrays: ``vit`` (ViTForImageClassification),
    ``deit_dual`` (…WithTeacher), ``deit_single`` (DeiTForImageClassification)."""
    rng = np.random.default_rng(seed)
    d, f, k = cfg.embed_dim, cfg.mlp_dim, cfg.num_classes
    a = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    mp = "vit" if layout == "vit" else "deit"
    prefix_tokens = 1 if layout == "vit" else 2
    sd = {
        f"{mp}.embeddings.cls_token": a(1, 1, d),
        f"{mp}.embeddings.position_embeddings": a(1, cfg.num_patches + prefix_tokens, d),
        f"{mp}.embeddings.patch_embeddings.projection.weight": a(d, 3, cfg.patch_size,
                                                                 cfg.patch_size),
        f"{mp}.embeddings.patch_embeddings.projection.bias": a(d),
        f"{mp}.layernorm.weight": a(d), f"{mp}.layernorm.bias": a(d),
    }
    for l in range(cfg.depth):
        p = f"{mp}.encoder.layer.{l}"
        for n in ("query", "key", "value"):
            sd[f"{p}.attention.attention.{n}.weight"] = a(d, d)
            sd[f"{p}.attention.attention.{n}.bias"] = a(d)
        sd.update({
            f"{p}.attention.output.dense.weight": a(d, d),
            f"{p}.attention.output.dense.bias": a(d),
            f"{p}.intermediate.dense.weight": a(f, d), f"{p}.intermediate.dense.bias": a(f),
            f"{p}.output.dense.weight": a(d, f), f"{p}.output.dense.bias": a(d),
            f"{p}.layernorm_before.weight": a(d), f"{p}.layernorm_before.bias": a(d),
            f"{p}.layernorm_after.weight": a(d), f"{p}.layernorm_after.bias": a(d),
        })
    if layout != "vit":
        sd[f"{mp}.embeddings.distillation_token"] = a(1, 1, d)
    heads = ("cls_classifier", "distillation_classifier") if layout == "deit_dual" \
        else ("classifier",)
    for h in heads:
        sd[f"{h}.weight"], sd[f"{h}.bias"] = a(k, d), a(k)
    return sd


@pytest.mark.parametrize("layout", ["vit", "deit_dual", "deit_single", "vit_bf16_tensors"])
def test_hf_state_dicts_convert_like_jax(configs, layout):
    tiny, _, deit = configs
    cfg = tiny if layout.startswith("vit") else deit
    sd = _hf_state_dict(cfg, layout.removesuffix("_bf16_tensors"))
    if layout == "vit_bf16_tensors":  # torch bf16, as HF checkpoints ship in
        sd = {k: torch.from_numpy(v).bfloat16() for k, v in sd.items()}
    got = thf.params_from_hf_state_dict(sd, cfg)
    _same_leaves(got, jhf.params_from_hf_state_dict(sd, cfg))
    assert ("head_dist" in got) == (layout == "deit_dual") and ("dist_token" in got) == \
        layout.startswith("deit")
    if layout == "vit":  # the dtype= cast: a torch dtype gives torch leaves
        cast = thf.params_from_hf_state_dict(sd, cfg, dtype=torch.bfloat16)
        _same_leaves(cast, jhf.params_from_hf_state_dict(sd, cfg, dtype=jnp.bfloat16))
        assert flatten_tree(cast)["blocks/wqkv"].dtype == torch.bfloat16


def test_hf_refusals_are_the_jax_packages(configs):
    tiny, _, deit = configs
    sd = _hf_state_dict(tiny, "vit")
    cases = [({k: v for k, v in sd.items() if k != "vit.layernorm.bias"}, tiny, KeyError),
             (sd, deit, ValueError),  # no distillation token for a distilled config
             (_hf_state_dict(deit, "deit_dual"), tiny, ValueError),
             (sd, dataclasses.replace(tiny, num_classes=7), ValueError)]
    for state, cfg, err in cases:
        msgs = []
        for fn in (thf.params_from_hf_state_dict, jhf.params_from_hf_state_dict):
            with pytest.raises(err) as e:
                fn(state, cfg)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]


def test_config_from_hf_is_the_jax_packages():
    for model_type, labels in (("vit", 10), ("deit", 0)):
        hf = types.SimpleNamespace(model_type=model_type, image_size=48, patch_size=16,
                                   num_channels=3, num_labels=labels, hidden_size=64,
                                   num_hidden_layers=2, num_attention_heads=4,
                                   intermediate_size=256, layer_norm_eps=1e-12)
        assert dataclasses.asdict(thf.config_from_hf(hf)) == \
            dataclasses.asdict(jhf.config_from_hf(hf))


# -- position-table interpolation ----------------------------------------------------


def _table(grid: int, prefix: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).normal(0, 0.02, (prefix + grid * grid, 16)).astype(
        np.float32)


@pytest.mark.parametrize("grids", [(2, 3), (14, 24), (24, 14)], ids=["2to3", "14to24", "24to14"])
@pytest.mark.parametrize("prefix", [1, 2])
def test_bicubic_matches_jax(grids, prefix):
    a, b = grids
    pe = _table(a, prefix)
    want = np.asarray(jinterp.interpolate_pos_embed(jnp.asarray(pe), a, b, "bicubic", prefix))
    got = tinterp.interpolate_pos_embed(pe, a, b, "bicubic", prefix)
    assert got.shape == want.shape == (prefix + b * b, 16) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:prefix], pe[:prefix])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    # a CPU tensor in, a tensor of its dtype out
    t = tinterp.interpolate_pos_embed(torch.from_numpy(pe), a, b, "bicubic", prefix)
    assert isinstance(t, torch.Tensor) and t.dtype == torch.float32
    np.testing.assert_array_equal(t.numpy(), got)


@pytest.mark.parametrize("method", ["nearest", "linear", "cubic", "lanczos3", "lanczos5"])
def test_resize_methods_match_jax_image_resize(method):
    for a, b in ((14, 24), (24, 14)):  # up, and down (antialiased)
        pe = _table(a, 1, seed=a)
        want = np.asarray(jinterp.interpolate_pos_embed(jnp.asarray(pe), a, b, method))
        got = tinterp.interpolate_pos_embed(pe, a, b, method)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"{method} {a}->{b}")


def test_interpolation_edges_and_refusals(configs):
    tiny, big, deit = configs
    pe = _table(2, 1)
    assert tinterp.interpolate_pos_embed(pe, 2, 2) is pe  # identity at the same grid
    for fn in (tinterp.interpolate_pos_embed, jinterp.interpolate_pos_embed):
        with pytest.raises(ValueError, match="has 6 rows, expected 10"):
            fn(_table(2, 2), 3, 4)
        with pytest.raises(ValueError, match="Unknown resize method"):
            fn(pe, 2, 3, "spline")
    params = twio.params_from_tensors(twio.synth_reference_tensors(tiny, 1), tiny)
    for fn in (tinterp.adapt_params_resolution, jinterp.adapt_params_resolution):
        with pytest.raises(ValueError, match="resolution transfer requires matching architecture"):
            fn(params, tiny, dataclasses.replace(deit, image_size=48))


def test_resolution_transfer_forward_matches_jax(configs):
    tiny, big, _ = configs
    params = twio.params_from_tensors(twio.synth_reference_tensors(tiny, 2), tiny)
    got = tinterp.adapt_params_resolution(params, tiny, big)
    want = jinterp.adapt_params_resolution(params, tiny, big)
    assert got["pos_embed"].shape == (big.seq_len, 64)
    _same_leaves(got, {k: np.asarray(v) if not isinstance(v, dict) else v
                       for k, v in want.items()})
    x = timages.synth_images(2, big, seed=3)
    with torch.no_grad():
        logits = tvit.forward(params_from_numpy(got, "cpu"), torch.from_numpy(x), big).numpy()
    jlogits = np.asarray(jvit.forward({k: v for k, v in want.items()}, jnp.asarray(x), big))
    np.testing.assert_allclose(logits, jlogits, rtol=0, atol=1e-5)


# -- the convert CLI against vit-tpu-convert -----------------------------------------


def _run(main, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(argv)
    return rc, out.getvalue(), err.getvalue()


def _both(tmp_path, monkeypatch, argv, same_err: bool = True):
    """The port's and the JAX CLI on the same relative paths, each in its
    own directory (a copy of ``tmp_path/src``): the same exit code and
    stdout, and (``same_err``) stderr."""
    runs = []
    for name, main in (("port", tconvert.main), ("jax", jconvert.main)):
        shutil.rmtree(tmp_path / name, ignore_errors=True)
        shutil.copytree(tmp_path / "src", tmp_path / name)
        monkeypatch.chdir(tmp_path / name)
        runs.append(_run(main, argv))
    (rc, out, err), (jrc, jout, jerr) = runs
    assert (rc, out) == (jrc, jout)
    if same_err:
        assert err == jerr
    return rc, out, err


@pytest.fixture
def src(configs, tmp_path):
    tiny, _, deit = configs
    d = tmp_path / "src"
    jwio.save_reference_weights(jwio.synth_reference_tensors(tiny, seed=3), d / "Network", tiny)
    from vit_tpu_torch.io import checkpoint
    from vit_tpu_torch.io.params import params_to_numpy

    checkpoint.save_npz(params_to_numpy(tvit.init_params(torch.Generator().manual_seed(0),
                                                         tconfig.CONFIGS[deit.name])),
                        d / "deit.npz")
    return d


def test_convert_cli_routes_match_jax(src, tmp_path, monkeypatch):
    # Weight_*.bin -> .npz -> Weight_*.bin, byte for byte
    tiny = ["--config", "vit_tiny_test"]
    assert _both(tmp_path, monkeypatch, [*tiny, "--from", "Network", "--to", "p.npz",
                                         "--no-round6"])[0] == 0
    for name in ("port", "jax"):
        (tmp_path / name / "p.npz").rename(tmp_path / "src" / f"{name}.npz")
    assert _both(tmp_path, monkeypatch, [*tiny, "--from", "port.npz", "--to", "Back"])[0] == 0
    for f in (tmp_path / "src" / "Network").iterdir():
        assert (tmp_path / "port" / "Back" / f.name).read_bytes() == f.read_bytes(), f.name
    # .pth out and back, and an uppercase suffix
    _both(tmp_path, monkeypatch, [*tiny, "--from", "Network", "--to", "M.PTH", "--no-round6"])
    assert _run(tconvert.main, [*tiny, "--from", "M.PTH", "--to", "again.npz"])[0] == 0
    _same_leaves(np.load("again.npz"), np.load(tmp_path / "src" / "port.npz"))


@pytest.mark.parametrize("route", ["bad_source", "distilled_to_reference", "hf_without_transformers"])
def test_convert_cli_refusals_match_jax(src, tmp_path, monkeypatch, route):
    (tmp_path / "src" / "x.txt").write_text("nope")
    argv = {"bad_source": ["--config", "vit_tiny_test", "--from", "x.txt", "--to", "o.npz"],
            "distilled_to_reference": ["--config", "deit_tiny_test", "--from", "deit.npz",
                                       "--to", "Out"],
            "hf_without_transformers": ["--config", "vit_tiny_test", "--hf", "--from", "Network",
                                        "--to", "o.npz"]}[route]
    if route == "hf_without_transformers":
        monkeypatch.setitem(sys.modules, "transformers", None)  # its import fails
    # the port's loader names the sources it reads: no Orbax directory
    rc, out, err = _both(tmp_path, monkeypatch, argv, same_err=route != "bad_source")
    assert rc == 2 and err.startswith("error:")
    if route == "hf_without_transformers":
        assert err == "error: --hf needs the transformers package\n"


def test_convert_cli_orbax_names_the_jax_cli(src, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path / "src")
    rc, out, err = _run(tconvert.main, ["--config", "vit_tiny_test", "--from", "Network",
                                        "--to", "ckpt", "--format", "orbax"])
    assert rc == 2 and out == "" and "vit-tpu-convert" in err
    assert not (tmp_path / "src" / "ckpt").exists()


def _fake_transformers(ckpts: dict):
    """A stand-in for the ``transformers`` package: ``from_pretrained`` of
    each class the convert CLIs import returns ``(model, loading info)``
    for the checkpoints in ``ckpts`` ({dir: (config, state dict)}), with
    the classifier keys missing where the class's head is not in the state
    dict, as the real loader reports them."""
    heads = {"ViTForImageClassification": "classifier",
             "DeiTForImageClassification": "classifier",
             "DeiTForImageClassificationWithTeacher": "cls_classifier"}

    def model_class(name):
        def from_pretrained(src, output_loading_info=False):
            cfg, sd = ckpts[str(src)]
            model = types.SimpleNamespace(config=cfg, state_dict=lambda: sd)
            missing = [] if f"{heads[name]}.weight" in sd else [f"{heads[name]}.weight"]
            return (model, {"missing_keys": missing}) if output_loading_info else model

        return type(name, (), {"from_pretrained": staticmethod(from_pretrained)})

    mod = types.ModuleType("transformers")
    for name in heads:
        setattr(mod, name, model_class(name))
    mod.AutoConfig = types.SimpleNamespace(from_pretrained=lambda src: ckpts[str(src)][0])
    return mod


@pytest.mark.parametrize("ckpt", ["vit", "vit_headless", "vit_7_classes", "vit_wrong_size",
                                  "deit_dual", "deit_single_tagged", "deit_single_untagged"])
def test_convert_cli_hf_branch_matches_jax(configs, tmp_path, monkeypatch, ckpt):
    """--hf through a stand-in transformers package (the real one loads the
    same state dicts from disk): DeiT's head layout from the recorded
    architecture, the headless refusal, the checkpoint's num_classes
    adopted, the structural fields checked — stdout, stderr, exit code and
    npz the JAX CLI's."""
    tiny, _, deit = configs
    layout = "vit" if ckpt.startswith("vit") else ckpt.removesuffix("_tagged").removesuffix(
        "_untagged")
    head = dataclasses.replace(tiny, num_classes=7) if ckpt == "vit_7_classes" else tiny
    sd = _hf_state_dict(head, layout)
    if ckpt == "vit_headless":
        sd = {k: v for k, v in sd.items() if not k.startswith("classifier")}
    archs = {"deit_single_tagged": ["DeiTForImageClassification"],
             "deit_dual": ["DeiTForImageClassificationWithTeacher"]}.get(ckpt)
    hf_cfg = types.SimpleNamespace(
        model_type="vit" if layout == "vit" else "deit", architectures=archs,
        image_size=48 if ckpt == "vit_wrong_size" else 32, patch_size=16, num_channels=3,
        num_labels=head.num_classes, hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
        intermediate_size=256, layer_norm_eps=1e-6)
    monkeypatch.setitem(sys.modules, "transformers", _fake_transformers({"hf": (hf_cfg, sd)}))
    (tmp_path / "src").mkdir()
    config = "vit_tiny_test" if layout == "vit" else "deit_tiny_test"
    rc, out, _ = _both(tmp_path, monkeypatch, ["--config", config, "--hf", "--from", "hf",
                                               "--to", "o.npz"])
    assert rc == (2 if ckpt in ("vit_headless", "vit_wrong_size") else 0)
    if rc == 0:
        _same_leaves(np.load(tmp_path / "port" / "o.npz"), np.load(tmp_path / "jax" / "o.npz"))
        assert ("adopting the checkpoint's num_classes=7" in out) == (ckpt == "vit_7_classes")


# -- the classify CLI: --interpolate-pos-from and --ops auto --------------------------


def test_interpolate_pos_from_lines_match_jax(configs, tmp_path, monkeypatch):
    tiny, big, _ = configs
    head7 = dataclasses.replace(tiny, num_classes=7)
    jwio.save_reference_weights(jwio.synth_reference_tensors(head7, seed=4), tmp_path / "N",
                                head7)
    argv = ["--config", big.name, "--num-classes", "7", "--interpolate-pos-from", tiny.name,
            "--weights", str(tmp_path / "N"), "--synth", "3", "--dtype", "float32",
            "--no-compile-cache"]
    jrc, jout, _ = _run(jmain.main, [*argv, "--ops", "xla"])
    argv.remove("--no-compile-cache")
    rc, out, _ = _run(tmain.main, [*argv, "--ops", "eager", "--device", "cpu"])
    assert rc == jrc == 0
    lines = [line for line in out.splitlines() if line.startswith("[")]
    assert len(lines) == 3 and lines == [line for line in jout.splitlines()
                                         if line.startswith("[")]
    assert f"model: {big.name}" in out


def test_ops_auto_is_eager_off_the_card_whatever_tp(tiny_cfg, monkeypatch):
    from vit_tpu_torch.cli import common

    seen = []
    monkeypatch.setattr(common, "resolve_mesh", lambda *a: (None, torch.device("cpu")))
    monkeypatch.setattr(tmain, "_classify", lambda args, cfg, ops, *a: seen.append(ops) or 0)
    for tp in ("1", "2"):
        assert tmain.main(["--weights", "w", "--synth", "1", "--device", "cpu", "--tp", tp]) == 0
    assert tmain.main(["--weights", "w", "--synth", "1", "--device", "cuda", "--tp", "2"]) == 0
    assert seen == ["eager", "eager", "fused"]
