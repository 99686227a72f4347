"""MAE pretraining in the port (``models/mae.py``, ``make_mae_train_step``,
``vit-tpu-torch-train --mae``) against the JAX package's
``vit_tpu.models.mae`` on the CPU.

``jax.random`` draws cannot be matched, so the tests carry JAX's across: the
params from ``init_mae_params`` (through ``params_from_numpy``) and the mask
noise, ``jax.random.uniform(key, (B, N))``, exactly what JAX's
``random_mask`` draws, fed to the port's noise -> indices step.

Tolerances: ``patchify``, ``unpatchify`` and the keep/restore/mask triple
exact; encoder and decoder fp32 1e-5; the loss on the eager ops 1e-5
relative to JAX's ``xla``, gradients 1e-4 x max(1, max|g|) per leaf
(``tests/test_torch_train.py``'s fp32 bar); on ``fused_train`` (the port's
kernels through their plain twins, JAX's Pallas kernels in interpret mode)
loss 1e-4 and gradients 5e-4 x max(1, max|g|), the JAX package's own bar
between its tiers (``tests/test_mae.py``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.io import checkpoint as jckpt
from vit_tpu.io.load_any import load_params_any as jload_any
from vit_tpu.models import mae as jmae
from vit_tpu.models import vit as jvit
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu_torch.io import checkpoint as tckpt
from vit_tpu_torch.io.load_any import load_params_any as tload_any
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.models import mae as tmae
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.runtime import trainer as ttrainer

from torch_spy_record import one_thread

JMCFG = jmae.MAEConfig(mask_ratio=0.5, decoder_dim=32, decoder_depth=2, decoder_heads=2)
TMCFG = tmae.MAEConfig(mask_ratio=0.5, decoder_dim=32, decoder_depth=2, decoder_heads=2)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


@pytest.fixture(scope="module")
def jparams(tiny_cfg):
    return _np_tree(jmae.init_mae_params(jax.random.PRNGKey(3), tiny_cfg, JMCFG))


@pytest.fixture(scope="module")
def images(tiny_cfg):
    return np.random.default_rng(4).normal(
        size=(4, 3, tiny_cfg.image_size, tiny_cfg.image_size)).astype(np.float32)


def _noise(seed, b, n):
    return np.array(jax.random.uniform(jax.random.PRNGKey(seed), (b, n)))


def _leaf_grads(tree):
    return {k: _leaf_grads(v) if isinstance(v, dict) else v.grad.numpy() for k, v in tree.items()}


def _assert_grads(got, want, rtol):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            _assert_grads(got[k], want[k], rtol)
            continue
        w = np.asarray(want[k], np.float32)
        err = np.abs(got[k] - w).max()
        assert err <= rtol * max(1.0, np.abs(w).max()), (k, err)


def _shapes(tree):
    return {k: _shapes(v) if isinstance(v, dict) else (tuple(v.shape), str(v.dtype))
            for k, v in tree.items()}


# -- layout and masking ----------------------------------------------------


def test_patchify_and_unpatchify_are_jax_exactly(tiny_cfg, images):
    got = tmae.patchify(torch.from_numpy(images), tiny_cfg.patch_size)
    want = np.asarray(jmae.patchify(jnp.asarray(images), tiny_cfg.patch_size))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tmae.unpatchify(got, tiny_cfg).numpy(), images)
    # the rows the patch-embed GEMM reads
    w = torch.from_numpy(np.random.default_rng(1).normal(
        size=(tiny_cfg.patch_dim, 8)).astype(np.float32))
    from vit_tpu_torch.ops import reference

    np.testing.assert_allclose((got @ w).numpy(), reference.patch_embed(
        torch.from_numpy(images), w, torch.zeros(8), tiny_cfg.patch_size).numpy(), atol=1e-5)


@pytest.mark.parametrize("seed,b,n,keep", [(0, 8, 4, 2), (1, 3, 196, 49), (2, 5, 16, 1)])
def test_masks_from_jax_noise_equal_jax(seed, b, n, keep):
    jk, jr, jm = jmae.random_mask(jax.random.PRNGKey(seed), b, n, keep)
    tk, tr, tm = tmae.masks_from_noise(torch.from_numpy(_noise(seed, b, n)), keep)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


def test_random_mask_properties():
    keep, restore, mask = tmae.random_mask(torch.Generator().manual_seed(0), 8, 16, 3)
    assert keep.shape == (8, 3) and restore.shape == (8, 16) and mask.dtype == torch.float32
    for b in range(8):
        kept = set(keep[b].tolist())
        assert len(kept) == 3 and kept == {i for i in range(16) if mask[b, i] == 0}
    shuffle = torch.argsort(restore, dim=-1)
    assert torch.equal(torch.gather(restore, 1, shuffle), torch.arange(16).expand(8, 16))
    again = tmae.random_mask(torch.Generator().manual_seed(0), 8, 16, 3)[0]
    other = tmae.random_mask(torch.Generator().manual_seed(1), 8, 16, 3)[0]
    assert torch.equal(keep, again) and not torch.equal(keep, other)


# -- encoder, decoder and loss against the JAX package -----------------------


def test_encode_and_decode_on_jax_indices(tiny_cfg, jparams, images):
    keep, restore, _ = jmae.random_mask(jax.random.PRNGKey(5), 4, tiny_cfg.num_patches,
                                        JMCFG.len_keep(tiny_cfg))
    jp = jax.tree.map(jnp.asarray, jparams)
    jlat = jmae.encode(jp, jnp.asarray(images), keep, tiny_cfg)
    tp = params_from_numpy(jparams, "cpu")
    tlat = tmae.encode(tp, torch.from_numpy(images), torch.from_numpy(np.array(keep)).long(),
                       tiny_cfg)
    np.testing.assert_allclose(tlat.numpy(), np.asarray(jlat), atol=1e-5, rtol=0)
    jpred = jmae.decode(jp, jlat, restore, tiny_cfg, JMCFG)
    tpred = tmae.decode(tp, torch.from_numpy(np.array(jlat)),
                        torch.from_numpy(np.array(restore)).long(), tiny_cfg, TMCFG)
    assert tpred.dtype == torch.float32
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=1e-5, rtol=0)


def test_encode_without_masking_is_the_classifier_trunk(tiny_cfg, jparams, images):
    keep = torch.arange(tiny_cfg.num_patches).expand(4, -1)
    tp = params_from_numpy(jparams, "cpu")
    tokens = tmae.encode(tp, torch.from_numpy(images), keep, tiny_cfg)
    bb = tmae.extract_backbone(tp, torch.Generator().manual_seed(0), tiny_cfg)
    feats = tvit.forward(bb, torch.from_numpy(images), tiny_cfg, return_features=True)
    np.testing.assert_allclose(tokens[:, 0].numpy(), feats.numpy(), atol=1e-5, rtol=0)


def _loss_and_grads(jparams, images, noise_seed, cfg, jmcfg, tmcfg, jops, tops):
    jp = jax.tree.map(jnp.asarray, jparams)
    rng = jax.random.PRNGKey(noise_seed)
    jl, jg = jax.value_and_grad(
        lambda p: jmae.forward_loss(p, jnp.asarray(images), rng, cfg, jmcfg, jops))(jp)
    tp = ttrainer.as_trainable(params_from_numpy(jparams, "cpu"), "cpu")
    noise = torch.from_numpy(_noise(noise_seed, images.shape[0], cfg.num_patches))
    tl = tmae.forward_loss(tp, torch.from_numpy(images), None, cfg, tmcfg, tops, noise=noise)
    tl.backward()
    return tl.item(), _leaf_grads(tp), float(jl), _np_tree(jg)


@pytest.mark.parametrize("norm_pix", [True, False], ids=["norm_pix", "raw_pix"])
def test_forward_loss_eager_matches_jax_xla(tiny_cfg, jparams, images, norm_pix):
    jm = dataclasses.replace(JMCFG, norm_pix_loss=norm_pix)
    tm = dataclasses.replace(TMCFG, norm_pix_loss=norm_pix)
    tl, tg, jl, jg = _loss_and_grads(jparams, images, 7, tiny_cfg, jm, tm, jget_ops("xla"),
                                     get_ops("eager"))
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    _assert_grads(tg, jg, 1e-4)


@pytest.mark.parametrize("norm_pix", [True, False], ids=["norm_pix", "raw_pix"])
def test_forward_loss_fused_train_matches_jax_fused_train(tiny_cfg, jparams, images, norm_pix):
    jm = dataclasses.replace(JMCFG, norm_pix_loss=norm_pix)
    tm = dataclasses.replace(TMCFG, norm_pix_loss=norm_pix)
    tl, tg, jl, jg = _loss_and_grads(jparams, images, 11, tiny_cfg, jm, tm,
                                     jget_ops("fused_train"), get_ops("fused_train"))
    assert abs(tl - jl) <= 1e-4
    _assert_grads(tg, jg, 5e-4)


def test_return_pred_matches_jax(tiny_cfg, jparams, images):
    jl, (jpred, jmask) = jmae.forward_loss(jax.tree.map(jnp.asarray, jparams),
                                          jnp.asarray(images), jax.random.PRNGKey(2), tiny_cfg,
                                          JMCFG, return_pred=True)
    tl, (tpred, tmask) = tmae.forward_loss(
        params_from_numpy(jparams, "cpu"), torch.from_numpy(images), None, tiny_cfg, TMCFG,
        return_pred=True, noise=torch.from_numpy(_noise(2, 4, tiny_cfg.num_patches)))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tpred.numpy(), np.asarray(jpred), atol=1e-5, rtol=0)
    # only the masked patches are scored
    target = tmae.patchify(torch.from_numpy(images), tiny_cfg.patch_size)
    target = (target - target.mean(-1, keepdim=True)) / torch.sqrt(
        target.var(-1, keepdim=True, unbiased=False) + 1e-6)
    per_patch = (tpred - target).square().mean(-1)
    assert abs(tl.item() - ((per_patch * tmask).sum() / tmask.sum()).item()) <= 1e-6


# -- params: init, backbone, npz both ways ----------------------------------


def test_init_mae_params_tree_and_shapes_equal_jax(tiny_cfg):
    got = tmae.init_mae_params(torch.Generator().manual_seed(0), tiny_cfg, TMCFG)
    want = jmae.init_mae_params(jax.random.PRNGKey(0), tiny_cfg, JMCFG)
    assert _shapes(params_to_numpy(got)) == _shapes(_np_tree(want))
    assert list(got["decoder"]) == list(want["decoder"])
    assert tmae.is_mae_params(got) and not tmae.is_mae_params(tvit.init_params(
        torch.Generator().manual_seed(0), tiny_cfg))
    for leaf in ("mask_token", "pos_embed"):  # N(0, 0.02) draws
        assert 0.005 < got["decoder"][leaf].std().item() < 0.05


def test_extract_backbone(tiny_cfg):
    mp = tmae.init_mae_params(torch.Generator().manual_seed(0), tiny_cfg, TMCFG)
    bb = tmae.extract_backbone(mp, torch.Generator().manual_seed(2), tiny_cfg)
    ref = tvit.init_params(torch.Generator().manual_seed(0), tiny_cfg)
    assert _shapes(params_to_numpy(bb)) == _shapes(params_to_numpy(ref))
    assert bb["blocks"]["wqkv"] is mp["blocks"]["wqkv"] and not tmae.is_mae_params(bb)
    jbb = jmae.extract_backbone(_np_tree(jmae.init_mae_params(jax.random.PRNGKey(0), tiny_cfg,
                                                              JMCFG)),
                                jax.random.PRNGKey(2), tiny_cfg)
    assert _shapes(params_to_numpy(bb)) == _shapes(_np_tree(jbb))


def test_mae_npz_loads_in_either_package(tiny_cfg, jparams, images, tmp_path):
    noise = torch.from_numpy(_noise(9, 4, tiny_cfg.num_patches))
    # JAX writes, the port reads
    jckpt.save_npz(jparams, tmp_path / "j.npz")
    got = tmae.forward_loss(params_from_numpy(tckpt.load_npz(tmp_path / "j.npz"), "cpu"),
                            torch.from_numpy(images), None, tiny_cfg, TMCFG, noise=noise)
    want = jmae.forward_loss(jax.tree.map(jnp.asarray, jparams), jnp.asarray(images),
                             jax.random.PRNGKey(9), tiny_cfg, JMCFG)
    assert abs(got.item() - float(want)) <= 1e-5 * float(want)
    # the port writes, JAX reads
    tp = tmae.init_mae_params(torch.Generator().manual_seed(5), tiny_cfg, TMCFG)
    tckpt.save_npz(params_to_numpy(tp), tmp_path / "t.npz")
    back = jckpt.load_npz(tmp_path / "t.npz")
    want = jmae.forward_loss(jax.tree.map(jnp.asarray, back), jnp.asarray(images),
                             jax.random.PRNGKey(9), tiny_cfg, JMCFG)
    got = tmae.forward_loss(tp, torch.from_numpy(images), None, tiny_cfg, TMCFG, noise=noise)
    assert abs(got.item() - float(want)) <= 1e-5 * float(want)


def test_load_any_refuses_an_mae_tree_with_the_recipe(tiny_cfg, jparams, tmp_path):
    path = tmp_path / "mae.npz"
    tckpt.save_npz(jparams, path)
    with pytest.raises(ValueError) as got:
        tload_any(path, tiny_cfg)
    with pytest.raises(ValueError) as want:
        jload_any(path, tiny_cfg)
    assert str(got.value) == str(want.value).replace("vit-tpu-train", "vit-tpu-torch-train")
    assert "vit-tpu-torch-train --mae --save-backbone PATH" in str(got.value)


# -- the step and the CLI ------------------------------------------------------


@pytest.mark.parametrize("ops", ["eager", "fused_train"])
def test_mae_step_mixed_precision(tiny_cfg, images, ops):
    params = ttrainer.as_trainable(
        tmae.init_mae_params(torch.Generator().manual_seed(0), tiny_cfg, TMCFG), "cpu")
    before = params["decoder"]["pred"]["kernel"].detach().clone()
    opt = torch.optim.AdamW(list(ttrainer.leaves(params)), lr=1e-3)
    gen = torch.Generator().manual_seed(1)
    step = ttrainer.make_mae_train_step(tiny_cfg, TMCFG, opt, gen, get_ops(ops),
                                        compute_dtype=torch.bfloat16)
    x = torch.from_numpy(images)
    losses = [float(step(params, x, None)) for _ in range(3)]
    assert np.isfinite(losses).all() and len(set(losses)) == 3  # fresh masks each step
    assert params["blocks"]["wqkv"].dtype == torch.float32  # fp32 master weights
    assert not torch.equal(before, params["decoder"]["pred"]["kernel"].detach())


def test_mae_step_learns(tiny_cfg, images):
    params = ttrainer.as_trainable(
        tmae.init_mae_params(torch.Generator().manual_seed(0), tiny_cfg, TMCFG), "cpu")
    # tests/test_mae.py's convergence gate: four masks in turn, AdamW 3e-3
    opt = torch.optim.AdamW(list(ttrainer.leaves(params)), lr=3e-3)
    gen = torch.Generator()
    step = ttrainer.make_mae_train_step(tiny_cfg, TMCFG, opt, gen, get_ops("fused_train"))
    x = torch.from_numpy(images)
    losses = []
    with one_thread():  # tiny steps: the suite's workers would oversubscribe the cores
        for i in range(60):
            gen.manual_seed(i % 4)
            losses.append(float(step(params, x, None)))
    assert losses[-1] < 0.5 * losses[0], losses


@pytest.fixture
def registered(tiny_cfg, monkeypatch):
    import vit_tpu.config as jconfig
    import vit_tpu_torch.config as tconfig

    monkeypatch.setitem(jconfig.CONFIGS, "vit_tiny_test", tiny_cfg)
    monkeypatch.setitem(tconfig.CONFIGS, "vit_tiny_test", tiny_cfg)
    return tiny_cfg


def test_train_cli_pretrain_then_finetune(registered, tmp_path, capsys):
    from vit_tpu_torch.cli.train import main

    bb, raw = tmp_path / "backbone.npz", tmp_path / "mae.npz"
    assert main(["--config", "vit_tiny_test", "--mae", "--steps", "3", "--batch", "4",
                 "--device", "cpu", "--ops", "fused_train", "--mask-ratio", "0.5",
                 "--mae-decoder", "32,1,2", "--save-backbone", str(bb), "--save",
                 str(raw)]) == 0
    out = capsys.readouterr().out
    assert "mae: mask_ratio 0.5 (2/4 patches visible), decoder 32x1 (2 heads), norm_pix True" \
        in out and "step    2" in out
    assert "saved pretrained backbone (fresh 64 x 11 head) to " + str(bb) in out
    # the backbone fine-tunes through the transfer path, and JAX loads it too
    assert main(["--config", "vit_tiny_test", "--steps", "1", "--batch", "4", "--device", "cpu",
                 "--init-weights", str(bb), "--num-classes", "5"]) == 0
    assert "transfer learning: fresh 64 x 5 head" in capsys.readouterr().out
    assert jload_any(bb, registered)["head"]["kernel"].shape == (64, 11)
    # the raw MAE tree (decoder, no head) is refused with the recipe
    assert main(["--config", "vit_tiny_test", "--steps", "1", "--batch", "4", "--device", "cpu",
                 "--init-weights", str(raw)]) == 2
    assert "--mae --save-backbone PATH" in capsys.readouterr().err
    with pytest.raises(ValueError, match="save-backbone"):
        jload_any(raw, registered)


def _refusal(args, capsys):
    """(exit code, the error line) of the port's train CLI on ``args``."""
    from vit_tpu_torch.cli.train import main

    rc = main(["--config", "vit_tiny_test", "--steps", "1", "--batch", "4", "--device", "cpu",
               *args])
    return rc, capsys.readouterr().err.strip().splitlines()[-1]


def _jax_refusal(args, capsys):
    from vit_tpu.cli.train import main

    rc = main(["--config", "vit_tiny_test", "--steps", "1", "--batch", "4", "--dp", "1",
               "--no-compile-cache", *args])
    return rc, capsys.readouterr().err.strip().splitlines()[-1]


# refusals whose words the JAX package's CLI prints as they are
SHARED = {
    "decoder_bogus": ["--mae", "--mae-decoder", "bogus"],
    "mask_ratio_1.5": ["--mae", "--mask-ratio", "1.5"],
    "mask_ratio_0": ["--mae", "--mask-ratio", "0"],
    "decoder_heads_0": ["--mae", "--mae-decoder", "32,1,0"],
    "decoder_indivisible": ["--mae", "--mae-decoder", "33,1,2"],
    "save_backbone_alone": ["--save-backbone", "x.npz"],
    "mask_ratio_alone": ["--mask-ratio", "0.5"],
    "two_mae_flags_alone": ["--mae-decoder", "32,1,2", "--no-norm-pix"],
    "tome_with_mae": ["--mae", "--tome", "2"],
}


@pytest.mark.parametrize("case", list(SHARED))
def test_train_cli_mae_refusals_in_jax_words(registered, capsys, case):
    rc, line = _refusal(SHARED[case], capsys)
    jrc, jline = _jax_refusal(SHARED[case], capsys)
    assert rc == jrc == 2 and line == jline and line.startswith("error: ")


@pytest.mark.parametrize("extra", [
    ["--num-classes", "5"], ["--label-smoothing", "0.1"], ["--dropout", "0.1"],
    ["--drop-path", "0.1"], ["--grad-accum", "2"], ["--init-weights", "x.npz"],
    ["--optimizer", "fused_adamw", "--ops", "fused_train"], ["--distill-teacher", "x.npz"],
], ids=lambda e: e[0])
def test_train_cli_mae_excludes_label_flags(registered, capsys, extra):
    rc, line = _refusal(["--mae", *extra], capsys)
    assert rc == 2 and line.startswith("error: --mae is self-supervised pretraining")
    assert extra[0] in line and "--save-backbone + --init-weights" in line


def test_train_cli_mae_ops(registered, capsys):
    rc, line = _refusal(["--mae", "--ops", "qat"], capsys)
    assert rc == 2 and line == "error: --mae supports --ops eager or fused_train (got qat)"
    rc, _ = _refusal(["--mae", "--config", "deit_b_16"], capsys)
    assert rc == 2


def test_train_cli_mae_refuses_distilled(capsys):
    import vit_tpu_torch.config as tconfig

    cfg = dataclasses.replace(tconfig.DEIT_B_16, image_size=32, embed_dim=64, depth=1,
                              num_heads=4, name="deit_tiny_mae")
    tconfig.CONFIGS[cfg.name] = cfg
    try:
        rc, line = _refusal(["--config", cfg.name, "--mae"], capsys)
    finally:
        del tconfig.CONFIGS[cfg.name]
    assert rc == 2 and "distilled (DeiT) configs" in line


@pytest.mark.parametrize("make", [
    lambda m: m.MAEConfig(mask_ratio=1.0).len_keep,
    lambda m: m.MAEConfig(mask_ratio=0.0).len_keep,
    lambda m: m.MAEConfig(decoder_dim=33, decoder_heads=2).decoder_cfg,
    lambda m: m.MAEConfig(decoder_heads=0).decoder_cfg,
    lambda m: m.MAEConfig(decoder_dim=-512).decoder_cfg,
    lambda m: m.MAEConfig(decoder_depth=0).decoder_cfg,
], ids=["ratio_1", "ratio_0", "indivisible", "heads_0", "dim_neg", "depth_0"])
def test_mae_config_errors_in_jax_words(tiny_cfg, make):
    with pytest.raises(ValueError) as got:
        make(tmae)(tiny_cfg)
    with pytest.raises(ValueError) as want:
        make(jmae)(tiny_cfg)
    assert str(got.value) == str(want.value)
