"""The port's eager reference ops, params conversion and eager forward
against the JAX package.

Inputs are made with numpy from fixed seeds and fed to both packages in
this one CPU process.  fp32 throughout; tolerance 1e-5 absolute (both
sides accumulate in fp32 — JAX at HIGHEST precision — so only summation
order differs).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.config import DEIT_T_16
from vit_tpu.io import weights as wio
from vit_tpu.ops import reference as R
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.ops import reference as TR

ATOL = 1e-5


def _np(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _close(got, want, atol=ATOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol, rtol=0)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("shape", [(7, 64), (2, 5, 64), (3, 197, 128)])
def test_layer_norm(shape):
    x = _np(0, *shape, scale=3.0) + 1.0
    s, b = _np(1, shape[-1]), _np(2, shape[-1])
    _close(TR.layer_norm(_t(x), _t(s), _t(b), 1e-6), R.layer_norm(x, s, b, 1e-6))


@pytest.mark.parametrize("name", ["gelu_exact", "gelu_tanh"])
def test_gelu(name):
    x = np.linspace(-8, 8, 4001, dtype=np.float32)
    _close(getattr(TR, name)(_t(x)), getattr(R, name)(x))


@pytest.mark.parametrize("with_bias", [True, False])
def test_linear(with_bias):
    x, w, b = _np(0, 3, 9, 48), _np(1, 48, 80, scale=0.2), _np(2, 80)
    bt, bj = (_t(b), b) if with_bias else (None, None)
    _close(TR.linear(_t(x), _t(w), bt), R.linear(x, w, bj))


def test_split_packed_qkv_and_merge_heads():
    qkv = _np(0, 2, 5, 3 * 64)
    got = TR.split_packed_qkv(_t(qkv), 4)
    want = R.split_packed_qkv(qkv, 4)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 4, 5, 16)
        _close(g, w, atol=0)
    _close(TR.merge_heads(got[0]), R.merge_heads(want[0]), atol=0)


@pytest.mark.parametrize("t", [5, 19])
def test_attention(t):
    d, h = 32, 4
    x = _np(0, 2, t, d)
    wqkv, bqkv = _np(1, d, 3 * d, scale=0.3), _np(2, 3 * d, scale=0.1)
    wo, bo = _np(3, d, d, scale=0.3), _np(4, d, scale=0.1)
    got = TR.attention(*map(_t, (x, wqkv, bqkv, wo, bo)), h)
    _close(got, R.attention(x, wqkv, bqkv, wo, bo, h))


@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_mlp(variant):
    x, w1, b1 = _np(0, 67, 64), _np(1, 64, 256, scale=0.2), _np(2, 256, scale=0.1)
    w2, b2 = _np(3, 256, 64, scale=0.2), _np(4, 64, scale=0.1)
    got = TR.mlp(*map(_t, (x, w1, b1, w2, b2)), gelu_variant=variant)
    _close(got, R.mlp(x, w1, b1, w2, b2, gelu_variant=variant))


def test_patch_embed():
    # channel-major flatten within each 16x16 patch
    imgs, k, b = _np(0, 2, 3, 32, 48), _np(1, 3 * 16 * 16, 24, scale=0.05), _np(2, 24)
    got = TR.patch_embed(_t(imgs), _t(k), _t(b), 16)
    assert tuple(got.shape) == (2, 6, 24)
    _close(got, R.patch_embed(imgs, k, b, 16))


@pytest.mark.parametrize("prefix", [1, 2])
def test_add_cls_and_pos(prefix):
    patches, pos = _np(0, 2, 4, 16), _np(1, 4 + prefix, 16)
    cls = _np(2, 16) if prefix == 1 else _np(2, prefix, 16)
    got = TR.add_cls_and_pos(_t(patches), _t(cls), _t(pos))
    _close(got, R.add_cls_and_pos(patches, cls, pos), atol=0)


def test_softmax():
    logits = _np(0, 4, 11, scale=5.0)
    _close(TR.softmax(_t(logits)), R.softmax(logits), atol=1e-7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_round_trip_bit_exact(tiny_cfg, dtype):
    tree = wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=3), tiny_cfg)
    if dtype == torch.bfloat16:  # values a bf16 tensor can hold exactly
        tree = params_to_numpy(params_from_numpy(tree, "cpu", dtype))
    back = params_to_numpy(params_from_numpy(tree, "cpu", dtype))
    flat_a, flat_b = jax.tree.leaves(tree), jax.tree.leaves(back)
    assert jax.tree.structure(tree) == jax.tree.structure(back)
    for a, b in zip(flat_a, flat_b):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint32), b.astype(np.float32).view(np.uint32))


def test_params_keep_jax_layout(tiny_cfg):
    # [in, out] matrices, stacked L axis, packed (head, {q,k,v}, dh) QKV:
    # never nn.Linear's [out, in]
    tree = wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=3), tiny_cfg)
    p = params_from_numpy(tree, "cpu")
    L, d, f = tiny_cfg.depth, tiny_cfg.embed_dim, tiny_cfg.mlp_dim
    assert tuple(p["blocks"]["wqkv"].shape) == (L, d, 3 * d)
    assert tuple(p["blocks"]["w1"].shape) == (L, d, f)
    np.testing.assert_array_equal(p["blocks"]["wo"].numpy(), tree["blocks"]["wo"])
    np.testing.assert_array_equal(p["head"]["kernel"].numpy(), tree["head"]["kernel"])


def test_get_ops():
    from vit_tpu_torch.ops.dispatch import EAGER_OPS, get_ops

    assert get_ops("eager") is EAGER_OPS
    assert get_ops("fused").name == "fused"
    assert get_ops("quant").name == "quant"
    with pytest.raises(ValueError, match="unknown ops impl 'int4'"):
        get_ops("int4")
    assert get_ops("qat").name == "qat"


def _eager_vs_jax(cfg, seed):
    from vit_tpu.io.images import synth_images
    from vit_tpu.models import vit as jvit
    from vit_tpu_torch.models import vit as tvit

    tree = wio.params_from_tensors(wio.synth_reference_tensors(cfg, seed=seed), cfg)
    if cfg.distilled:
        rng = np.random.default_rng(seed)
        d, c = cfg.embed_dim, cfg.num_classes
        tree["dist_token"] = rng.normal(0, 0.02, (d,)).astype(np.float32)
        tree["head_dist"] = {
            "kernel": rng.normal(0, d ** -0.5, (d, c)).astype(np.float32),
            "bias": np.zeros((c,), np.float32),
        }
    imgs = synth_images(3, cfg, seed=seed)
    want = jvit.forward(jax.tree.map(jnp.asarray, tree), jnp.asarray(imgs), cfg)
    got = tvit.forward(params_from_numpy(tree, "cpu"), torch.from_numpy(imgs), cfg)
    return got, want, tree, imgs


def test_eager_forward_matches_jax(tiny_cfg):
    got, want, _, _ = _eager_vs_jax(tiny_cfg, 5)
    assert tuple(got.shape) == (3, tiny_cfg.num_classes) and got.dtype == torch.float32
    _close(got, want)


def test_eager_forward_deit_matches_jax(tiny_cfg):
    cfg = dataclasses.replace(
        DEIT_T_16, depth=2, embed_dim=64, num_heads=4, image_size=32,
        num_classes=11, name="deit_tiny_test",
    )
    got, want, _, _ = _eager_vs_jax(cfg, 6)
    _close(got, want)


def test_features_and_vit_module(tiny_cfg):
    from vit_tpu.models import vit as jvit
    from vit_tpu_torch.models import vit as tvit

    _, _, tree, imgs = _eager_vs_jax(tiny_cfg, 7)
    model = tvit.ViT(tiny_cfg, params_from_numpy(tree, "cpu"))
    assert "blocks.wqkv" in model.params.state_dict()
    jtree = jax.tree.map(jnp.asarray, tree)
    _close(model(torch.from_numpy(imgs)), jvit.forward(jtree, jnp.asarray(imgs), tiny_cfg))
    _close(
        model(torch.from_numpy(imgs), return_features=True),
        jvit.forward(jtree, jnp.asarray(imgs), tiny_cfg, return_features=True),
    )


def test_eager_forward_float64_tracks_fp32(tiny_cfg):
    # fp64 params accumulate in fp64 (the CPU oracle mode of the port)
    from vit_tpu_torch.models import vit as tvit

    got32, _, tree, imgs = _eager_vs_jax(tiny_cfg, 8)
    got64 = tvit.forward(
        params_from_numpy(tree, "cpu", torch.float64), torch.from_numpy(imgs), tiny_cfg
    )
    _close(got64, got32.numpy())
