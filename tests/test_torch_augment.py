"""The port's augmentation (``vit_tpu_torch/runtime/augment.py``) against the
JAX package's (``vit_tpu/runtime/augment.py``) on the CPU.

torch cannot draw what ``jax.random`` draws, so each case draws with the
JAX package's keys exactly as its transform does and feeds those draws to
the port's seam: flip, mixup, cutmix and the soft targets must then agree
bit for bit, the random-resized crop within 1e-5 of each image's largest
magnitude (its two weight contractions sum in another order).  The drawing
functions are held to their distributions and to their generator, and
``make_augment_fn`` to the JAX package's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.runtime import augment as jaug
from vit_tpu_torch.runtime import augment as taug

K = 11


def _images(seed, b=6, h=32, w=32):
    return np.random.default_rng(seed).normal(size=(b, 3, h, w)).astype(np.float32)


def _labels(seed, b=6):
    return np.random.default_rng(seed).integers(0, K, b).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.asarray(a).copy())


@pytest.mark.parametrize("smoothing", [0.0, 0.1])
def test_soft_targets_match_jax(smoothing):
    y = _labels(0)
    got = taug.soft_targets(_t(y), K, smoothing).numpy()
    want = np.asarray(jaug.soft_targets(jnp.asarray(y), K, smoothing))
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # soft rows pass through unsmoothed
    np.testing.assert_array_equal(taug.soft_targets(_t(want), K, 0.3).numpy(), want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_flip_matches_jax(seed):
    x = _images(seed)
    rng = jax.random.key(seed)
    flip = jax.random.bernoulli(rng, 0.5, (x.shape[0],))
    got = taug.random_flip(_t(x), _t(flip)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jaug.random_flip(rng, jnp.asarray(x))))


def _jax_crop_draws(rng, b, scale=(0.3, 1.0), ratio=(3 / 4, 4 / 3)):
    """The draws of ``vit_tpu.runtime.augment.random_resized_crop``."""
    k_area, k_ratio, k_pos = jax.random.split(rng, 3)
    area = jax.random.uniform(k_area, (b,), minval=scale[0], maxval=scale[1])
    log_r = jax.random.uniform(k_ratio, (b,), minval=jnp.log(ratio[0]),
                               maxval=jnp.log(ratio[1]))
    return area, log_r, jax.random.uniform(k_pos, (b, 2))


@pytest.mark.parametrize("seed,h,w", [(0, 32, 32), (1, 32, 32), (2, 24, 40), (3, 17, 9)])
def test_random_resized_crop_matches_jax(seed, h, w):
    x = _images(seed, b=8, h=h, w=w)
    rng = jax.random.key(10 + seed)
    draws = _jax_crop_draws(rng, 8)
    got = taug.random_resized_crop(_t(x), *map(_t, draws)).numpy()
    want = np.asarray(jaug.random_resized_crop(rng, jnp.asarray(x)))
    assert got.shape == want.shape and got.dtype == np.float32
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, r, atol=1e-5 * np.abs(r).max(), rtol=0)


def test_crop_weights_match_compute_weight_mat():
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    scale = np.array([1.0, 1.37, 3.2, 30.0], np.float32)
    trans = np.array([0.0, -5.3, -40.1, -600.0], np.float32)
    got = taug.linear_weights(21, _t(scale), _t(trans)).numpy()
    for i in range(4):
        want = compute_weight_mat(21, 21, jnp.float32(scale[i]), jnp.float32(trans[i]),
                                  _fill_triangle_kernel, True)
        np.testing.assert_allclose(got[i], np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("alpha", [0.2, 1.0])
def test_mixup_matches_jax(alpha):
    x, y = _images(4), _labels(5)
    rng = jax.random.key(int(alpha * 10))
    lam = jax.random.beta(rng, alpha, alpha)
    t = jaug.soft_targets(jnp.asarray(y), K, 0.1)
    want_x, want_y = jaug.mixup(rng, jnp.asarray(x), t, alpha)
    got_x, got_y = taug.mixup(_t(x), _t(t), _t(lam))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))


@pytest.mark.parametrize("seed", range(4))
def test_cutmix_matches_jax(seed):
    h, w = (32, 32) if seed % 2 == 0 else (24, 40)
    x, y = _images(seed, h=h, w=w), _labels(seed)
    rng = jax.random.key(100 + seed)
    k_lam, k_pos = jax.random.split(rng)
    lam = jax.random.beta(k_lam, 1.0, 1.0)
    cy = jax.random.uniform(k_pos, ()) * h
    cx = jax.random.uniform(jax.random.fold_in(k_pos, 1), ()) * w
    t = jaug.soft_targets(jnp.asarray(y), K)
    want_x, want_y = jaug.cutmix(rng, jnp.asarray(x), t, 1.0)
    got_x, got_y = taug.cutmix(_t(x), _t(t), _t(lam), _t(cy), _t(cx))
    np.testing.assert_array_equal(got_x.numpy(), np.asarray(want_x))
    np.testing.assert_array_equal(got_y.numpy(), np.asarray(want_y))
    assert 0.0 < float(got_y.sum(-1).min()) and np.allclose(got_y.sum(-1).numpy(), 1.0)


def test_draws_follow_their_generator_and_distributions():
    g = torch.Generator().manual_seed(3)
    lams = torch.stack([taug.beta_draw(g, 0.2) for _ in range(2000)])
    assert lams.dtype == torch.float32 and bool(((lams >= 0) & (lams <= 1)).all())
    # Beta(0.2, 0.2) is symmetric with its mass near 0 and 1
    assert abs(float(lams.mean()) - 0.5) < 0.03 and float(((lams < 0.1) | (lams > 0.9))
                                                          .float().mean()) > 0.5
    area, log_r, pos = taug.crop_draws(torch.Generator().manual_seed(1), 4000)
    assert 0.3 <= float(area.min()) and float(area.max()) < 1.0
    assert np.log(3 / 4) - 1e-6 <= float(log_r.min()) and float(log_r.max()) <= np.log(4 / 3)
    assert pos.shape == (4000, 2) and abs(float(pos.mean()) - 0.5) < 0.02
    assert abs(float(taug.flip_draws(torch.Generator().manual_seed(2), 4000).float().mean())
               - 0.5) < 0.03
    lam, cy, cx = taug.cutmix_draws(torch.Generator().manual_seed(5), 1.0, 24, 40)
    assert 0 <= float(cy) < 24 and 0 <= float(cx) < 40
    again = taug.cutmix_draws(torch.Generator().manual_seed(5), 1.0, 24, 40)
    assert [float(v) for v in again] == [float(lam), float(cy), float(cx)]


def test_make_augment_fn_composes_deterministically():
    fn = taug.make_augment_fn(["crop", "flip", "mixup", "cutmix"], K, label_smoothing=0.1)
    x, y = _t(_images(7, b=8)), _t(_labels(7, b=8))
    runs = [fn(torch.Generator().manual_seed(s), x, y) for s in (0, 0, 1)]
    for a, b in zip(runs[0], runs[1]):
        assert torch.equal(a, b)
    assert not torch.equal(runs[0][0], runs[2][0])
    for xs, ys in runs:
        assert xs.shape == x.shape and ys.shape == (8, K)
        np.testing.assert_allclose(ys.sum(-1).numpy(), 1.0, atol=1e-6)
    # the coin takes both branches over the seeds: mixup mixes every pixel,
    # cutmix leaves the pixels outside its box alone
    flip_only = taug.make_augment_fn(["mixup", "cutmix"], K)
    kinds = set()
    for s in range(12):
        out, _ = flip_only(torch.Generator().manual_seed(s), x, y)
        kinds.add("cutmix" if bool((out == x).any()) else "mixup")
    assert kinds == {"mixup", "cutmix"}


@pytest.mark.parametrize("names,kw", [
    (["flip", "rotate"], {}),
    (["mixup"], {"mixup_alpha": 0.0}),
    (["cutmix"], {"cutmix_alpha": -1.0}),
], ids=["unknown", "mixup_alpha", "cutmix_alpha"])
def test_make_augment_fn_refuses_what_jax_refuses(names, kw):
    with pytest.raises(ValueError) as want:
        jaug.make_augment_fn(names, K, **kw)
    with pytest.raises(ValueError) as got:
        taug.make_augment_fn(names, K, **kw)
    assert str(got.value) == str(want.value)
