"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Imports nothing of JAX or of the JAX package, so it runs on a machine with
an NVIDIA card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Every test carries the ``cuda`` marker and skips without a card (the
kernels have no CPU mode; ``test_torch_kernels.py`` holds the twins to the
JAX package on the CPU).

Tolerances, relative to the largest |value| of the twin's result (at least
1), for every output (each gradient against its own largest value): fp32
2^-16 — only fp32 summation order and FMA contraction differ; bf16 2^-6 —
both round at the same points, so they differ where accumulation order
flips a bf16 rounding (one ulp <= 2^-7 of the value).
"""

import dataclasses

import numpy as np
import pytest
import torch

from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.io.images import synth_images
from vit_tpu_torch.ops.kernels.layer_norm import layer_norm, layer_norm_plain
from vit_tpu_torch.ops.kernels.ln_mlp_out_residual_bwd import (
    ln_mlp_out_residual_bwd,
    ln_mlp_out_residual_bwd_plain,
)
from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual, ln_mlp_residual_plain
from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn, ln_qkv_attn_plain
from vit_tpu_torch.ops.kernels.ln_qkv_attn_bwd import ln_qkv_attn_bwd, ln_qkv_attn_bwd_plain
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import (
    out_ln_mlp_residual,
    out_ln_mlp_residual_plain,
)
from vit_tpu_torch.ops.kernels.out_residual import out_residual, out_residual_plain

REL_TOL = {torch.float32: 2.0 ** -16, torch.bfloat16: 2.0 ** -6}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _rn(dev, seed, *shape, scale=1.0, shift=0.0, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(*shape, generator=g, device=dev) * scale + shift).to(dtype)


def _check(got, want, compute_dtype=None):
    """``compute_dtype`` sets the tolerance when it is not the output's own
    (a bf16 kernel's fp32 gradient accumulators)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    got, want_f = got.float(), want.float()
    assert torch.isfinite(got).all()
    tol = REL_TOL[compute_dtype or want.dtype] * max(1.0, want_f.abs().max().item())
    err = (got - want_f).abs().max().item()
    assert err <= tol, f"max|d| {err} > {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 64), (3, 37, 128), (19700, 768), (7, 1280)])
def test_layer_norm(dev, dtype, shape):
    x = _rn(dev, 0, *shape, scale=3.0, shift=1.0, dtype=dtype)
    s = _rn(dev, 1, shape[-1], scale=0.2, shift=1.0, dtype=dtype)
    b = _rn(dev, 2, shape[-1], scale=0.2, dtype=dtype)
    _check(layer_norm(x, s, b, 1e-6), layer_norm_plain(x, s, b, 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,t,d,h",
    [(2, 5, 64, 4), (3, 197, 768, 12), (1, 1024, 128, 4), (2, 65, 256, 8),
     (2, 198, 384, 3), (1, 77, 768, 6)],
    ids=["tiny_dh16", "b16_t197", "t1024_dh32", "t65_dh32", "deit_t198_dh128", "wide_dh128"],
)
def test_ln_qkv_attn(dev, dtype, b, t, d, h):
    args = (
        _rn(dev, 0, b * t, d, scale=2.0, dtype=dtype),
        _rn(dev, 1, d, scale=0.2, shift=1.0, dtype=dtype),
        _rn(dev, 2, d, scale=0.2, dtype=dtype),
        _rn(dev, 3, d, 3 * d, scale=d ** -0.5, dtype=dtype),
        _rn(dev, 4, 3 * d, scale=0.1, dtype=dtype),
        h, t, 1e-6,
    )
    _check(ln_qkv_attn(*args), ln_qkv_attn_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(10, 64, 256), (591, 768, 3072), (133, 384, 1536)])
def test_out_ln_mlp_residual(dev, dtype, variant, rows, d, f):
    args = (
        _rn(dev, 0, rows, d, dtype=dtype),
        _rn(dev, 1, rows, d, scale=2.0, dtype=dtype),
        _rn(dev, 2, d, d, scale=d ** -0.5, dtype=dtype),
        _rn(dev, 3, d, scale=0.1, dtype=dtype),
        _rn(dev, 4, d, scale=0.2, shift=1.0, dtype=dtype),
        _rn(dev, 5, d, scale=0.2, dtype=dtype),
        _rn(dev, 6, d, f, scale=d ** -0.5, dtype=dtype),
        _rn(dev, 7, f, scale=0.1, dtype=dtype),
        _rn(dev, 8, f, d, scale=f ** -0.5, dtype=dtype),
        _rn(dev, 9, d, scale=0.1, dtype=dtype),
        1e-6, variant,
    )
    _check(out_ln_mlp_residual(*args), out_ln_mlp_residual_plain(*args))


@pytest.mark.cuda
def test_wrappers_reject_what_the_kernels_do_not_take(dev):
    x = torch.zeros(10, 64, device=dev)
    s = torch.ones(64, device=dev)
    with pytest.raises(TypeError, match="mixed dtypes"):
        layer_norm(x, s.bfloat16(), s)
    with pytest.raises(ValueError, match="contiguous"):
        layer_norm(torch.zeros(64, 10, device=dev).t(), s, s)
    with pytest.raises(ValueError, match="head_dim"):
        ln_qkv_attn(x, s, s, torch.zeros(64, 192, device=dev), torch.zeros(192, device=dev),
                    8, 5, 1e-6)  # 8 heads of dh 8
    with pytest.raises(TypeError, match="not supported"):
        layer_norm(x.half(), s.half(), s.half())


@pytest.mark.cuda
def test_fused_forward_launches_and_matches_eager(dev):
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops

    cfg = dataclasses.replace(VIT_B_16, depth=2, embed_dim=128, num_heads=2,
                              image_size=64, num_classes=11, name="vit_card_test")
    params = {k: v.to(dev) if torch.is_tensor(v) else {n: t.to(dev) for n, t in v.items()}
              for k, v in vit.init_params(torch.Generator().manual_seed(1), cfg).items()}
    x = torch.from_numpy(synth_images(3, cfg, seed=2)).to(dev)
    for fn in (layer_norm, ln_qkv_attn, out_ln_mlp_residual):
        fn.launches = 0
    got = vit.forward(params, x, cfg, get_ops("fused"))
    assert (ln_qkv_attn.launches, out_ln_mlp_residual.launches, layer_norm.launches) == (2, 2, 1)
    want = vit.forward(params, x, cfg, get_ops("eager"))
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=0)


# -- the training kernels K4-K7 ------------------------------------------------


def _check_all(got, want):
    """Every output of a backward kernel, at the tolerance of its compute
    dtype (that of its first output, the input gradient)."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        try:
            _check(g, w, want[0].dtype)
        except AssertionError as e:
            raise AssertionError(f"output {i}: {e}") from None


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(10, 64), (591, 768), (12608, 768), (133, 384)])
def test_out_residual(dev, dtype, rows, d):
    args = (_rn(dev, 0, rows, d, dtype=dtype), _rn(dev, 1, rows, d, scale=2.0, dtype=dtype),
            _rn(dev, 2, d, d, scale=d ** -0.5, dtype=dtype), _rn(dev, 3, d, scale=0.1, dtype=dtype))
    _check(out_residual(*args), out_residual_plain(*args))


def _mlp_args(dev, dtype, rows, d, f):
    return (
        _rn(dev, 1, rows, d, scale=2.0, dtype=dtype),
        _rn(dev, 4, d, scale=0.2, shift=1.0, dtype=dtype), _rn(dev, 5, d, scale=0.2, dtype=dtype),
        _rn(dev, 6, d, f, scale=d ** -0.5, dtype=dtype), _rn(dev, 7, f, scale=0.1, dtype=dtype),
        _rn(dev, 8, f, d, scale=f ** -0.5, dtype=dtype), _rn(dev, 9, d, scale=0.1, dtype=dtype),
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(10, 64, 256), (591, 768, 3072), (133, 384, 1536)])
def test_ln_mlp_residual(dev, dtype, variant, rows, d, f):
    args = (*_mlp_args(dev, dtype, rows, d, f), 1e-6, variant)
    _check(ln_mlp_residual(*args), ln_mlp_residual_plain(*args))


def _k7_args(dev, dtype, rows, d, f, variant):
    x1, s, b, w1, b1, w2, _ = _mlp_args(dev, dtype, rows, d, f)
    return (_rn(dev, 10, rows, d, dtype=dtype), x1, _rn(dev, 11, rows, d, dtype=dtype), s, b,
            w1, b1, w2, _rn(dev, 12, d, d, scale=d ** -0.5, dtype=dtype), 1e-6, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(10, 64, 256), (591, 768, 3072), (133, 384, 1536),
                                      (1000, 128, 512)])
def test_ln_mlp_out_residual_bwd(dev, dtype, variant, rows, d, f):
    args = _k7_args(dev, dtype, rows, d, f, variant)
    _check_all(ln_mlp_out_residual_bwd(*args), ln_mlp_out_residual_bwd_plain(*args))


def _k6_args(dev, dtype, b, t, d, h):
    return (
        _rn(dev, 20, b * t, d, dtype=dtype), _rn(dev, 21, b * t, d, dtype=dtype),
        _rn(dev, 0, b * t, d, scale=2.0, dtype=dtype),
        _rn(dev, 1, d, scale=0.2, shift=1.0, dtype=dtype), _rn(dev, 2, d, scale=0.2, dtype=dtype),
        _rn(dev, 3, d, 3 * d, scale=d ** -0.5, dtype=dtype),
        _rn(dev, 4, 3 * d, scale=0.1, dtype=dtype), h, t, 1e-6,
    )


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,t,d,h",
    [(2, 5, 64, 4), (3, 197, 768, 12), (1, 1024, 128, 4), (2, 65, 256, 8),
     (2, 198, 384, 3), (1, 1024, 384, 3)],
    ids=["tiny_dh16", "b16_t197", "t1024_dh32", "t65_dh32", "deit_t198_dh128", "t1024_dh128"],
)
def test_ln_qkv_attn_bwd(dev, dtype, b, t, d, h):
    args = _k6_args(dev, dtype, b, t, d, h)
    _check_all(ln_qkv_attn_bwd(*args), ln_qkv_attn_bwd_plain(*args))


@pytest.mark.cuda
def test_backward_kernels_are_deterministic(dev):
    # no float atomics: two runs give bit-identical outputs, gradients included
    k7 = _k7_args(dev, torch.bfloat16, 591, 768, 3072, "exact")
    k6 = _k6_args(dev, torch.bfloat16, 3, 197, 768, 12)
    for fn, args in ((ln_mlp_out_residual_bwd, k7), (ln_qkv_attn_bwd, k6)):
        first = [t.clone() for t in fn(*args)]
        for a, b in zip(first, fn(*args)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_fused_block_grads_match_eager_autograd(dev):
    from vit_tpu_torch.ops import trainable as TT

    dtype = torch.float32

    b, t, d, f, h = 2, 197, 256, 1024, 4
    x = _rn(dev, 30, b * t, d, dtype=dtype)
    k7 = _k7_args(dev, dtype, 1, d, f, "exact")
    k6 = _k6_args(dev, dtype, 1, 1, d, h)
    blk = {"ln1_scale": k6[3], "ln1_bias": k6[4], "wqkv": k6[5], "bqkv": k6[6], "wo": k7[8],
           "bo": _rn(dev, 31, d, scale=0.1, dtype=dtype), "ln2_scale": k7[3], "ln2_bias": k7[4],
           "w1": k7[5], "b1": k7[6], "w2": k7[7], "b2": _rn(dev, 32, d, scale=0.1, dtype=dtype)}
    weight = _rn(dev, 33, b * t, d)

    def grads(fn):
        xs = x.clone().requires_grad_(True)
        bs = {k: v.clone().requires_grad_(True) for k, v in blk.items()}
        (fn(xs, bs, h, t, 1e-6).float() * weight).sum().backward()
        return [xs.grad] + [bs[k].grad for k in TT.BLOCK_KEYS]

    launches = (ln_qkv_attn.launches, out_residual.launches, ln_mlp_residual.launches,
                ln_mlp_out_residual_bwd.launches, ln_qkv_attn_bwd.launches)
    got = grads(TT.encoder_block_trainable)
    assert (ln_qkv_attn.launches, out_residual.launches, ln_mlp_residual.launches,
            ln_mlp_out_residual_bwd.launches, ln_qkv_attn_bwd.launches) == tuple(
                n + 1 for n in launches)
    want = grads(TT._reference_block_2d)
    # the JAX package's oracle bar: 1e-3 of each gradient's scale
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype == dtype
        err, bound = (g - w).abs().max().item(), 1e-3 * max(1.0, w.abs().max().item())
        assert err <= bound, f"grad {i}: max|d| {err} > {bound}"
