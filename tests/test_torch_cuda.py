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
from vit_tpu_torch.ops.fused_block import drop_path_scale_rows
from vit_tpu_torch.ops.kernels.layer_norm import layer_norm, layer_norm_plain
from vit_tpu_torch.ops.kernels.ln_mlp_out_residual_bwd import (
    ln_mlp_out_residual_bwd,
    ln_mlp_out_residual_bwd_plain,
)
from vit_tpu_torch.ops.kernels.ln_mlp_out_residual_bwd_train import (
    ln_mlp_out_residual_bwd_train,
    ln_mlp_out_residual_bwd_train_plain,
)
from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual, ln_mlp_residual_plain
from vit_tpu_torch.ops.kernels.ln_mlp_residual_train import (
    ln_mlp_residual_train,
    ln_mlp_residual_train_plain,
)
from vit_tpu_torch.ops.kernels.out_residual_train import (
    out_residual_train,
    out_residual_train_plain,
)
from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn, ln_qkv_attn_plain
from vit_tpu_torch.ops.kernels.ln_qkv_attn_bwd import ln_qkv_attn_bwd, ln_qkv_attn_bwd_plain
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import (
    out_ln_mlp_residual,
    out_ln_mlp_residual_plain,
)
from vit_tpu_torch.ops.kernels.out_residual import out_residual, out_residual_plain
from vit_tpu_torch.ops.kernels.flash_attention import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from vit_tpu_torch.ops.kernels.flash_attention_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from vit_tpu_torch.ops.kernels.ln_mlp_residual_bwd import (
    ln_mlp_residual_bwd,
    ln_mlp_residual_bwd_plain,
)
from vit_tpu_torch.ops.kernels.out_residual_bwd import out_residual_bwd, out_residual_bwd_plain

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
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d,f,t", [(10, 64, 256, 5), (591, 768, 3072, 197),
                                        (1000, 128, 512, 10)])
def test_regularized_kernels(dev, dtype, rows, d, f, t):
    # K10, K11, K12a against their twins at p = 0.1, drop-path 0.1, every output
    dp_a = drop_path_scale_rows(2 ** 31 + 3, 4, rows // t, t, 0.1, device=dev)
    dp_m = drop_path_scale_rows(2 ** 31 + 3, 5, rows // t, t, 0.1, device=dev)
    reg = (2 ** 31 + 3, 0.1)
    k10 = (_rn(dev, 0, rows, d, dtype=dtype), _rn(dev, 1, rows, d, scale=2.0, dtype=dtype),
           _rn(dev, 2, d, d, scale=d ** -0.5, dtype=dtype), _rn(dev, 3, d, scale=0.1, dtype=dtype),
           dp_a, *reg)
    _check(out_residual_train(*k10), out_residual_train_plain(*k10))
    k11 = (*_mlp_args(dev, dtype, rows, d, f), dp_m, *reg, 1e-6)
    _check(ln_mlp_residual_train(*k11), ln_mlp_residual_train_plain(*k11))
    k12 = (*_k7_args(dev, dtype, rows, d, f, "exact")[:9], dp_m, dp_a, *reg, 1e-6)
    _check_all(ln_mlp_out_residual_bwd_train(*k12), ln_mlp_out_residual_bwd_train_plain(*k12))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_regularized_kernels_at_zero_rates_are_the_plain_kernels(dev, dtype):
    # bit for bit: the gates compile out at p = 0 and dp multiplies by 1
    rows, d, f = 591, 768, 3072
    ones = torch.ones(rows, device=dev)
    k4 = (_rn(dev, 0, rows, d, dtype=dtype), _rn(dev, 1, rows, d, scale=2.0, dtype=dtype),
          _rn(dev, 2, d, d, scale=d ** -0.5, dtype=dtype), _rn(dev, 3, d, scale=0.1, dtype=dtype))
    assert torch.equal(out_residual_train(*k4, ones, 7, 0.0), out_residual(*k4))
    k5 = _mlp_args(dev, dtype, rows, d, f)
    assert torch.equal(ln_mlp_residual_train(*k5, ones, 7, 0.0, 1e-6), ln_mlp_residual(*k5, 1e-6))
    k7 = _k7_args(dev, dtype, rows, d, f, "exact")
    for a, b in zip(ln_mlp_out_residual_bwd_train(*k7[:9], ones, ones, 7, 0.0, 1e-6),
                    ln_mlp_out_residual_bwd(*k7)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_regularized_block_grads_match_the_reference(dev):
    from vit_tpu_torch.ops import trainable as TT

    b, t, d, f, h = 2, 197, 256, 1024, 4
    x = _rn(dev, 30, b * t, d)
    k7 = _k7_args(dev, torch.float32, 1, d, f, "exact")
    k6 = _k6_args(dev, torch.float32, 1, 1, d, h)
    blk = {"ln1_scale": k6[3], "ln1_bias": k6[4], "wqkv": k6[5], "bqkv": k6[6], "wo": k7[8],
           "bo": _rn(dev, 31, d, scale=0.1), "ln2_scale": k7[3], "ln2_bias": k7[4],
           "w1": k7[5], "b1": k7[6], "w2": k7[7], "b2": _rn(dev, 32, d, scale=0.1)}
    weight = _rn(dev, 33, b * t, d)
    args = (h, t, 1e-6, "exact", 2 ** 31 + 9, 0.2, 0.3)

    def grads(fn):
        xs = x.clone().requires_grad_(True)
        bs = {k: v.clone().requires_grad_(True) for k, v in blk.items()}
        (fn(xs, bs, *args) * weight).sum().backward()
        return [xs.grad] + [bs[k].grad for k in TT.BLOCK_KEYS]

    before = ln_mlp_out_residual_bwd_train.launches
    got = grads(TT.encoder_block_train)
    assert ln_mlp_out_residual_bwd_train.launches == before + 1
    for i, (g, w) in enumerate(zip(got, grads(TT.train_block_reference_2d))):
        err, bound = (g - w).abs().max().item(), 1e-3 * max(1.0, w.abs().max().item())
        assert err <= bound, f"grad {i}: max|d| {err} > {bound}"


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


# -- the long-sequence kernels K13, K14, K8, K9 ----------------------------------

# (batch, heads, T, dh): ragged tiles at every head dim, B/16 @512's
# T = 1,025, and T = 2,048
FLASH_CASES = {
    "t100_dh32": (2, 2, 100, 32), "t64_dh16": (1, 3, 64, 16), "t160_dh64": (2, 2, 160, 64),
    "t77_dh128": (1, 2, 77, 128), "b16_t1025": (1, 12, 1025, 64), "t2048": (1, 2, 2048, 64),
}


def _qkv4(dev, dtype, b, h, t, dh, scale=1.0):
    return [_rn(dev, 40 + i, b, h, t, dh, scale=scale, dtype=dtype) for i in range(3)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_fwd(dev, dtype, case):
    q, k, v = _qkv4(dev, dtype, *FLASH_CASES[case])
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    want, want_lse = flash_attention_fwd_plain(q, k, v, True)
    _check(out, want)
    _check(lse, want_lse, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_fwd_extreme_logits(dev, dtype):
    # scores near 30^2 * 16 / 4 must stay finite.  fp32 is held to 2^-10 of
    # the output's scale, not 2^-16: an fp32 ulp of such a score (2.4e-4)
    # reaches p through exp, so two summation orders differ by that much
    q, k, v = _qkv4(dev, dtype, 1, 1, 64, 16)
    q, k = q * 30, k * 30
    out, _ = flash_attention_fwd(q, k, v)
    want, _ = flash_attention_fwd_plain(q, k, v)
    assert torch.isfinite(out).all()
    tol = {torch.float32: 2.0 ** -10, torch.bfloat16: REL_TOL[torch.bfloat16]}[dtype]
    err = (out.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(FLASH_CASES))
def test_flash_attention_bwd(dev, dtype, case):
    b, h, t, dh = FLASH_CASES[case]
    q, k, v = _qkv4(dev, dtype, b, h, t, dh)
    do = _rn(dev, 50, b, h, t, dh, dtype=dtype)
    out, lse = flash_attention_fwd_plain(q, k, v, True)
    _check_all(flash_attention_bwd(q, k, v, out, lse, do),
               flash_attention_bwd_plain(q, k, v, out, lse, do))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_packed_context_matches_contiguous(dev, dtype):
    # the packed (B*T, 3D) QKV and (B*T, D) context read and written in
    # place through strides, against the twins on contiguous (B, H, T, dh)
    from vit_tpu_torch.ops.flash_attention import flash_context_from_packed_qkv, packed_views

    b, t, h, dh = 2, 197, 12, 64
    qkv = _rn(dev, 60, b * t, 3 * h * dh, dtype=dtype).requires_grad_(True)
    g = _rn(dev, 61, b * t, h * dh, dtype=dtype)
    launches = (flash_attention_fwd.launches, flash_attention_bwd.launches)
    ctx = flash_context_from_packed_qkv(qkv, b, t, h)
    ctx.backward(g)
    assert (flash_attention_fwd.launches, flash_attention_bwd.launches) == tuple(
        n + 1 for n in launches)
    q, k, v = (x.contiguous() for x in packed_views(qkv.detach(), b, t, h, 3))
    want, lse = flash_attention_fwd_plain(q, k, v, True)
    _check(ctx.detach(), want.permute(0, 2, 1, 3).reshape(b * t, h * dh))
    (do,) = (x.contiguous() for x in packed_views(g, b, t, h, 1))
    dq, dk, dv = flash_attention_bwd_plain(q, k, v, want, lse, do)
    dqkv = torch.stack([dq, dk, dv], 3).permute(0, 2, 1, 3, 4).reshape(b * t, 3 * h * dh)
    _check(qkv.grad, dqkv)


def _k8_args(dev, dtype, rows, d, f, variant):
    x1, s, b, w1, b1, w2, _ = _mlp_args(dev, dtype, rows, d, f)
    return (_rn(dev, 10, rows, d, dtype=dtype), x1, s, b, w1, b1, w2, 1e-6, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(10, 64, 256), (591, 768, 3072), (133, 384, 1536),
                                      (16400, 768, 3072)])
def test_ln_mlp_residual_bwd(dev, dtype, variant, rows, d, f):
    args = _k8_args(dev, dtype, rows, d, f, variant)
    _check_all(ln_mlp_residual_bwd(*args), ln_mlp_residual_bwd_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d", [(10, 64), (591, 768), (16400, 768), (133, 384)])
def test_out_residual_bwd(dev, dtype, rows, d):
    args = (_rn(dev, 0, rows, d, dtype=dtype), _rn(dev, 1, rows, d, dtype=dtype),
            _rn(dev, 2, d, d, scale=d ** -0.5, dtype=dtype))
    _check_all(out_residual_bwd(*args), out_residual_bwd_plain(*args))


@pytest.mark.cuda
def test_split_and_flash_backward_are_deterministic(dev):
    q, k, v = _qkv4(dev, torch.bfloat16, 1, 12, 1025, 64)
    do = _rn(dev, 50, 1, 12, 1025, 64, dtype=torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    k8 = _k8_args(dev, torch.bfloat16, 591, 768, 3072, "exact")
    k9 = k8[:2] + (k8[4][:, :768].contiguous(),)
    for fn, args in ((ln_mlp_residual_bwd, k8), (out_residual_bwd, k9),
                     (flash_attention_bwd, (q, k, v, out, lse, do))):
        first = [t.clone() for t in fn(*args)]
        for a, b in zip(first, fn(*args)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_long_block_grads_match_eager_autograd(dev, monkeypatch):
    # the long-sequence trainable block (K13/K14, K4/K9, K5/K8) against
    # autograd through the eager block, fp32, the switch lowered to T - 1
    from vit_tpu_torch.ops import fused_block
    from vit_tpu_torch.ops import trainable as TT

    b, t, d, f, h = 2, 197, 256, 1024, 4
    monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", t - 1)
    x = _rn(dev, 30, b * t, d)
    k8 = _k8_args(dev, torch.float32, 1, d, f, "exact")
    k6 = _k6_args(dev, torch.float32, 1, 1, d, h)
    blk = {"ln1_scale": k6[3], "ln1_bias": k6[4], "wqkv": k6[5], "bqkv": k6[6],
           "wo": _rn(dev, 34, d, d, scale=d ** -0.5), "bo": _rn(dev, 31, d, scale=0.1),
           "ln2_scale": k8[2], "ln2_bias": k8[3], "w1": k8[4], "b1": k8[5], "w2": k8[6],
           "b2": _rn(dev, 32, d, scale=0.1)}
    weight = _rn(dev, 33, b * t, d)

    def grads(fn):
        xs = x.clone().requires_grad_(True)
        bs = {k: v.clone().requires_grad_(True) for k, v in blk.items()}
        (fn(xs, bs, h, t, 1e-6) * weight).sum().backward()
        return [xs.grad] + [bs[k].grad for k in TT.BLOCK_KEYS]

    counted = (flash_attention_fwd, flash_attention_bwd, out_residual, out_residual_bwd,
               ln_mlp_residual, ln_mlp_residual_bwd, ln_qkv_attn, ln_qkv_attn_bwd,
               ln_mlp_out_residual_bwd)
    before = [fn.launches for fn in counted]
    got = grads(TT.encoder_block_trainable)
    assert [fn.launches - n for fn, n in zip(counted, before)] == [1] * 6 + [0] * 3
    want = grads(TT._reference_block_2d)
    for i, (g, w) in enumerate(zip(got, want)):
        err, bound = (g - w).abs().max().item(), 1e-3 * max(1.0, w.abs().max().item())
        assert err <= bound, f"grad {i}: max|d| {err} > {bound}"
