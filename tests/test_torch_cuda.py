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
from vit_tpu_torch.ops.kernels.layer_norm import layer_norm, layer_norm_plain, register_vecs
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
from vit_tpu_torch.eval import quant_stages
from vit_tpu_torch.ops import quant
from vit_tpu_torch.ops.kernels import ln_mlp_residual_q8 as k17
from vit_tpu_torch.ops.kernels.ln_fc1_gelu_q8 import _ln_fc1_gelu_q8_stages
from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15
from vit_tpu_torch.ops.kernels import out_ln_mlp_residual_q8 as k16
from vit_tpu_torch.ops.kernels.kmajor_q8 import kmajor_q8

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


def _kernel_names(fn, calls: int = 5) -> set:
    """The CUDA kernels a call of ``fn`` launches, by name: a profiler trace
    over ``calls`` calls (a trace may drop a kernel's first records, so one
    call alone can miss a kernel)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.name for e in prof.events() if e.device_type == DeviceType.CUDA}


def _ln_operands(dev, dtype, shape):
    return (_rn(dev, 0, *shape, scale=3.0, shift=1.0, dtype=dtype),
            _rn(dev, 1, shape[-1], scale=0.2, shift=1.0, dtype=dtype),
            _rn(dev, 2, shape[-1], scale=0.2, dtype=dtype))


def _ln_kernel_ran(names, vecs, dtype):
    """K3's register pass of ``vecs`` vectors per lane (0: the two-read row
    kernel) is the one kernel among ``names``."""
    want = f"layer_norm_reg_kernel<{vecs}>" if vecs else "layer_norm_kernel<"
    assert len(names) == 1 and want in next(iter(names)), names
    if not vecs:
        assert ("bfloat16" in next(iter(names))) == (dtype == torch.bfloat16)


# widths at each edge of the register pass's tiles (256 x 2, 4, 8 values)
# and just past them, below them, and off the multiple of 8
@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 64), (3, 37, 128), (19700, 768), (7, 1280), (16400, 768),
                                   (5, 8), (9, 512), (9, 520), (9, 1024), (9, 1032), (5, 2048),
                                   (5, 2056), (4, 772), (33, 1000)])
def test_layer_norm(dev, dtype, shape):
    x, s, b = _ln_operands(dev, dtype, shape)
    d = shape[-1]
    vecs = register_vecs(x, s, b)
    want = next(v for v in (2, 4, 8) if d <= 256 * v) if d % 8 == 0 and d <= 2048 else 0
    assert vecs == (want if dtype == torch.bfloat16 else 0)
    _ln_kernel_ran(_kernel_names(lambda: layer_norm(x, s, b, 1e-6)), vecs, dtype)
    _check(layer_norm(x, s, b, 1e-6), layer_norm_plain(x, s, b, 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("which", [0, 1, 2], ids=["x", "scale", "bias"])
@pytest.mark.parametrize("offset", [1, 8], ids=["off_grid", "16_bytes_in"])
def test_layer_norm_storage_offset(dev, dtype, which, offset):
    # an operand that is a view at a storage offset: off the 16-byte grid it
    # takes the two-read row kernel; a whole 16 bytes in (bf16), the
    # register pass
    ops = list(_ln_operands(dev, dtype, (123, 768)))
    t = ops[which]
    buf = torch.zeros(t.numel() + offset, dtype=dtype, device=dev)
    ops[which] = buf[offset:].view(t.shape).copy_(t)
    assert ops[which].storage_offset() == offset and ops[which].is_contiguous()
    vecs = register_vecs(*ops)
    on_grid = offset * ops[which].element_size() % 16 == 0
    assert vecs == (4 if dtype == torch.bfloat16 and on_grid else 0)
    _ln_kernel_ran(_kernel_names(lambda: layer_norm(*ops, 1e-6)), vecs, dtype)
    _check(layer_norm(*ops, 1e-6), layer_norm_plain(*ops, 1e-6))
    _check(layer_norm(*ops, 1e-6), layer_norm(t if which == 0 else ops[0],
                                              t if which == 1 else ops[1],
                                              t if which == 2 else ops[2], 1e-6))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,t,d,h",
    [(2, 5, 64, 4), (3, 197, 768, 12), (1, 1024, 128, 4), (2, 65, 256, 8),
     (2, 198, 384, 3), (1, 77, 768, 6), (2, 257, 160, 2)],
    ids=["tiny_dh16", "b16_t197", "t1024_dh32", "t65_dh32", "deit_t198_dh128", "wide_dh128",
         "h14_t257_dh80"],
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


# -- the bf16 GEMM core of K1 and K2 (csrc/gemm_mma.cuh), alone and in place --

# (M, K, N): the main path's four GEMMs at B/16 batch 100 and @512 batch 16,
# ragged rows (batch 3, ToMe's merged counts), DeiT-T's N = D = 192, W_qkv
# at two heads of width 80 (480) and at tp 4 and 2 (576, 1,152), K tails
# past a multiple of the 64-deep k-step, and one whole tile
GEMM_CORE_CASES = [(19700, 768, 2304), (19700, 768, 768), (19700, 768, 3072),
                   (19700, 3072, 768), (16400, 768, 3072), (591, 768, 192), (591, 160, 480),
                   (2 * 158, 768, 576), (3 * 171, 768, 1152), (123, 200, 480), (5, 40, 8),
                   (300, 3080, 776), (128, 32, 128), (129, 96, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", GEMM_CORE_CASES)
def test_gemm_bf16_core(dev, m, k, n):
    # fp32 sums of the same bf16 products in another order; the tensor
    # cores' fp32 accumulation truncates (rounds toward zero) once per k16
    # step, so up to K / 16 fp32 ulps apart: 2^-14 of the largest |value|
    # covers K 3,080
    from vit_tpu_torch.ops.kernels.gemm_bf16 import gemm_bf16

    a = _rn(dev, 0, m, k, dtype=torch.bfloat16)
    b = _rn(dev, 1, k, n, scale=k ** -0.5, shift=0.05, dtype=torch.bfloat16)
    got, want = gemm_bf16(a, b), a.float() @ b.float()
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 2.0 ** -14 * max(1.0, want.abs().max().item()), err


def _k1_args(dev, dtype, b, t, d, heads, dh):
    return (_rn(dev, 0, b * t, d, scale=2.0, dtype=dtype),
            _rn(dev, 1, d, scale=0.2, shift=1.0, dtype=dtype),
            _rn(dev, 2, d, scale=0.2, dtype=dtype),
            _rn(dev, 3, d, 3 * heads * dh, scale=d ** -0.5, dtype=dtype),
            _rn(dev, 4, 3 * heads * dh, scale=0.1, dtype=dtype), heads, t, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,t,d,heads,dh",
    [(16, 1025, 768, 12, 64), (3, 197, 768, 3, 64), (3, 197, 768, 6, 64), (2, 65, 200, 2, 80),
     (2, 41, 776, 4, 32)],
    ids=["rows16400", "tp4_n576", "tp2_n1152", "ktail_d200_n480", "ktail_d776_dh32"],
)
def test_ln_qkv_attn_gemm_edges(dev, dtype, b, t, d, heads, dh):
    # W_qkv (D, 3 H dh) wider or narrower than D: the [in, out] weight read
    # in the wrong major order would pass no shape check and fail here
    args = _k1_args(dev, dtype, b, t, d, heads, dh)
    _check(ln_qkv_attn(*args), ln_qkv_attn_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows,d_ctx,d,f", [(16400, 768, 768, 3072), (19700, 768, 768, 3072),
                                            (591, 384, 768, 3072), (591, 576, 192, 776),
                                            (41, 200, 136, 520)])
def test_out_ln_mlp_residual_gemm_edges(dev, dtype, rows, d_ctx, d, f):
    # W_o (d_ctx, D) not square, N = 192 (DeiT-T), K tails in all three GEMMs
    args = (
        _rn(dev, 0, rows, d_ctx, dtype=dtype),
        _rn(dev, 1, rows, d, scale=2.0, dtype=dtype),
        _rn(dev, 2, d_ctx, d, scale=d_ctx ** -0.5, dtype=dtype),
        _rn(dev, 3, d, scale=0.1, dtype=dtype),
        _rn(dev, 4, d, scale=0.2, shift=1.0, dtype=dtype),
        _rn(dev, 5, d, scale=0.2, dtype=dtype),
        _rn(dev, 6, d, f, scale=d ** -0.5, dtype=dtype),
        _rn(dev, 7, f, scale=0.1, dtype=dtype),
        _rn(dev, 8, f, d, scale=f ** -0.5, dtype=dtype),
        _rn(dev, 9, d, scale=0.1, dtype=dtype),
        1e-6, "exact",
    )
    _check(out_ln_mlp_residual(*args), out_ln_mlp_residual_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("t", [41, 158, 171])
def test_ln_qkv_attn_hooked_merged_t(dev, t, dh):
    # ToMe's merged counts at every head width: the log-size bias before the
    # row max, the k-mean; a zero bias is the hook-less kernel bit for bit
    args = _k1_args(dev, torch.bfloat16, 3, t, 2 * dh, 2, dh)
    ls = _log_size(dev, 3, t)
    ctx, kmean = ln_qkv_attn(*args, log_size=ls, return_kmean=True)
    want_ctx, want_kmean = ln_qkv_attn_plain(*args, log_size=ls, return_kmean=True)
    _check(ctx, want_ctx)
    _check(kmean, want_kmean)
    zero, _ = ln_qkv_attn(*args, log_size=torch.zeros_like(ls), return_kmean=True)
    assert torch.equal(zero, ln_qkv_attn(*args))


@pytest.mark.cuda
def test_gemm_core_refuses_unaligned_operands(dev):
    from vit_tpu_torch.ops.kernels.gemm_bf16 import gemm_bf16

    bf = torch.bfloat16

    def off(*shape):  # contiguous, one element past the 16-byte grid
        n = int(np.prod(shape))
        return torch.zeros(n + 1, device=dev, dtype=bf)[1:].view(*shape)

    x, s = torch.zeros(10, 64, device=dev, dtype=bf), torch.ones(64, device=dev, dtype=bf)
    w, b = torch.zeros(64, 192, device=dev, dtype=bf), torch.zeros(192, device=dev, dtype=bf)
    ln_qkv_attn(x, s, s, w, b, 4, 5, 1e-6)  # aligned: runs
    with pytest.raises(ValueError, match="16-byte boundary"):
        ln_qkv_attn(x, s, s, off(64, 192), b, 4, 5, 1e-6)
    x60, s60 = torch.zeros(10, 60, device=dev, dtype=bf), torch.ones(60, device=dev, dtype=bf)
    with pytest.raises(ValueError, match="multiples of 8"):
        ln_qkv_attn(x60, s60, s60, torch.zeros(60, 192, device=dev, dtype=bf), b, 4, 5, 1e-6)
    mats = {"ctx": x, "wo": torch.zeros(64, 64, device=dev, dtype=bf),
            "w1": torch.zeros(64, 256, device=dev, dtype=bf),
            "w2": torch.zeros(256, 64, device=dev, dtype=bf)}
    b1 = torch.zeros(256, device=dev, dtype=bf)

    def k2(m, b1=b1):
        return out_ln_mlp_residual(m["ctx"], x, m["wo"], s, s, s, m["w1"], b1, m["w2"], s, 1e-6)

    k2(mats)  # aligned: runs
    for name, t in mats.items():
        with pytest.raises(ValueError, match="16-byte boundary"):
            k2({**mats, name: off(*t.shape)})
    odd = {**mats, "w1": torch.zeros(64, 260, device=dev, dtype=bf),
           "w2": torch.zeros(260, 64, device=dev, dtype=bf)}
    with pytest.raises(ValueError, match="multiples of 8"):
        k2(odd, torch.zeros(260, device=dev, dtype=bf))
    with pytest.raises(ValueError, match="multiples of 8"):
        gemm_bf16(torch.zeros(5, 40, device=dev, dtype=bf),
                  torch.zeros(40, 100, device=dev, dtype=bf))
    with pytest.raises(ValueError, match="16-byte boundary"):
        gemm_bf16(off(5, 40), torch.zeros(40, 64, device=dev, dtype=bf))


# The core's backward forms (K8, K12b), each alone against fp32
# torch.matmul: dY Wᵀ with W read K-major at ragged row counts (1, 123,
# ToMe's 64 x 171, @512 b16's 16,400) against the non-square [in, out]
# weights W2 (F, D) and W1 (D, F) and a ragged one; the weight gradients
# hᵀ dY with h read MN-major over those row counts as the depth, split as
# the kernels split them (0), in forced counts, and in one pass where the
# depth is short.  Widths of the stored operands are
# multiples of 8; M, N and K are ragged against the 128 x 128 x 64 tile.
GEMM_ROWS = (1, 123, 64 * 171, 16400)
GEMM_KMAJOR_B_CASES = [(m, k, n) for m in GEMM_ROWS
                       for k, n in ((768, 3072), (3072, 768), (200, 136))]
GEMM_MNMAJOR_A_CASES = ([(m, k, n, 0) for k in GEMM_ROWS
                         for m, n in ((768, 3072), (3072, 768), (136, 200))]
                        + [(m, k, n, 1) for k in GEMM_ROWS[:2] for m, n in ((768, 3072), (136, 200))]
                        + [(768, 64 * 171, 3072, 3), (3072, 16400, 768, 7), (136, 16400, 200, 32)])


def _gemm_form_check(a, b, trans_a, trans_b, splits):
    # the same rule as the default form's (test_gemm_bf16_core): 2^-14 of
    # the largest |value|; a split's partials add in fp32 in split order
    from vit_tpu_torch.ops.kernels.gemm_bf16 import gemm_bf16, gemm_bf16_plain

    got = gemm_bf16(a, b, trans_a, trans_b, splits)
    want = gemm_bf16_plain(a, b, trans_a, trans_b)
    assert got.shape == want.shape and torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 2.0 ** -14 * max(1.0, want.abs().max().item()), err
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", GEMM_KMAJOR_B_CASES)
def test_gemm_bf16_core_kmajor_b(dev, m, k, n):
    a = _rn(dev, 0, m, k, dtype=torch.bfloat16)
    w = _rn(dev, 1, n, k, scale=k ** -0.5, shift=0.05, dtype=torch.bfloat16)  # b = wᵀ
    _gemm_form_check(a, w, False, True, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,splits", GEMM_MNMAJOR_A_CASES)
def test_gemm_bf16_core_mnmajor_a_split(dev, m, k, n, splits):
    h = _rn(dev, 0, k, m, dtype=torch.bfloat16)  # a = hᵀ: k rows of width m
    g = _rn(dev, 1, k, n, scale=k ** -0.5, shift=0.05, dtype=torch.bfloat16)
    got = _gemm_form_check(h, g, True, False, splits)
    if splits != 1:  # a fixed-order sum: the same bits again
        from vit_tpu_torch.ops.kernels.gemm_bf16 import gemm_bf16

        assert torch.equal(got, gemm_bf16(h, g, True, False, splits))


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
@pytest.mark.parametrize("rows,d", [(10, 64), (591, 768), (12608, 768), (133, 384),
                                    (15800, 768), (10944, 768)])
def test_out_residual(dev, dtype, rows, d):
    # the last two: ToMe's merged rows, b100 x 158 (classify) and b64 x 171 (train)
    args = (_rn(dev, 0, rows, d, dtype=dtype), _rn(dev, 1, rows, d, scale=2.0, dtype=dtype),
            _rn(dev, 2, d, d, scale=d ** -0.5, dtype=dtype), _rn(dev, 3, d, scale=0.1, dtype=dtype))
    _check(out_residual(*args), out_residual_plain(*args))


# the bf16 K4 and K10 on the TMA + wgmma core: rows around the 128-row tile
# edge and @512 b16's 16,400; square, non-square and D 1,280 widths
OUT_FWD_ROWS = [1, 127, 128, 129, 16400]
OUT_FWD_WIDTHS = [(768, 768), (384, 768), (768, 256), (1280, 1280)]


def _out_fwd_args(dev, rows, d_ctx, d, dtype=torch.bfloat16):
    return (_rn(dev, 70, rows, d_ctx, dtype=dtype), _rn(dev, 71, rows, d, scale=2.0, dtype=dtype),
            _rn(dev, 72, d_ctx, d, scale=d_ctx ** -0.5, dtype=dtype),
            _rn(dev, 73, d, scale=0.1, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", OUT_FWD_ROWS)
@pytest.mark.parametrize("d_ctx,d", OUT_FWD_WIDTHS)
def test_out_residual_mma(dev, rows, d_ctx, d):
    # K4, and K10 at dropout and drop-path 0.1 and at drop-path only
    args = _out_fwd_args(dev, rows, d_ctx, d)
    _check(out_residual(*args), out_residual_plain(*args))
    seed = 2 ** 31 + 3
    dp = drop_path_scale_rows(seed, 4, rows, 1, 0.1, device=dev)
    for p in (0.1, 0.0):
        reg = (*args, dp, seed, p)
        _check(out_residual_train(*reg), out_residual_train_plain(*reg))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t", [(123, 41), (10944, 171), (12608, 197), (15800, 158)])
def test_out_residual_mma_is_deterministic_and_k10_at_zero_rates(dev, rows, t):
    # two runs of the bf16 K4 and K10 (p 0.1) bit for bit; K10 at p = 0,
    # dp = 1 equal to K4 bit for bit (the same accumulators through the same
    # core; v * 1.0f is exact); K10's zeros on a zero residual the twin's
    # (the attention-out mask pattern)
    seed = 2 ** 31 + 3
    args = _out_fwd_args(dev, rows, 768, 768)
    reg = (*args, drop_path_scale_rows(seed, 4, rows // t, t, 0.1, device=dev), seed, 0.1)
    for fn, a in ((out_residual, args), (out_residual_train, reg)):
        assert torch.equal(fn(*a), fn(*a))
    ones = torch.ones(rows, device=dev)
    assert torch.equal(out_residual_train(*args, ones, seed, 0.0), out_residual(*args))
    zero = (args[0], torch.zeros_like(args[1]), *args[2:], ones, seed, 0.1)
    assert torch.equal(out_residual_train(*zero) == 0, out_residual_train_plain(*zero) == 0)


@pytest.mark.cuda
def test_out_residual_refuses_unaligned_operands(dev):
    # bf16 K4 and K10 read ctx and wo through TMA tensor maps: either off the
    # 16-byte grid, or D or d_ctx not a multiple of 8, raises before any
    # launch (no fallback to the FMA core, the twin or the CPU); the residual
    # is read by the epilogue alone and may lie anywhere; fp32 takes them all
    def off(t):  # the same values, one element past the 16-byte grid
        flat = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)[1:]
        return flat.copy_(t.reshape(-1)).view(t.shape)

    ones = torch.ones(10, device=dev)
    args = _out_fwd_args(dev, 10, 64, 64)
    for i, name in ((0, "ctx"), (2, "wo")):
        bad = (*args[:i], off(args[i]), *args[i + 1:])
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            out_residual(*bad)
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            out_residual_train(*bad, ones, 7, 0.1)
        f32 = tuple(x.float() for x in bad)
        _check(out_residual(*f32), out_residual_plain(*f32))
    res_off = (args[0], off(args[1]), *args[2:])
    _check(out_residual(*res_off), out_residual_plain(*res_off))
    reg = (*res_off, ones, 7, 0.1)
    _check(out_residual_train(*reg), out_residual_train_plain(*reg))
    for d_ctx, d in ((64, 60), (60, 64)):
        odd = _out_fwd_args(dev, 10, d_ctx, d)
        with pytest.raises(ValueError, match="multiples of 8"):
            out_residual(*odd)
        with pytest.raises(ValueError, match="multiples of 8"):
            out_residual_train(*odd, ones, 7, 0.0)
        f32 = tuple(x.float() for x in odd)
        _check(out_residual(*f32), out_residual_plain(*f32))


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


# the bf16 K5 and K11 on the TMA + wgmma core: row counts at the core's
# 128-row tile edges, ToMe's merged counts (b3 x T 41, b64 x T 171, b100 x
# T 158) and @224 batch 64 (12,608 rows)
K5_MMA_ROWS = [1, 127, 128, 129, 3 * 41, 64 * 171, 100 * 158, 64 * 197]


@pytest.mark.cuda
@pytest.mark.parametrize("rows", K5_MMA_ROWS)
def test_ln_mlp_residual_mma_rows(dev, rows):
    # K5's block form, its partial form at the tp 2 and tp 4 shard widths,
    # the return_u stash, and K11 at p 0.1 with drop-path 0.1, each against
    # its twin at B/16 width
    from vit_tpu_torch.ops.kernels.ln_mlp_residual import (
        ln_mlp_partial_plain,
        ln_mlp_residual_u_plain,
    )

    bf, d, f = torch.bfloat16, 768, 3072
    args = _mlp_args(dev, bf, rows, d, f)
    _check(ln_mlp_residual(*args, 1e-6), ln_mlp_residual_plain(*args, 1e-6))
    for tp in (2, 4):
        x, s, b, w1, b1, w2, _ = args
        shard = (w1[:, :f // tp].contiguous(), b1[:f // tp].contiguous(),
                 w2[:f // tp].contiguous())
        got = ln_mlp_residual(x, s, b, *shard, None, 1e-6, partial=True)
        _check(got, ln_mlp_partial_plain(x, s, b, *shard, 1e-6), bf)
    for partial in (False, True):
        out, u = ln_mlp_residual(*args, 1e-6, partial=partial, return_u=True)
        want_out, want_u = ln_mlp_residual_u_plain(*args, 1e-6, partial=partial)
        _check(out, want_out, bf)
        _check(u, want_u)
    dp = drop_path_scale_rows(2 ** 31 + 3, 5, rows, 1, 0.1, device=dev)
    k11 = (*args, dp, 2 ** 31 + 3, 0.1, 1e-6)
    _check(ln_mlp_residual_train(*k11), ln_mlp_residual_train_plain(*k11))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(10, 64, 256), (591, 768, 3072)])
def test_ln_mlp_residual_return_u(dev, dtype, variant, rows, d, f):
    # the stash u = round(h W1 + b1) beside the block's and the partial form's out
    from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual_u_plain

    args = (*_mlp_args(dev, dtype, rows, d, f), 1e-6, variant)
    for partial in (False, True):
        out, u = ln_mlp_residual(*args, partial=partial, return_u=True)
        want_out, want_u = ln_mlp_residual_u_plain(*args, partial=partial)
        assert u.dtype == dtype and out.dtype == (torch.float32 if partial else dtype)
        _check(out, want_out, dtype)
        _check(u, want_u)
        # the out beside the stash is the form's out without it
        assert torch.equal(out, ln_mlp_residual(*args, partial=partial))


@pytest.mark.cuda
def test_ln_mlp_residual_train_masks_at_b64(dev):
    # bf16 K11 at p 0.1 (@224 batch 64): with x = 0, W1 = 0, b1 = 3 (gelu(u)
    # one constant), W2 = [I; 0] and b2 = 0, out = round(gelu(3) m_in) m_out dp
    # on the first D inner columns: its zeros are the twin's mask pattern;
    # and a sample whose drop-path scale is 0 keeps its residual rows as they were
    bf, d, f, b, t, seed = torch.bfloat16, 768, 3072, 64, 197, 2 ** 31 + 3
    rows = b * t
    x, s, bn, w1, b1, w2, b2 = _mlp_args(dev, bf, rows, d, f)
    dp = drop_path_scale_rows(seed, 5, b, t, 0.1, device=dev)
    assert (dp == 0).any() and (dp != 0).any()
    eye = torch.zeros(f, d, dtype=bf, device=dev)
    eye[:d] = torch.eye(d, dtype=bf, device=dev)
    ones = torch.ones(rows, device=dev)
    zeros_in = (torch.zeros(rows, d, dtype=bf, device=dev), s, bn,
                torch.zeros(d, f, dtype=bf, device=dev), torch.full((f,), 3.0, dtype=bf,
                                                                      device=dev),
                eye, torch.zeros(d, dtype=bf, device=dev), ones, seed, 0.1, 1e-6)
    got, want = ln_mlp_residual_train(*zeros_in), ln_mlp_residual_train_plain(*zeros_in)
    assert torch.equal(got == 0, want == 0)
    assert 0.75 < (got != 0).float().mean().item() < 0.87  # kept twice at p 0.1: 0.81
    k11 = (x, s, bn, w1, b1, w2, b2, dp, seed, 0.1, 1e-6)
    got = ln_mlp_residual_train(*k11)
    _check(got, ln_mlp_residual_train_plain(*k11))
    dropped = dp == 0
    assert torch.equal(got[dropped], x[dropped])
    assert not torch.equal(got[~dropped], x[~dropped])


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [129, 64 * 197])
def test_ln_mlp_residual_train_mma_at_zero_rates_is_k5(dev, rows):
    # bf16 K11 with the gates compiled out and dp all ones reads K5's h bits
    # through the same core: K5 bit for bit
    args = _mlp_args(dev, torch.bfloat16, rows, 768, 3072)
    ones = torch.ones(rows, device=dev)
    assert torch.equal(ln_mlp_residual_train(*args, ones, 7, 0.0, 1e-6),
                       ln_mlp_residual(*args, 1e-6))


@pytest.mark.cuda
def test_ln_mlp_residual_mma_is_deterministic_at_b64(dev):
    # bf16 K5 (block, partial at tp 2, with the stash) and K11 (p 0.1,
    # drop-path 0.1) at @224 batch 64, two runs bit for bit
    rows, seed = 64 * 197, 2 ** 31 + 7
    args = _mlp_args(dev, torch.bfloat16, rows, 768, 3072)
    x, s, b, w1, b1, w2, _ = args
    shard = (w1[:, :1536].contiguous(), b1[:1536].contiguous(), w2[:1536].contiguous())
    dp = drop_path_scale_rows(seed, 5, 64, 197, 0.1, device=dev)
    runs = [
        lambda: (ln_mlp_residual(*args, 1e-6),),
        lambda: (ln_mlp_residual(x, s, b, *shard, None, 1e-6, partial=True),),
        lambda: ln_mlp_residual(*args, 1e-6, return_u=True),
        lambda: (ln_mlp_residual_train(*args, dp, seed, 0.1, 1e-6),),
    ]
    for run in runs:
        first = [t.clone() for t in run()]
        for a, c in zip(first, run()):
            assert torch.equal(a, c)


@pytest.mark.cuda
def test_ln_mlp_residual_refuses_unaligned_operands(dev):
    # bf16 K5 and K11 read x (through its copy h), w1 and w2 through TMA
    # tensor maps: an operand off the 16-byte grid, or D or F not a multiple
    # of 8, raises before any launch (no fallback to the FMA core, the twin
    # or the CPU)
    bf = torch.bfloat16

    def off(t):  # the same values, one element past the 16-byte grid
        flat = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)[1:]
        return flat.copy_(t.reshape(-1)).view(t.shape)

    ones = torch.ones(10, device=dev)
    args = _mlp_args(dev, bf, 10, 64, 256)
    ln_mlp_residual(*args, 1e-6)  # aligned: runs
    ln_mlp_residual_train(*args, ones, 7, 0.1, 1e-6)
    for i, name in ((0, "x"), (3, "w1"), (5, "w2")):
        bad = (*args[:i], off(args[i]), *args[i + 1:])
        for call in (lambda: ln_mlp_residual(*bad, 1e-6),
                     lambda: ln_mlp_residual(*bad, 1e-6, partial=True),
                     lambda: ln_mlp_residual(*bad, 1e-6, return_u=True),
                     lambda: ln_mlp_residual_train(*bad, ones, 7, 0.1, 1e-6)):
            with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
                call()
    for d, f in ((60, 256), (64, 252)):
        odd = _mlp_args(dev, bf, 10, d, f)
        with pytest.raises(ValueError, match="multiples of 8"):
            ln_mlp_residual(*odd, 1e-6)
        with pytest.raises(ValueError, match="multiples of 8"):
            ln_mlp_residual(*odd, 1e-6, partial=True)
        with pytest.raises(ValueError, match="multiples of 8"):
            ln_mlp_residual_train(*odd, ones, 7, 0.0, 1e-6)


def _k7_args(dev, dtype, rows, d, f, variant):
    x1, s, b, w1, b1, w2, _ = _mlp_args(dev, dtype, rows, d, f)
    return (_rn(dev, 10, rows, d, dtype=dtype), x1, _rn(dev, 11, rows, d, dtype=dtype), s, b,
            w1, b1, w2, _rn(dev, 12, d, d, scale=d ** -0.5, dtype=dtype), 1e-6, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(10, 64, 256), (591, 768, 3072), (133, 384, 1536),
                                      (1000, 128, 512), (12608, 768, 3072)])
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
     (2, 198, 384, 3), (1, 1024, 384, 3), (2, 257, 160, 2), (64, 197, 768, 12)],
    ids=["tiny_dh16", "b16_t197", "t1024_dh32", "t65_dh32", "deit_t198_dh128", "t1024_dh128",
         "h14_t257_dh80", "b64_t197"],
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
    "h14_t257_dh80": (2, 16, 257, 80), "t1_dh64": (2, 3, 1, 64), "t65_dh64": (2, 2, 65, 64),
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
def test_flash_attention_bwd_is_deterministic(dev, dtype):
    # no atomics, fixed-order sums: two runs on strided views of a packed
    # QKV give the same bits
    from vit_tpu_torch.ops.flash_attention import packed_views

    b, h, t, dh = FLASH_CASES["b16_t1025"]
    q, k, v = packed_views(_rn(dev, 62, b * t, 3 * h * dh, dtype=dtype), b, t, h, 3)
    do = _rn(dev, 63, b, h, t, dh, dtype=dtype)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    first = [g.clone() for g in flash_attention_bwd(q, k, v, out, lse, do)]
    for a, b_ in zip(first, flash_attention_bwd(q, k, v, out, lse, do)):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_flash_attention_bwd_refuses_unaligned_views(dev):
    # 16-byte loads and stores: a base or token stride off the 16-byte grid raises
    from vit_tpu_torch.ops.flash_attention import packed_views

    b, h, t, dh = 1, 2, 70, 64
    q, k, v = _qkv4(dev, torch.bfloat16, b, h, t, dh)
    do = _rn(dev, 50, b, h, t, dh, dtype=torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    flat = _rn(dev, 64, b * h * t * dh + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + b * h * t * dh].view(b, h, t, dh)  # base 2 bytes off
    with pytest.raises(ValueError, match="do must start on a 16-byte boundary"):
        flash_attention_bwd(q, k, v, out, lse, shifted)
    wide = _rn(dev, 65, b * t, 3 * h * dh + 4, dtype=torch.bfloat16)  # token stride 392 bytes
    qs, ks, vs = packed_views(wide[:, :3 * h * dh], b, t, h, 3)
    with pytest.raises(ValueError, match="q must start on a 16-byte boundary"):
        flash_attention_bwd(qs, ks, vs, out, lse, do)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("t", [1, 15, 16, 17, 63, 64, 65, 197, 1025, 2048])
def test_flash_attention_fwd_mma_ragged(dev, dh, t):
    # the bf16 register-tile kernel at T around every 16-row warp edge and
    # 64-row tile edge, B/16 @224 and @512 and T = 2,048, at every head
    # width, on a ragged batch of strided views of a packed QKV writing a
    # packed context: out and lse against the twin
    from vit_tpu_torch.ops.flash_attention import packed_views

    b, h = 3, 2
    qkv = _rn(dev, t + dh, b * t, 3 * h * dh, scale=2.0, dtype=torch.bfloat16)
    q, k, v = packed_views(qkv, b, t, h, 3)
    ctx = torch.zeros(b * t, h * dh, dtype=torch.bfloat16, device=dev)
    (out,) = packed_views(ctx, b, t, h, 1)
    launches = flash_attention_fwd.launches
    _, lse = flash_attention_fwd(q, k, v, out=out, return_lse=True)
    assert flash_attention_fwd.launches == launches + 1
    want, want_lse = flash_attention_fwd_plain(q, k, v, True)
    _check(out, want)
    _check(lse, want_lse, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("t,dh", [(197, 64), (1025, 64), (257, 80)])
def test_flash_attention_fwd_mma_extreme_logits(dev, t, dh):
    # scores near 30^2 * dh / sqrt(dh) stay finite on the register tiles,
    # and lse carries them: bf16 out and the fp32 lse against the twin
    q, k, v = _qkv4(dev, torch.bfloat16, 2, 2, t, dh)
    q, k = q * 30, k * 30
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    want, want_lse = flash_attention_fwd_plain(q, k, v, True)
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _check(out, want)
    _check(lse, want_lse, torch.bfloat16)


@pytest.mark.cuda
def test_flash_attention_fwd_refuses_unaligned_views(dev):
    # 16-byte cp.async loads and stores: a bf16 base or token stride off the
    # 16-byte grid raises, naming the operand
    from vit_tpu_torch.ops.flash_attention import packed_views

    b, h, t, dh = 1, 2, 70, 64
    q, k, v = _qkv4(dev, torch.bfloat16, b, h, t, dh)
    flat = _rn(dev, 68, b * h * t * dh + 8, dtype=torch.bfloat16)
    shifted = flat[1:1 + b * h * t * dh].view(b, h, t, dh)  # base 2 bytes off
    with pytest.raises(ValueError, match="out must start on a 16-byte boundary"):
        flash_attention_fwd(q, k, v, out=shifted)
    wide = _rn(dev, 69, b * t, 3 * h * dh + 4, dtype=torch.bfloat16)  # token stride 392 bytes
    qs, ks, vs = packed_views(wide[:, :3 * h * dh], b, t, h, 3)
    with pytest.raises(ValueError, match="q must start on a 16-byte boundary"):
        flash_attention_fwd(qs, ks, vs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["b16_t1025", "t65_dh64", "h14_t257_dh80", "t77_dh128"])
def test_flash_attention_bwd_from_kernel_lse(dev, case):
    # K14 fed by the bf16 K13's own out and lse (as FlashContextFn feeds
    # it) against the twins run end to end from the inputs
    b, h, t, dh = FLASH_CASES[case]
    q, k, v = _qkv4(dev, torch.bfloat16, b, h, t, dh)
    do = _rn(dev, 51, b, h, t, dh, dtype=torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    want_out, want_lse = flash_attention_fwd_plain(q, k, v, True)
    _check_all(flash_attention_bwd(q, k, v, out, lse, do),
               flash_attention_bwd_plain(q, k, v, want_out, want_lse, do))


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
    from vit_tpu_torch.ops.kernels.ln_mlp_residual_bwd_train import ln_mlp_residual_bwd_train

    q, k, v = _qkv4(dev, torch.bfloat16, 1, 12, 1025, 64)
    do = _rn(dev, 50, 1, 12, 1025, 64, dtype=torch.bfloat16)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    k8 = _k8_args(dev, torch.bfloat16, 591, 768, 3072, "exact")
    k9 = k8[:2] + (k8[4][:, :768].contiguous(),)
    dp_m = drop_path_scale_rows(2 ** 31 + 5, 5, 3, 197, 0.1, device=dev)
    k12b = (*k8[:7], dp_m, 2 ** 31 + 5, 0.1, 1e-6, "exact")
    for fn, args in ((ln_mlp_residual_bwd, k8), (out_residual_bwd, k9),
                     (flash_attention_bwd, (q, k, v, out, lse, do)),
                     (ln_mlp_residual_bwd_train, k12b)):
        first = [t.clone() for t in fn(*args)]
        for a, b in zip(first, fn(*args)):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("regularized", [False, True], ids=["k8", "k12b"])
@pytest.mark.parametrize("b,t", [(3, 41), (64, 171)])
def test_split_mlp_backward_at_merged_counts(dev, dtype, regularized, b, t):
    # K8 and K12b (p = 0.1, drop-path 0.1) at ToMe r = 13's merged token
    # counts, rows ragged against the 128-row tile and the 64-row k-step
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd_train as k12b

    rows, seed = b * t, 2 ** 31 + 5
    args = _k8_args(dev, dtype, rows, 768, 3072, "exact")
    if regularized:
        dp_m = drop_path_scale_rows(seed, 5, b, t, 0.1, device=dev)
        args = (*args[:7], dp_m, seed, 0.1, 1e-6, "exact")
        _check_all(k12b.ln_mlp_residual_bwd_train(*args),
                   k12b.ln_mlp_residual_bwd_train_plain(*args))
    else:
        _check_all(ln_mlp_residual_bwd(*args), ln_mlp_residual_bwd_plain(*args))


@pytest.mark.cuda
def test_split_mlp_backward_refuses_unaligned_operands(dev):
    # bf16 K8 and K12b read dy, w1, w2 through TMA tensor maps: an operand
    # off the 16-byte grid, or D or F not a multiple of 8, raises before any
    # launch (no fallback to the FMA core, the twin or the CPU)
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd_train as k12b

    bf = torch.bfloat16

    def off(t):  # the same values, one element past the 16-byte grid
        flat = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)[1:]
        return flat.copy_(t.reshape(-1)).view(t.shape)

    args = _k8_args(dev, bf, 10, 64, 256, "exact")
    ones = torch.ones(10, device=dev)
    ln_mlp_residual_bwd(*args)  # aligned: runs
    k12b.ln_mlp_residual_bwd_train(*args[:7], ones, 7, 0.1, 1e-6)
    for i, name in ((0, "dy"), (1, "x1"), (4, "w1"), (6, "w2")):
        bad = (*args[:i], off(args[i]), *args[i + 1:])
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            ln_mlp_residual_bwd(*bad)
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            k12b.ln_mlp_residual_bwd_train(*bad[:7], ones, 7, 0.1, 1e-6)
    odd = _k8_args(dev, bf, 10, 60, 252, "exact")
    with pytest.raises(ValueError, match="multiples of 8"):
        ln_mlp_residual_bwd(*odd)
    with pytest.raises(ValueError, match="multiples of 8"):
        k12b.ln_mlp_residual_bwd_train(*odd[:7], ones, 7, 0.0, 1e-6)


# K8's tensor-parallel form (residual=False): rank 0's shard of B/16's MLP
# at tp 2 and 4 (F/tp 1,536 and 768), rows around the 128-row tile and at
# batch 16 and 64 of T 197
K8_PARTIAL_ROWS = [1, 127, 128, 129, 3152, 12608]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [1536, 768])
@pytest.mark.parametrize("rows", K8_PARTIAL_ROWS)
def test_ln_mlp_residual_bwd_partial(dev, dtype, f, rows):
    args = _k8_args(dev, dtype, rows, 768, f, "exact")
    _check_all(ln_mlp_residual_bwd(*args, residual=False),
               ln_mlp_residual_bwd_plain(*args, residual=False))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("f", [1536, 768])
def test_ln_mlp_residual_bwd_partial_weight_grads_are_the_residual_forms(dev, dtype, f):
    # the flag moves dx1 only: the six weight gradients and db2 are the
    # residual form's bit for bit, and two runs give the same bits
    args = _k8_args(dev, dtype, 3152, 768, f, "exact")
    joined = ln_mlp_residual_bwd(*args)
    first = [t.clone() for t in ln_mlp_residual_bwd(*args, residual=False)]
    for a, b in zip(first[1:], joined[1:]):
        assert torch.equal(a, b)
    for a, b in zip(first, ln_mlp_residual_bwd(*args, residual=False)):
        assert torch.equal(a, b)
    # and dx1 is the joined one less dy, within one rounding of the dtype
    want = (joined[0].float() - args[0].float())
    tol = REL_TOL[dtype] * max(1.0, want.abs().max().item())
    assert (first[0].float() - want).abs().max().item() <= tol


@pytest.mark.cuda
def test_ln_mlp_residual_bwd_partial_refuses_unaligned_operands(dev):
    bf = torch.bfloat16

    def off(t):
        flat = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)[1:]
        return flat.copy_(t.reshape(-1)).view(t.shape)

    args = _k8_args(dev, bf, 129, 768, 1536, "exact")
    ln_mlp_residual_bwd(*args, residual=False)  # aligned: runs
    for i, name in ((0, "dy"), (1, "x1"), (4, "w1"), (6, "w2")):
        bad = (*args[:i], off(args[i]), *args[i + 1:])
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            ln_mlp_residual_bwd(*bad, residual=False)
    with pytest.raises(ValueError, match="multiples of 8"):
        ln_mlp_residual_bwd(*_k8_args(dev, bf, 10, 60, 252, "exact"), residual=False)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows", [591, 12608])
def test_merged_mlp_out_backward_mlp_outputs_are_k8s(dev, variant, rows):
    # the bf16 K7 runs K8's chain with the out_proj tail after it: its MLP
    # outputs (dx1, dgamma, dbeta, dW1, db1, dW2, db2) are K8's bit for bit
    # (rows 12,608: ViT-B/16 @224 batch 64)
    k7 = _k7_args(dev, torch.bfloat16, rows, 768, 3072, variant)
    got = ln_mlp_out_residual_bwd(*k7)
    want = ln_mlp_residual_bwd(*k7[:2], *k7[3:8], 1e-6, variant)
    for a, b in zip((got[0], *got[2:8]), want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_merged_mlp_out_backward_is_deterministic_at_b64(dev):
    # bf16 K7 and K12a (p = 0.1, drop-path 0.1) at @224 batch 64, two runs
    # bit for bit: split-K partials and column sums in a fixed order
    rows, seed = 64 * 197, 2 ** 31 + 7
    k7 = _k7_args(dev, torch.bfloat16, rows, 768, 3072, "exact")
    dp_a, dp_m = (drop_path_scale_rows(seed, site, 64, 197, 0.1, device=dev) for site in (4, 5))
    k12a = (*k7[:9], dp_m, dp_a, seed, 0.1, 1e-6)
    for fn, args in ((ln_mlp_out_residual_bwd, k7), (ln_mlp_out_residual_bwd_train, k12a)):
        first = [t.clone() for t in fn(*args)]
        for a, b in zip(first, fn(*args)):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_merged_mlp_out_backward_refuses_unaligned_operands(dev):
    # bf16 K7 and K12a read dy, ctx, w1, w2 and wo through TMA tensor maps:
    # an operand off the 16-byte grid, or D, F or d_ctx not a multiple of 8,
    # raises before any launch (no fallback to the FMA core, the twin or the
    # CPU)
    bf = torch.bfloat16

    def off(t):  # the same values, one element past the 16-byte grid
        flat = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)[1:]
        return flat.copy_(t.reshape(-1)).view(t.shape)

    ones = torch.ones(10, device=dev)
    reg = lambda a: (*a[:9], ones, ones, 7, 0.1, 1e-6)  # noqa: E731
    args = _k7_args(dev, bf, 10, 64, 256, "exact")
    ln_mlp_out_residual_bwd(*args)  # aligned: runs
    ln_mlp_out_residual_bwd_train(*reg(args))
    for i, name in ((0, "dy"), (1, "x1"), (2, "ctx"), (5, "w1"), (7, "w2"), (8, "wo")):
        bad = (*args[:i], off(args[i]), *args[i + 1:])
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            ln_mlp_out_residual_bwd(*bad)
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            ln_mlp_out_residual_bwd_train(*reg(bad))
    odd = _k7_args(dev, bf, 10, 60, 252, "exact")
    with pytest.raises(ValueError, match="multiples of 8"):
        ln_mlp_out_residual_bwd(*odd)
    with pytest.raises(ValueError, match="multiples of 8"):
        ln_mlp_out_residual_bwd_train(*reg(odd))


# the bf16 K9 and K12c on the TMA + wgmma core (K7's out_proj tail): rows at
# every 64-row k-step and 128-row tile edge, ToMe's merged 3 x 41 and 64 x
# 171 and @512's 16 x 1,025; square, non-square and dh 80 widths
OUT_BWD_ROWS = [1, 63, 64, 65, 123, 127, 128, 129, 10944, 16400]
OUT_BWD_WIDTHS = [(768, 768), (384, 768), (768, 256), (1280, 1280)]


def _out_bwd_args(dev, rows, d_ctx, d, dtype=torch.bfloat16):
    return (_rn(dev, 60, rows, d, dtype=dtype), _rn(dev, 61, rows, d_ctx, dtype=dtype),
            _rn(dev, 62, d_ctx, d, scale=d_ctx ** -0.5, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", OUT_BWD_ROWS)
@pytest.mark.parametrize("d_ctx,d", OUT_BWD_WIDTHS)
def test_out_residual_bwd_mma(dev, rows, d_ctx, d):
    from vit_tpu_torch.ops.kernels import out_residual_bwd_train as k12c

    args = _out_bwd_args(dev, rows, d_ctx, d)
    _check_all(out_residual_bwd(*args), out_residual_bwd_plain(*args))
    seed = 2 ** 31 + 3
    reg = (*args, drop_path_scale_rows(seed, 4, rows, 1, 0.1, device=dev), seed, 0.1)
    _check_all(k12c.out_residual_bwd_train(*reg), k12c.out_residual_bwd_train_plain(*reg))


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [591, 12608])
def test_out_residual_bwd_on_k7s_dx1_is_k7s_tail(dev, rows):
    # the bf16 K9 is the bf16 K7's out_proj tail: on K7's own bf16 dx1 its
    # dctx and dW_o are K7's bit for bit; db_o only within tolerance, as K9
    # sums the bf16 dx1 and K7 its fp32 dx1
    k7 = _k7_args(dev, torch.bfloat16, rows, 768, 3072, "exact")
    got7 = ln_mlp_out_residual_bwd(*k7)
    dctx, dwo, dbo = out_residual_bwd(got7[0], k7[2], k7[8])
    assert torch.equal(dctx, got7[1]) and torch.equal(dwo, got7[8])
    _check(dbo, got7[9], torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,t", [(123, 41), (10944, 171), (16400, 1025)])
def test_out_residual_bwd_mma_is_deterministic_and_k12c_at_zero_rates(dev, rows, t):
    # two runs of the bf16 K9 and K12c (p 0.1) bit for bit (the split picked
    # from the shape alone, fixed-order sums), and K12c at p = 0, dp = 1
    # equal to K9 bit for bit
    from vit_tpu_torch.ops.kernels import out_residual_bwd_train as k12c

    seed = 2 ** 31 + 3
    args = _out_bwd_args(dev, rows, 768, 768)
    reg = (*args, drop_path_scale_rows(seed, 4, rows // t, t, 0.1, device=dev), seed, 0.1)
    for fn, a in ((out_residual_bwd, args), (k12c.out_residual_bwd_train, reg)):
        first = [x.clone() for x in fn(*a)]
        for x, y in zip(first, fn(*a)):
            assert torch.equal(x, y)
    ones = torch.ones(rows, device=dev)
    for x, y in zip(k12c.out_residual_bwd_train(*args, ones, seed, 0.0), out_residual_bwd(*args)):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_out_residual_bwd_refuses_unaligned_operands(dev):
    # bf16 K9 and K12c read dx1 (K12c: its gated copy), ctx and wo through
    # TMA tensor maps: an operand off the 16-byte grid, or D or d_ctx not a
    # multiple of 8, raises before any launch (no fallback to the FMA core,
    # the twin or the CPU); fp32 takes them
    from vit_tpu_torch.ops.kernels import out_residual_bwd_train as k12c

    def off(t):  # the same values, one element past the 16-byte grid
        flat = torch.empty(t.numel() + 1, device=dev, dtype=t.dtype)[1:]
        return flat.copy_(t.reshape(-1)).view(t.shape)

    ones = torch.ones(10, device=dev)
    args = _out_bwd_args(dev, 10, 64, 64)
    out_residual_bwd(*args)  # aligned: runs
    k12c.out_residual_bwd_train(*args, ones, 7, 0.1)
    for i, name in ((0, "dx1"), (1, "ctx"), (2, "wo")):
        bad = (*args[:i], off(args[i]), *args[i + 1:])
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            out_residual_bwd(*bad)
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            k12c.out_residual_bwd_train(*bad, ones, 7, 0.1)
        f32 = tuple(x.float() for x in bad)
        _check_all(out_residual_bwd(*f32), out_residual_bwd_plain(*f32))
    for d_ctx, d in ((64, 60), (60, 64)):
        odd = _out_bwd_args(dev, 10, d_ctx, d)
        with pytest.raises(ValueError, match="multiples of 8"):
            out_residual_bwd(*odd)
        with pytest.raises(ValueError, match="multiples of 8"):
            k12c.out_residual_bwd_train(*odd, ones, 7, 0.0)
        f32 = tuple(x.float() for x in odd)
        _check_all(out_residual_bwd(*f32), out_residual_bwd_plain(*f32))


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


# -- the W8A8 kernels K15-K17 ---------------------------------------------------
# Held to their twins stage by stage (vit_tpu_torch/eval/quant_stages.py has
# the two checks and where their bounds come from): a kernel and its twin
# quantize an LN output that differs in its last bits, so a code on a
# rounding boundary may move, and an end-to-end comparison at the fp32
# tolerance would fail for a reason that is no fault.


def _q8_weight(dev, seed, k, n):
    q = quant.quantize_weight(_rn(dev, seed, k, n, scale=k ** -0.5))
    return q.w_q, q.scale


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(5, 64, 48), (591, 768, 2304), (300, 3072, 768),
                                   (129, 144, 272)])
def test_gemm_q8_core_is_exact(dev, m, k, n):
    # int32 sums and a dequantization of separate fp32 roundings: the
    # kernel's product equals the float64 reference bit for bit, +-127
    # operands at K = 3,072 (sums past 2^24) included
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    a[0], b[:, 0] = 127, 127
    sa, sb = _rn(dev, 1, m).abs() + 0.1, _rn(dev, 2, n).abs() + 0.1
    got = k15.gemm_q8_dequant(a, sa, b, sb)
    assert torch.equal(got, quant.int8_matmul_reference(a, sa, b, sb))
    assert torch.equal(got, k15.gemm_q8_dequant(a, sa, b, sb))


def _int_mm_dequant(a, sa, b, sb):
    """torch._int_mm's int32 sums dequantized as the reference does: a
    yardstick the port never calls."""
    return torch._int_mm(a, b).float() * sa[:, None] * sb[None, :]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(5, 64, 48), (591, 768, 2304), (300, 3072, 768),
                                   (129, 144, 272), (19700, 768, 2304), (19700, 768, 3072),
                                   (19700, 3072, 768), (127, 3072, 3072)])
def test_gemm_q8_mma_core_is_exact(dev, m, k, n):
    # the int8 TMA + wgmma core (B read K-major) against the float64
    # reference, gemm_q8.cuh's WMMA core and torch._int_mm, bit for bit: the
    # B/16 shapes at batch 100 (QKV, FC1, FC2), ragged M, K = 3,072 with
    # +-127 operands (sums past 2^24), N and K tails inside a tile
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    a[0], b[:, 0] = 127, 127
    a[-1], b[:, -1] = -127, 127
    sa, sb = _rn(dev, 1, m).abs() + 0.1, _rn(dev, 2, n).abs() + 0.1
    bt = kmajor_q8(b)
    assert torch.equal(bt, b.t().contiguous())
    got = k16.gemm_q8_mma_dequant(a, sa, bt, sb)
    assert torch.equal(got, quant.int8_matmul_reference(a, sa, b, sb))
    assert torch.equal(got, k15.gemm_q8_dequant(a, sa, b, sb))
    if m > 16:  # torch._int_mm takes more than 16 rows
        assert torch.equal(got, _int_mm_dequant(a, sa, b, sb))
    assert torch.equal(got, k16.gemm_q8_mma_dequant(a, sa, bt, sb))


@pytest.mark.cuda
def test_gemm_q8_mma_core_refuses_what_it_does_not_take(dev):
    a = torch.zeros(20, 64, dtype=torch.int8, device=dev)
    s = torch.ones(20, device=dev)
    with pytest.raises(ValueError, match="multiples of 16"):
        k16.gemm_q8_mma_dequant(a[:, :56].contiguous(), s, torch.zeros(32, 56, dtype=torch.int8,
                                                                       device=dev), s[:16])
    with pytest.raises(ValueError, match="multiples of 16"):
        kmajor_q8(torch.zeros(64, 40, dtype=torch.int8, device=dev))
    with pytest.raises(ValueError, match="16-byte aligned"):
        off = torch.zeros(20 * 64 + 1, dtype=torch.int8, device=dev)[1:].view(20, 64)
        k16.gemm_q8_mma_dequant(off, s, torch.zeros(32, 64, dtype=torch.int8, device=dev),
                                s[:16].repeat(2))


def _k15_args(dev, dtype, b, t, d, h):
    return (_rn(dev, 0, b * t, d, scale=2.0, dtype=dtype),
            _rn(dev, 1, d, scale=0.2, shift=1.0, dtype=dtype), _rn(dev, 2, d, scale=0.2, dtype=dtype),
            *_q8_weight(dev, 3, d, 3 * d), _rn(dev, 4, 3 * d, scale=0.1, dtype=dtype), h, t, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,t,d,h", [(2, 5, 64, 4), (3, 197, 768, 12), (2, 65, 256, 8), (1, 77, 768, 6),
                (2, 257, 160, 2)],
    ids=["tiny_dh16", "b16_t197_ragged_rows", "t65_dh32", "wide_dh128", "h14_t257_dh80"],
)
def test_ln_qkv_attn_q8(dev, dtype, b, t, d, h):
    args = _k15_args(dev, dtype, b, t, d, h)
    st = k15._ln_qkv_attn_q8_stages(*args)
    quant_stages.check_ln_qkv_attn_q8(st, k15.ln_qkv_attn_q8_plain(*args), *args)
    again = k15._ln_qkv_attn_q8_stages(*args)
    assert all(torch.equal(st[k], again[k]) for k in st)  # two runs, the same bits
    # stages 1-2 alone, as the long block calls them
    alone = k15._ln_qkv_q8_stages(*args[:6], 1e-6)
    assert all(torch.equal(st[k], alone[k]) for k in alone)


def _mlp_q8_args(dev, dtype, rows, d, f, variant):
    return (_rn(dev, 1, rows, d, scale=2.0, dtype=dtype),
            _rn(dev, 4, d, scale=0.2, shift=1.0, dtype=dtype), _rn(dev, 5, d, scale=0.2, dtype=dtype),
            *_q8_weight(dev, 6, d, f), _rn(dev, 7, f, scale=0.1, dtype=dtype),
            *_q8_weight(dev, 8, f, d), _rn(dev, 9, d, scale=0.1, dtype=dtype), 1e-6, variant)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(10, 64, 256), (591, 768, 3072), (133, 384, 1536)])
def test_out_ln_mlp_residual_q8(dev, dtype, variant, rows, d, f):
    res, *mlp = _mlp_q8_args(dev, dtype, rows, d, f, variant)
    args = (_rn(dev, 0, rows, d, dtype=dtype), res, _rn(dev, 2, d, d, scale=d ** -0.5, dtype=dtype),
            _rn(dev, 3, d, scale=0.1, dtype=dtype), *mlp)
    st = k16._out_ln_mlp_residual_q8_stages(*args)
    quant_stages.check_out_ln_mlp_residual_q8(st, k16.out_ln_mlp_residual_q8_plain(*args), *args)
    again = k16._out_ln_mlp_residual_q8_stages(*args)
    assert all(torch.equal(st[k], again[k]) for k in st)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(1, 768, 3072), (127, 768, 3072), (129, 768, 3072),
                                      (591, 768, 3072), (19700, 768, 3072), (37, 1280, 5120),
                                      (37, 2304, 9216)],
                         ids=["rows1", "rows127", "rows129", "rows591", "rows19700", "h14",
                              "wide"])
def test_out_ln_mlp_residual_q8_mma_stages(dev, variant, rows, d, f):
    # the bf16 K16 on the two TMA + wgmma cores, stage by stage (x1; hq/hs
    # by the quantizer rule; mid on the kernel's own hq; mq/ms bit for bit
    # on its own mid; out on its own mq): at B/16 widths one row, ragged
    # rows, batch 3 and batch 100; at H/14's widths (the row passes' wider
    # register tiles) and past them (their two-read fallbacks); the K-major
    # weight copies are the transposes; two runs give the same bits
    res, *mlp = _mlp_q8_args(dev, torch.bfloat16, rows, d, f, variant)
    args = (_rn(dev, 0, rows, d, dtype=torch.bfloat16), res,
            _rn(dev, 2, d, d, scale=d ** -0.5, dtype=torch.bfloat16),
            _rn(dev, 3, d, scale=0.1, dtype=torch.bfloat16), *mlp)
    st = k16._out_ln_mlp_residual_q8_stages(*args)
    quant_stages.check_out_ln_mlp_residual_q8(st, k16.out_ln_mlp_residual_q8_plain(*args), *args)
    w1q, w2q = args[6], args[9]
    assert torch.equal(st["w1t"], w1q.t().contiguous())
    assert torch.equal(st["w2t"], w2q.t().contiguous())
    again = k16._out_ln_mlp_residual_q8_stages(*args)
    assert all(torch.equal(st[k], again[k]) for k in st)


@pytest.mark.cuda
def test_out_ln_mlp_residual_q8_refuses_unaligned_operands(dev):
    # bf16 K16 reads ctx and W_o through the bf16 core's tensor maps: an
    # operand off the 16-byte grid, or a width not a multiple of 8, raises
    # before any launch; the int8 weights keep the rule of 16
    bf = torch.bfloat16
    res, *mlp = _mlp_q8_args(dev, bf, 10, 64, 256, "exact")
    args = (_rn(dev, 0, 10, 64, dtype=bf), res, _rn(dev, 2, 64, 64, scale=0.125, dtype=bf),
            _rn(dev, 3, 64, scale=0.1, dtype=bf), *mlp)
    k16.out_ln_mlp_residual_q8(*args)
    for i, name in ((0, "ctx"), (2, "wo")):
        bad = (*args[:i], _off_grid(args[i]), *args[i + 1:])
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            k16.out_ln_mlp_residual_q8(*bad)
    narrow = (args[0][:, :60].contiguous(), args[1], args[2][:60].contiguous(), *args[3:])
    with pytest.raises(ValueError, match="ctx is 60 elements wide"):
        k16.out_ln_mlp_residual_q8(*narrow)


# (batch, T, D, heads) of the bf16 K15: one row, ragged rows, batch 3 and
# batch 100 at B/16's T 197, then every head width (16, 32, 80, 128)
K15_MMA_CASES = {"rows1": (1, 1, 768, 12), "b1_t197": (1, 197, 768, 12),
                 "b3_t197": (3, 197, 768, 12), "b100_t197": (100, 197, 768, 12),
                 "dh16": (3, 197, 768, 48), "dh32": (3, 197, 768, 24),
                 "h14_t257_dh80": (2, 257, 1280, 16), "dh128": (3, 197, 768, 6)}


@pytest.mark.cuda
@pytest.mark.parametrize("hooks", ["none", "log_size", "kmean", "both"])
@pytest.mark.parametrize("case", list(K15_MMA_CASES))
def test_ln_qkv_attn_q8_mma_stages(dev, case, hooks):
    # the bf16 K15 (Wq's K-major copy, the row codes, the int8 QKV GEMM on
    # the TMA + wgmma core, K1's bf16 attention tiles), stage by stage: hq/hs
    # by the quantizer rule, the packed QKV on the kernel's own codes, the
    # context on its own packed QKV (with the log-size bias where given),
    # the k-mean bit for bit the mean key of its own packed QKV; the K-major
    # copy is the transpose; two runs give the same bits
    b, t, d, h = K15_MMA_CASES[case]
    args = _k15_args(dev, torch.bfloat16, b, t, d, h)
    ls = _log_size(dev, b, t) if hooks in ("log_size", "both") else None
    kmean = hooks in ("kmean", "both")
    st = k15._ln_qkv_attn_q8_stages(*args, ls, kmean)
    assert ("kmean" in st) == kmean
    report = quant_stages.check_ln_qkv_attn_q8(st, k15.ln_qkv_attn_q8_plain(*args, log_size=ls),
                                               *args, ls, kmean)
    assert report.get("kmean", 0.0) == 0.0
    assert torch.equal(st["wqt"], args[3].t().contiguous())
    again = k15._ln_qkv_attn_q8_stages(*args, ls, kmean)
    assert all(torch.equal(st[k], again[k]) for k in st)
    # stages 1-2 alone, as the long block calls them
    alone = k15._ln_qkv_q8_stages(*args[:6], 1e-6)
    assert all(torch.equal(st[k], alone[k]) for k in alone)


@pytest.mark.cuda
def test_ln_qkv_attn_q8_mma_refuses_unaligned_operands(dev):
    # the bf16 K15 copies Wq with 16-byte loads and reads its codes through
    # TMA boxes: Wq off the 16-byte grid, or D not a multiple of 16, raises
    # before any launch
    args = _k15_args(dev, torch.bfloat16, 2, 5, 64, 4)
    k15.ln_qkv_attn_q8(*args)
    with pytest.raises(ValueError, match="16-byte aligned"):
        k15.ln_qkv_attn_q8(*args[:3], _off_grid(args[3]), *args[4:])
    with pytest.raises(ValueError, match="multiples of 16"):
        k15.ln_qkv_q8(args[0][:, :56].contiguous(), args[1][:56], args[2][:56],
                      args[3][:56].contiguous(), args[4], args[5], 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(1, 768, 3072), (127, 768, 3072), (129, 768, 3072),
                                      (591, 768, 3072), (19700, 768, 3072), (37, 1280, 5120),
                                      (37, 2304, 9216)],
                         ids=["rows1", "rows127", "rows129", "rows591", "rows19700", "h14",
                              "wide"])
def test_ln_mlp_residual_q8_mma_stages(dev, variant, rows, d, f):
    # the bf16 K17 on K16's chain from LN2 on, stage by stage (hq/hs by the
    # quantizer rule; mid on its own hq; mq/ms bit for bit on its own mid;
    # out on its own mq): at B/16 widths one row, ragged rows, batch 3 and
    # batch 100; at H/14's widths and past them (the mid pass's two-read
    # fallback); the K-major weight copies are the transposes; LN2's codes
    # are K18a's row pass's bit for bit; two runs give the same bits
    args = _mlp_q8_args(dev, torch.bfloat16, rows, d, f, variant)
    st = k17._ln_mlp_residual_q8_stages(*args)
    quant_stages.check_ln_mlp_residual_q8(st, k17.ln_mlp_residual_q8_plain(*args), *args)
    w1q, w2q = args[3], args[6]
    assert torch.equal(st["w1t"], w1q.t().contiguous())
    assert torch.equal(st["w2t"], w2q.t().contiguous())
    x, s2, b2n, w1q, w1s, b1 = args[:6]
    a = _ln_fc1_gelu_q8_stages(x, s2, b2n, w1q, w1s, b1, 1e-6, variant, True)
    assert torch.equal(st["hq"], a["hq"]) and torch.equal(st["hs"], a["hs"])
    again = k17._ln_mlp_residual_q8_stages(*args)
    assert all(torch.equal(st[k], again[k]) for k in st)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [591, 19700])
def test_ln_mlp_residual_q8_mma_is_k16_chain(dev, rows):
    # the bf16 K17 runs K16's chain from LN2 on: K16 on ctx = 0, W_o = 0,
    # b_o = 0 and res = x has x1 = x.float(), and wherever the two LN2 row
    # passes give a row the same codes and scale (K16's sums LN2's
    # statistics in registers in another order, so a code on a rounding
    # boundary may move by one: the stage checks' rule), that row's mid,
    # ms, mq and output are K17's bit for bit
    bf = torch.bfloat16
    x, *mlp = _mlp_q8_args(dev, bf, rows, 768, 3072, "exact")
    zeros = torch.zeros_like(x)
    st16 = k16._out_ln_mlp_residual_q8_stages(zeros, x, torch.zeros(768, 768, dtype=bf, device=dev),
                                              torch.zeros(768, dtype=bf, device=dev), *mlp)
    st17 = k17._ln_mlp_residual_q8_stages(x, *mlp)
    assert torch.equal(st16["x1"], x.float())
    same = (st16["hq"] == st17["hq"]).all(-1) & (st16["hs"] == st17["hs"])
    flipped = (st16["hq"] != st17["hq"]).float().mean().item()
    assert flipped <= quant_stages.FLIP_SHARE and same.any()
    for k in ("mid", "ms", "mq", "out"):
        assert torch.equal(st16[k][same], st17[k][same]), k


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows,d,f", [(10, 64, 256), (591, 768, 3072), (133, 384, 1536)])
def test_ln_mlp_residual_q8(dev, dtype, variant, rows, d, f):
    args = _mlp_q8_args(dev, dtype, rows, d, f, variant)
    st = k17._ln_mlp_residual_q8_stages(*args)
    quant_stages.check_ln_mlp_residual_q8(st, k17.ln_mlp_residual_q8_plain(*args), *args)
    again = k17._ln_mlp_residual_q8_stages(*args)
    assert all(torch.equal(st[k], again[k]) for k in st)


@pytest.mark.cuda
def test_q8_zero_rows_and_ties(dev):
    # all-zero rows (zero gain and bias, zero W1 and b1) give codes 0 and
    # the floor scale at both quantizers, and the output b2 + x
    rows, d, f = 37, 64, 256
    x, _, _, w1q, w1s, b1, w2q, w2s, b2, eps, variant = _mlp_q8_args(dev, torch.float32, rows, d,
                                                                    f, "exact")
    zd = torch.zeros(d, device=dev)
    st = k17._ln_mlp_residual_q8_stages(x, zd, zd, torch.zeros_like(w1q), w1s, torch.zeros_like(b1),
                                        w2q, w2s, b2, eps, variant)
    for q, s in (("hq", "hs"), ("mq", "ms")):
        assert st[q].abs().max() == 0 and (st[s] == 1e-12).all()
    assert torch.equal(st["out"], b2 + x)
    # exact ties round half to even: LN's bias carries the values (gain 0),
    # the row's absmax 127 makes the scale exactly 1
    ties = torch.zeros(d, device=dev)
    ties[:7] = torch.tensor([127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5], device=dev)
    st = k17._ln_mlp_residual_q8_stages(x, zd, ties, w1q, w1s, b1, w2q, w2s, b2, eps, variant)
    assert st["hq"][:, :7].tolist() == [[127, 0, 2, 2, 0, -2, -2]] * rows
    assert (st["hs"] == 1).all()


@pytest.mark.cuda
def test_q8_wrappers_reject_what_the_kernels_do_not_take(dev):
    args = list(_k15_args(dev, torch.float32, 2, 5, 64, 4))
    with pytest.raises(TypeError, match="int8"):
        k15.ln_qkv_attn_q8(*args[:3], args[3].float(), *args[4:])
    with pytest.raises(TypeError, match="float32"):
        k15.ln_qkv_attn_q8(*args[:4], args[4].bfloat16(), *args[5:])
    with pytest.raises(ValueError, match="multiples of 16"):
        k15.ln_qkv_q8(args[0][:, :56].contiguous(), args[1][:56], args[2][:56],
                      args[3][:56].contiguous(), args[4], args[5], 1e-6)
    with pytest.raises(TypeError, match="mixed dtypes"):
        k15.ln_qkv_attn_q8(args[0].bfloat16(), *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("long", [False, True], ids=["short", "long_blocks"])
def test_quant_forward_launches_and_keeps_labels(dev, long, monkeypatch):
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import fused_block
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.ops.kernels import wrapper

    if long:
        monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    cfg = dataclasses.replace(VIT_B_16, depth=2, embed_dim=128, num_heads=2,
                              image_size=64, num_classes=11, name="vit_card_test")
    params = {k: v.to(dev) if torch.is_tensor(v) else {n: t.to(dev) for n, t in v.items()}
              for k, v in vit.init_params(torch.Generator().manual_seed(1), cfg).items()}
    x = torch.from_numpy(synth_images(3, cfg, seed=2)).to(dev)
    names = ("ln_qkv_attn_q8", "ln_qkv_q8", "flash_attention_fwd", "out_ln_mlp_residual_q8",
             "ln_mlp_residual_q8", "layer_norm", "ln_qkv_attn", "out_ln_mlp_residual")
    for name in names:
        wrapper(name).launches = 0
    got = vit.forward(quant.quantize_params(params), x, cfg, get_ops("quant"))
    want = (0, 2, 2, 2, 0, 1, 0, 0) if long else (2, 0, 0, 2, 0, 1, 0, 0)
    assert tuple(wrapper(name).launches for name in names) == want
    ref = vit.forward(params, x, cfg, get_ops("eager"))
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    # int8 noise over two layers: the JAX package's own bar for its tiny model
    assert (got - ref).abs().max().item() < 0.15


# -- token merging: the hooks of K1/K15/K6, K12b and K12c, the ToMe paths --------

# merged token counts of B/16 r = 13 (chunk 3 and chunk 2 schedules) and the
# ragged tails, at B/16 width; and a ViT-H/14-like dh 80
TOME_CASES = {"b3_t158": (3, 158, 768, 12), "b2_t41": (2, 41, 768, 12),
              "b3_t171_dh64": (3, 171, 768, 12), "h14_t257_dh80": (2, 257, 160, 2)}


def _log_size(dev, b, t):
    g = torch.Generator(device=dev).manual_seed(50)
    return torch.log(torch.randint(1, 6, (b, t), generator=g, device=dev).float())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(TOME_CASES))
def test_ln_qkv_attn_tome_hooks(dev, dtype, case):
    b, t, d, h = TOME_CASES[case]
    args = (_rn(dev, 0, b * t, d, scale=2.0, dtype=dtype),
            _rn(dev, 1, d, scale=0.2, shift=1.0, dtype=dtype), _rn(dev, 2, d, scale=0.2, dtype=dtype),
            _rn(dev, 3, d, 3 * d, scale=d ** -0.5, dtype=dtype),
            _rn(dev, 4, 3 * d, scale=0.1, dtype=dtype), h, t, 1e-6)
    ls = _log_size(dev, b, t)
    ctx, kmean = ln_qkv_attn(*args, log_size=ls, return_kmean=True)
    want_ctx, want_kmean = ln_qkv_attn_plain(*args, log_size=ls, return_kmean=True)
    _check(ctx, want_ctx)
    _check(kmean, want_kmean)
    # a zero bias adds exactly nothing; the hooks off are the plain kernel
    zero, _ = ln_qkv_attn(*args, log_size=torch.zeros_like(ls), return_kmean=True)
    assert torch.equal(zero, ln_qkv_attn(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(TOME_CASES))
def test_ln_qkv_attn_q8_tome_hooks(dev, dtype, case):
    b, t, d, h = TOME_CASES[case]
    args = _k15_args(dev, dtype, b, t, d, h)
    ls = _log_size(dev, b, t)
    st = k15._ln_qkv_attn_q8_stages(*args, ls, True)
    end = k15.ln_qkv_attn_q8_plain(*args, log_size=ls)
    report = quant_stages.check_ln_qkv_attn_q8(st, end, *args, ls, True)
    assert report["kmean"] == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(TOME_CASES))
def test_ln_qkv_attn_bwd_tome(dev, dtype, case):
    # K6 with the log-size bias and without the residual join
    b, t, d, h = TOME_CASES[case]
    dctx, _, *rest = _k6_args(dev, dtype, b, t, d, h)
    ls = _log_size(dev, b, t)
    _check_all(ln_qkv_attn_bwd(dctx, None, *rest, log_size=ls),
               ln_qkv_attn_bwd_plain(dctx, None, *rest, log_size=ls))


# -- the bf16 K6 on the tensor cores: the chain on csrc/gemm_mma.cuh and the
# attention backward on K14's register tiles (csrc/flash_bwd_mma.cuh) -------

# T at every 16-row warp edge and 64-row tile edge, and the 1,024 limit
K6_RAGGED_T = (1, 15, 16, 17, 63, 64, 65, 127, 128, 129, 1024)
HEAD_WIDTHS = (16, 32, 64, 80, 128)


def _k6_dh_args(dev, b, t, dh, heads=2):
    return _k6_args(dev, torch.bfloat16, b, t, heads * dh, heads)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", HEAD_WIDTHS)
@pytest.mark.parametrize("t", K6_RAGGED_T)
def test_ln_qkv_attn_bwd_mma_ragged(dev, t, dh):
    args = _k6_dh_args(dev, 1 if t == 1024 else 3, t, dh)
    _check_all(ln_qkv_attn_bwd(*args), ln_qkv_attn_bwd_plain(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("dh", HEAD_WIDTHS)
@pytest.mark.parametrize("t", [171, 41])
def test_ln_qkv_attn_bwd_mma_hooked(dev, t, dh):
    # ToMe's merged counts: the log-size bias, no residual join; a zero
    # bias is the unhooked kernel bit for bit
    b = 3
    dctx, _, *rest = _k6_dh_args(dev, b, t, dh)
    ls = _log_size(dev, b, t)
    _check_all(ln_qkv_attn_bwd(dctx, None, *rest, log_size=ls),
               ln_qkv_attn_bwd_plain(dctx, None, *rest, log_size=ls))
    zero = ln_qkv_attn_bwd(dctx, None, *rest, log_size=torch.zeros_like(ls))
    for a, b_ in zip(zero, ln_qkv_attn_bwd(dctx, None, *rest)):
        assert torch.equal(a, b_)


@pytest.mark.cuda
@pytest.mark.parametrize("hooked", [False, True], ids=["plain", "hooked"])
def test_ln_qkv_attn_bwd_mma_is_deterministic(dev, hooked):
    # each block owns its rows, no float atomics: two runs, the same bits
    b, t = 64, 197
    dctx, dres, *rest = _k6_args(dev, torch.bfloat16, b, t, 768, 12)
    kw = {"log_size": _log_size(dev, b, t)} if hooked else {}
    args = (dctx, None if hooked else dres, *rest)
    first = [x.clone() for x in ln_qkv_attn_bwd(*args, **kw)]
    for a, b_ in zip(first, ln_qkv_attn_bwd(*args, **kw)):
        assert torch.equal(a, b_)


@pytest.mark.cuda
def test_ln_qkv_attn_bwd_refuses_unaligned_operands(dev):
    bf = torch.bfloat16

    def off(*shape):  # contiguous, one element past the 16-byte grid
        n = int(np.prod(shape))
        return torch.zeros(n + 1, device=dev, dtype=bf)[1:].view(*shape)

    args = list(_k6_args(dev, bf, 2, 5, 64, 4))
    ln_qkv_attn_bwd(*args)  # aligned: runs
    for i, name in ((0, "dctx"), (2, "x"), (5, "wqkv")):
        bad = list(args)
        bad[i] = off(*args[i].shape)
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            ln_qkv_attn_bwd(*bad)
    # D = 60: x and the LN1 rows are not a whole number of 16-byte steps
    z = lambda *shape: torch.zeros(*shape, device=dev, dtype=bf)  # noqa: E731
    odd = (z(10, 64), z(10, 60), z(10, 60), z(60), z(60), z(60, 192), z(192), 4, 5, 1e-6)
    with pytest.raises(ValueError, match="x is 60 elements wide"):
        ln_qkv_attn_bwd(*odd)


def _k12_cases():
    return [(b * t, t) for b, t in ((3, 171), (2, 41), (64, 158))]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("p", [0.1, 0.5])
@pytest.mark.parametrize("rows,t", _k12_cases(), ids=["b3_t171", "b2_t41", "b64_t158"])
def test_split_regularized_backward(dev, dtype, p, rows, t):
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd_train as k12b
    from vit_tpu_torch.ops.kernels import out_residual_bwd_train as k12c

    d, f, seed = 768, 3072, 2 ** 31 + 5
    dp_a = drop_path_scale_rows(seed, 4, rows // t, t, 0.1, device=dev)
    dp_m = drop_path_scale_rows(seed, 5, rows // t, t, 0.1, device=dev)
    dy, x1, ctx, s, bn, w1, b1, w2, wo, *_ = _k7_args(dev, dtype, rows, d, f, "exact")
    a12b = (dy, x1, s, bn, w1, b1, w2, dp_m, seed, p, 1e-6, "exact")
    _check_all(k12b.ln_mlp_residual_bwd_train(*a12b), k12b.ln_mlp_residual_bwd_train_plain(*a12b))
    a12c = (dy, ctx, wo, dp_a, seed, p)
    _check_all(k12c.out_residual_bwd_train(*a12c), k12c.out_residual_bwd_train_plain(*a12c))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_split_regularized_backward_at_zero_rates_is_k8_k9(dev, dtype):
    from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd_train as k12b
    from vit_tpu_torch.ops.kernels import out_residual_bwd_train as k12c

    rows, d, f = 591, 768, 3072
    ones = torch.ones(rows, device=dev)
    dy, x1, ctx, s, bn, w1, b1, w2, wo, *_ = _k7_args(dev, dtype, rows, d, f, "exact")
    for a, b in zip(k12b.ln_mlp_residual_bwd_train(dy, x1, s, bn, w1, b1, w2, ones, 7, 0.0, 1e-6),
                    ln_mlp_residual_bwd(dy, x1, s, bn, w1, b1, w2, 1e-6)):
        assert torch.equal(a, b)
    for a, b in zip(k12c.out_residual_bwd_train(dy, ctx, wo, ones, 7, 0.0),
                    out_residual_bwd(dy, ctx, wo)):
        assert torch.equal(a, b)


def _tome_cfg():
    # 65 tokens, so the schedules merge (r = 4: [12, 0, 0] and [8, 0, 4])
    return dataclasses.replace(VIT_B_16, depth=3, embed_dim=128, num_heads=2, image_size=64,
                               patch_size=8, num_classes=11, name="vit_tome_card_test")


def _params_on(dev, cfg, seed=1):
    from vit_tpu_torch.models import vit

    return {k: v.to(dev) if torch.is_tensor(v) else {n: t.to(dev) for n, t in v.items()}
            for k, v in vit.init_params(torch.Generator().manual_seed(seed), cfg).items()}


@pytest.mark.cuda
def test_tome_forwards_launch_and_match_eager(dev):
    from vit_tpu_torch.eval import tome_stages
    from vit_tpu_torch.models import tome
    from vit_tpu_torch.ops.kernels import wrapper

    cfg = _tome_cfg()
    params = _params_on(dev, cfg)
    x = torch.from_numpy(synth_images(3, cfg, seed=2)).to(dev)
    names = ("ln_qkv_attn", "out_residual", "ln_mlp_residual", "out_ln_mlp_residual",
             "layer_norm", "ln_qkv_attn_q8", "ln_mlp_residual_q8", "out_ln_mlp_residual_q8")
    for name in names:
        wrapper(name).launches = 0
    report = tome_stages.check_against_eager(tome.forward_fused, params, x, cfg, 4, 2.0 ** -16,
                                             1e-4)
    assert report["merges"] == 1
    assert tuple(wrapper(n).launches for n in names) == (3, 3, 3, 0, 0, 0, 0, 0)
    got = tome.forward_quant(quant.quantize_params(params), x, cfg, 4)
    assert tuple(wrapper(n).launches for n in names) == (3, 6, 3, 0, 0, 3, 3, 0)  # K4 again
    ref = tome.forward_eager(params, x, cfg, 4)
    assert torch.equal(got.argmax(-1), ref.argmax(-1))
    assert (got - ref).abs().max().item() < 0.15  # int8 noise, as the plain quant test


@pytest.mark.cuda
@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "dropout_droppath"])
def test_tome_train_grads_match_eager_autograd(dev, regularized):
    from vit_tpu_torch.models import tome
    from vit_tpu_torch.ops.kernels import wrapper
    from vit_tpu_torch.runtime import trainer

    cfg = _tome_cfg()
    if regularized:
        cfg = dataclasses.replace(cfg, dropout=0.1, drop_path=0.1)
    x = torch.from_numpy(synth_images(3, cfg, seed=2)).to(dev)
    weight = _rn(dev, 60, 3, cfg.num_classes)
    counts = tome.schedule(cfg, 4, tome.TRAIN_MERGE_CHUNK)

    def grads(fn):
        params = trainer.as_trainable(_params_on(dev, cfg), dev)
        rng = torch.Generator().manual_seed(3) if regularized else None
        (fn(params, x, cfg, 4, counts=counts, dropout_rng=rng) * weight).sum().backward()
        return dict(enumerate(t.grad for t in trainer.leaves(params)))

    names = ("ln_qkv_attn", "ln_qkv_attn_bwd", "out_residual", "out_residual_bwd",
             "ln_mlp_residual", "ln_mlp_residual_bwd", "out_residual_train",
             "out_residual_bwd_train", "ln_mlp_residual_train", "ln_mlp_residual_bwd_train")
    for name in names:
        wrapper(name).launches = 0
    got = grads(tome.forward_train)
    want = (3, 3, 0, 0, 0, 0, 3, 3, 3, 3) if regularized else (3, 3, 3, 3, 3, 3, 0, 0, 0, 0)
    assert tuple(wrapper(n).launches for n in names) == want
    # the merge on the card: same k-mean, same matching (3 images, fp32)
    for k, w in grads(tome.forward_eager).items():
        err, bound = (got[k] - w).abs().max().item(), 1e-3 * max(1.0, w.abs().max().item())
        assert err <= bound, f"leaf {k}: max|d| {err} > {bound}"


# -- the per-op tier (K21, K22) and the fused AdamW (K20) ----------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,t,d,h", [(2, 29, 48, 3), (3, 197, 768, 12), (2, 100, 256, 2), (2, 257, 160, 2)],
    ids=["tiny_dh16", "b16_t197", "t100_dh128", "h14_t257_dh80"],
)
def test_scaled_dot_product_attention_packed_views(dev, dtype, b, t, d, h):
    from vit_tpu_torch.ops.flash_attention import packed_views
    from vit_tpu_torch.ops.kernels import attention as k21

    qkv = _rn(dev, 0, b * t, 3 * d, scale=2.0, dtype=dtype)
    q, k, v = packed_views(qkv, b, t, h, 3)  # strided, as the per-op attention calls it
    ctx = torch.zeros(b * t, d, dtype=dtype, device=dev)
    out = packed_views(ctx, b, t, h, 1)[0]
    k21.scaled_dot_product_attention.launches = 0
    assert k21.scaled_dot_product_attention(q, k, v, out=out) is out
    assert k21.scaled_dot_product_attention.launches == 1
    _check(out, k21.scaled_dot_product_attention_plain(q, k, v))
    # separate contiguous q, k, v with a leading shape, into a new output
    q5, k5, v5 = (x.contiguous().reshape(1, b, h, t, d // h) for x in (q, k, v))
    _check(k21.scaled_dot_product_attention(q5, k5, v5),
           k21.scaled_dot_product_attention_plain(q5, k5, v5))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("dh", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("t", [1, 15, 17, 63, 65, 197, 577, 1024])
def test_scaled_dot_product_attention_ragged(dev, dtype, dh, t):
    # T around every 16-row warp edge and 64-row tile edge, up to the switch
    # to K13, at every head width, on strided views of a packed QKV
    from vit_tpu_torch.ops.flash_attention import packed_views
    from vit_tpu_torch.ops.kernels import attention as k21

    b, h = 2, 2
    qkv = _rn(dev, t + dh, b * t, 3 * h * dh, scale=2.0, dtype=dtype)
    q, k, v = packed_views(qkv, b, t, h, 3)
    ctx = torch.zeros(b * t, h * dh, dtype=dtype, device=dev)
    out = packed_views(ctx, b, t, h, 1)[0]
    launches = k21.scaled_dot_product_attention.launches
    k21.scaled_dot_product_attention(q, k, v, out=out)
    assert k21.scaled_dot_product_attention.launches == launches + 1
    _check(out, k21.scaled_dot_product_attention_plain(q, k, v))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_scaled_dot_product_attention_extreme_logits(dev, dtype):
    # scores near 30^2 * 64 / 8 must stay finite; fp32 held to 2^-10 as in
    # test_flash_attention_fwd_extreme_logits (an fp32 ulp of such a score
    # reaches p through exp)
    from vit_tpu_torch.ops.kernels import attention as k21

    q, k, v = _qkv4(dev, dtype, 2, 2, 197, 64)
    q, k = q * 30, k * 30
    out = k21.scaled_dot_product_attention(q, k, v)
    want = k21.scaled_dot_product_attention_plain(q, k, v)
    assert torch.isfinite(out).all()
    tol = {torch.float32: 2.0 ** -10, torch.bfloat16: REL_TOL[torch.bfloat16]}[dtype]
    err = (out.float() - want.float()).abs().max().item()
    assert err <= tol * max(1.0, want.float().abs().max().item()), err


@pytest.mark.cuda
def test_scaled_dot_product_attention_refuses_unaligned_views(dev):
    from vit_tpu_torch.ops.flash_attention import packed_views
    from vit_tpu_torch.ops.kernels import attention as k21

    b, h, t, dh = 2, 2, 40, 64
    flat = _rn(dev, 66, b * h * t * dh + 8, dtype=torch.bfloat16)
    x = flat[:b * h * t * dh].view(b, h, t, dh)
    shifted = flat[4:4 + b * h * t * dh].view(b, h, t, dh)  # base 8 bytes off
    with pytest.raises(ValueError, match="k must start on a 16-byte boundary"):
        k21.scaled_dot_product_attention(x, shifted, x)
    wide = _rn(dev, 67, b * t, 3 * h * dh + 2, dtype=torch.bfloat16)  # token stride 772 bytes
    q, k, v = packed_views(wide[:, :3 * h * dh], b, t, h, 3)
    with pytest.raises(ValueError, match="q must start on a 16-byte boundary"):
        k21.scaled_dot_product_attention(q, k, v)
    out = torch.empty(b, t, h, dh + 1, dtype=torch.bfloat16, device=dev)[..., :dh]
    with pytest.raises(ValueError, match="out must start on a 16-byte boundary"):
        k21.scaled_dot_product_attention(x, x, x, out=out.permute(0, 2, 1, 3))


@pytest.mark.cuda
def test_scaled_dot_product_attention_rejects_what_it_does_not_take(dev):
    from vit_tpu_torch.ops.kernels import attention as k21

    x = torch.zeros(1, 2, 5, 48, device=dev)  # head width 48
    with pytest.raises(ValueError, match="head_dim"):
        k21.scaled_dot_product_attention(x, x, x)
    y = torch.zeros(1, 2, 16, 5, device=dev).transpose(-1, -2)  # dh not contiguous
    with pytest.raises(ValueError, match="contiguous last axis"):
        k21.scaled_dot_product_attention(y, y, y)
    with pytest.raises(TypeError, match="mixed dtypes"):
        k21.scaled_dot_product_attention(x[..., :16], x[..., :16], x[..., :16].bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("shape,f", [((67, 64), 256), ((3, 197, 768), 3072), ((591, 384), 1536)],
                         ids=["r67", "b3_t197", "r591"])
def test_mlp(dev, dtype, variant, shape, f):
    from vit_tpu_torch.ops.kernels import mlp as k22

    d = shape[-1]
    args = (_rn(dev, 0, *shape, scale=2.0, dtype=dtype),
            _rn(dev, 1, d, f, scale=d ** -0.5, dtype=dtype), _rn(dev, 2, f, scale=0.1, dtype=dtype),
            _rn(dev, 3, f, d, scale=f ** -0.5, dtype=dtype), _rn(dev, 4, d, scale=0.1, dtype=dtype))
    k22.mlp.launches = 0
    _check(k22.mlp(*args, gelu_variant=variant), k22.mlp_plain(*args, gelu_variant=variant))
    assert k22.mlp.launches == 1


def _off_grid(t):
    """The same values, contiguous, one element past the 16-byte grid."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)[1:]
    return flat.copy_(t.reshape(-1)).view(t.shape)


def _k22_args(dev, dtype, shape, f):
    d = shape[-1]
    return (_rn(dev, 0, *shape, scale=2.0, dtype=dtype),
            _rn(dev, 1, d, f, scale=d ** -0.5, dtype=dtype), _rn(dev, 2, f, scale=0.1, dtype=dtype),
            _rn(dev, 3, f, d, scale=f ** -0.5, dtype=dtype), _rn(dev, 4, d, scale=0.1, dtype=dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows", [1, 127, 128, 129, 591, 19700], ids=lambda r: f"rows{r}")
def test_mlp_mma_rows(dev, variant, rows):
    # the bf16 K22 on the TMA + wgmma core at B/16 widths: one row, a row
    # short of and past a 128-row tile, batch 3 and batch 100 (the per-op
    # forward's 19,700 rows); two runs give the same bits
    from vit_tpu_torch.ops.kernels import mlp as k22

    args = _k22_args(dev, torch.bfloat16, (rows, 768), 3072)
    got = k22.mlp(*args, gelu_variant=variant)
    _check(got, k22.mlp_plain(*args, gelu_variant=variant))
    assert torch.equal(got, k22.mlp(*args, gelu_variant=variant))


@pytest.mark.cuda
def test_mlp_refuses_unaligned_operands(dev):
    # bf16 K22 reads x, w1 and w2 through TMA tensor maps: an operand off
    # the 16-byte grid, or D or F not a multiple of 8, raises before any
    # launch (no fallback to the FMA core, the twin or the CPU)
    from vit_tpu_torch.ops.kernels import mlp as k22

    args = _k22_args(dev, torch.bfloat16, (10, 64), 256)
    k22.mlp(*args)
    for i, name in ((0, "x"), (1, "w1"), (3, "w2")):
        bad = (*args[:i], _off_grid(args[i]), *args[i + 1:])
        with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
            k22.mlp(*bad)
    for d, f in ((60, 256), (64, 252)):
        with pytest.raises(ValueError, match="multiples of 8"):
            k22.mlp(*_k22_args(dev, torch.bfloat16, (10, d), f))


def _adamw_leaves(dev, p_dtype, g_dtype, seed):
    """Leaves of 1,000 (not a multiple of the TPU's 128), 768 (small), 2^15
    and 105 (odd) elements, and one of 1,000 that starts one element into
    its memory (a contiguous view at an offset)."""
    shapes = [(1000,), (768,), (64, 512), (3, 5, 7), (1001,)]

    def leaf(seed, shape, **kw):
        t = _rn(dev, seed, *shape, **kw)
        return t[1:] if shape == (1001,) else t

    p = [leaf(seed + i, s, dtype=p_dtype) for i, s in enumerate(shapes)]
    mu = [leaf(seed + 10 + i, s, scale=0.1) for i, s in enumerate(shapes)]
    nu = [leaf(seed + 20 + i, s, scale=0.1).abs() for i, s in enumerate(shapes)]
    return p, mu, nu, [leaf(seed + 30 + i, s, dtype=g_dtype) for i, s in enumerate(shapes)]


@pytest.mark.cuda
@pytest.mark.parametrize("p_dtype,g_dtype", [(torch.float32, torch.float32),
                                             (torch.bfloat16, torch.bfloat16),
                                             (torch.float32, torch.bfloat16)])
def test_adamw_update(dev, p_dtype, g_dtype):
    """Three steps against the twin on the same tensors: p, mu and nu within
    2^-20 of each leaf's largest value (fp32; only FMA contraction differs)
    and, for a bf16 p, one bf16 rounding of p."""
    from vit_tpu_torch.ops.kernels import adamw as k20

    p, mu, nu, g = _adamw_leaves(dev, p_dtype, g_dtype, 0)
    wp, wm, wv = ([t.clone() for t in ts] for ts in (p, mu, nu))
    k20.adamw_update.launches = 0
    for step in (1, 2, 3):
        k20.adamw_update(g, p, mu, nu, step, 1e-3, weight_decay=0.05)
        k20.adamw_update_plain(g, wp, wm, wv, step, 1e-3, weight_decay=0.05)
    assert k20.adamw_update.launches == 3  # one table of every leaf, one launch a step
    _check_adamw((*p, *mu, *nu), (*wp, *wm, *wv))


def _check_adamw(got, want):
    """p, mu and nu within 2^-20 of each leaf's largest value (fp32; only FMA
    contraction differs), a bf16 p within one bf16 rounding."""
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        rel = 2.0 ** -20 if a.dtype == torch.float32 else 2.0 ** -7
        err = (a.float() - b.float()).abs().max().item()
        assert err <= rel * max(1.0, b.float().abs().max().item()), err


@pytest.mark.cuda
def test_adamw_update_one_launch_per_dtype_group(dev):
    # leaves of three (p, g) dtype pairs, interleaved: three launches a step,
    # every leaf against the twin
    from vit_tpu_torch.ops.kernels import adamw as k20

    pairs = [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
             (torch.float32, torch.bfloat16)]
    leaves = [_adamw_leaves(dev, pd, gd, 10 * i) for i, (pd, gd) in enumerate(pairs)]
    p, mu, nu, g = ([t for i in range(5) for lv in leaves for t in lv[j][i:i + 1]]
                    for j in range(4))
    wp, wm, wv = ([t.clone() for t in ts] for ts in (p, mu, nu))
    k20.adamw_update.launches = 0
    for step in (1, 2):
        k20.adamw_update(g, p, mu, nu, step, 1e-3, weight_decay=0.05)
        k20.adamw_update_plain(g, wp, wm, wv, step, 1e-3, weight_decay=0.05)
    assert k20.adamw_update.launches == 2 * len(pairs)
    _check_adamw((*p, *mu, *nu), (*wp, *wm, *wv))


@pytest.mark.cuda
def test_adamw_update_past_one_table(dev):
    # more leaves than one table holds: ceil(n / TABLE_LEAVES) launches, of
    # aligned and offset leaves of ragged lengths, against the twin
    from vit_tpu_torch.ops.kernels import adamw as k20

    n = k20.TABLE_LEAVES + 5

    def leaf(i, part, scale=1.0):  # 4,103 + 37 i elements, one in for some operands
        t = _rn(dev, 100 + 4 * i + part, 4104 + 37 * i, scale=scale)
        return t[1:] if (i + part) % 3 == 0 else t[:-1]

    p = [leaf(i, 0) for i in range(n)]
    mu = [leaf(i, 1, 0.1) for i in range(n)]
    nu = [leaf(i, 2, 0.1).abs() for i in range(n)]
    g = [leaf(i, 3) for i in range(n)]
    wp, wm, wv = ([t.clone() for t in ts] for ts in (p, mu, nu))
    k20.adamw_update.launches = 0
    k20.adamw_update(g, p, mu, nu, 1, 1e-3, weight_decay=0.05)
    k20.adamw_update_plain(g, wp, wm, wv, 1, 1e-3, weight_decay=0.05)
    assert k20.adamw_update.launches == 2
    _check_adamw((*p, *mu, *nu), (*wp, *wm, *wv))


@pytest.mark.cuda
def test_adamw_update_rejects_what_it_does_not_take(dev):
    from vit_tpu_torch.ops.kernels import adamw as k20

    p = torch.zeros(8, 4, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        k20.adamw_update([p.t()], [p.t()], [p.t()], [p.t()], 1, 1e-3)
    with pytest.raises(TypeError, match="float32"):
        k20.adamw_update([p], [p], [p.bfloat16()], [p], 1, 1e-3)


@pytest.mark.cuda
def test_per_op_forward_launches_and_matches_eager(dev):
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.ops.kernels import wrapper

    cfg = dataclasses.replace(VIT_B_16, depth=2, embed_dim=128, num_heads=2,
                              image_size=64, num_classes=11, name="vit_card_test")
    params = _params_on(dev, cfg)
    x = torch.from_numpy(synth_images(3, cfg, seed=2)).to(dev)
    names = ("layer_norm", "scaled_dot_product_attention", "mlp", "ln_qkv_attn",
             "out_ln_mlp_residual", "flash_attention_fwd")
    for name in names:
        wrapper(name).launches = 0
    with torch.inference_mode():
        got = vit.forward(params, x, cfg, get_ops("per_op"))
        want = vit.forward(params, x, cfg, get_ops("eager"))
    assert tuple(wrapper(n).launches for n in names) == (5, 2, 2, 0, 0, 0)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_fused_adamw_step_launches_per_leaf(dev):
    from vit_tpu_torch.ops.dispatch import get_ops
    from vit_tpu_torch.ops.kernels import adamw as k20
    from vit_tpu_torch.runtime import trainer

    cfg = dataclasses.replace(VIT_B_16, depth=2, embed_dim=128, num_heads=2,
                              image_size=64, num_classes=11, name="vit_card_test")
    x = torch.from_numpy(synth_images(4, cfg, seed=2)).to(dev)
    y = torch.arange(4, device=dev)
    runs = {}
    for name in ("fused", "plain"):
        params = trainer.as_trainable(_params_on(dev, cfg), dev)
        if name == "fused":
            opt = trainer.FusedAdamW(list(trainer.leaves(params)), lr=1e-3, weight_decay=0.05)
        else:
            opt = torch.optim.AdamW(list(trainer.leaves(params)), lr=1e-3, weight_decay=0.05)
        step = trainer.make_train_step(cfg, opt, get_ops("fused_train"), remat=False)
        k20.adamw_update.launches = 0
        losses = [float(step(params, x, y)) for _ in range(3)]
        runs[name] = (losses, k20.adamw_update.launches)
    assert runs["fused"][1] == 3 and runs["plain"][1] == 0  # 20 leaves, one launch a step
    np.testing.assert_allclose(runs["fused"][0], runs["plain"][0], atol=1e-4, rtol=0)


# -- tensor parallelism (K5's partial form, K18) and the int8-attention study (K19) --

# ViT-B/16's shard widths at tp = 2 and 4 (F/tp hidden columns, heads/tp
# heads), and a tiny one
TP_SHAPES = {"b16_tp2": (591, 768, 1536, 6), "b16_tp4": (591, 768, 768, 3),
             "tiny_tp2": (10, 64, 128, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("shape", list(TP_SHAPES))
def test_ln_mlp_residual_partial(dev, dtype, variant, shape):
    from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_partial_plain

    rows, d, f, _ = TP_SHAPES[shape]
    x, s, b, w1, b1, w2, b2 = _mlp_args(dev, dtype, rows, d, f)
    got = ln_mlp_residual(x, s, b, w1, b1, w2, b2, 1e-6, variant, partial=True)
    assert got.dtype == torch.float32
    # the bf16 kernel rounds g at the twin's points: its tolerance is bf16's
    _check(got, ln_mlp_partial_plain(x, s, b, w1, b1, w2, 1e-6, variant), dtype)
    # the block's form on the same operands is the partial + b2 + x, rounded
    whole = ln_mlp_residual(x, s, b, w1, b1, w2, b2, 1e-6, variant)
    _check(whole, (got + b2.float() + x.float()).to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", list(TP_SHAPES))
def test_k18_kernels_at_shard_shapes(dev, dtype, shape):
    from vit_tpu_torch.ops.kernels import fc2_q8_partial as k18b
    from vit_tpu_torch.ops.kernels import ln_fc1_gelu_q8 as k18a

    rows, d, f, _ = TP_SHAPES[shape]
    x, s, b, w1q, w1s, b1, w2q, *_ = _mlp_q8_args(dev, dtype, rows, d, f, "exact")
    for fast_erf in (False, True):
        args = (x, s, b, w1q, w1s, b1, 1e-6, "exact", fast_erf)
        st = k18a._ln_fc1_gelu_q8_stages(*args)
        quant_stages.check_ln_fc1_gelu_q8(st, k18a.ln_fc1_gelu_q8_plain(*args), *args)
    mid = st["mid"]
    ms = torch.clamp(mid.abs().amax(-1, keepdim=True) / torch.full((1, 1), 127.0, device=dev),
                     min=1e-12)
    st2 = k18b._fc2_q8_partial_stages(mid, ms, w2q)
    quant_stages.check_fc2_q8_partial(st2, k18b.fc2_q8_partial_plain(mid, ms, w2q), mid, ms, w2q)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tp", [2, 4])
def test_k18_composed_over_shards_is_k17(dev, dtype, tp):
    """K18a per shard, the row maxima's maximum, K18b per shard and the int32
    sum over shards, in one process: K17's stages bit for bit, the output
    within one rounding of the dtype."""
    from vit_tpu_torch.ops.kernels.fc2_q8_partial import fc2_q8_partial
    from vit_tpu_torch.ops.kernels.ln_fc1_gelu_q8 import ln_fc1_gelu_q8

    rows, d, f = 591, 768, 3072
    x, s, b, w1q, w1s, b1, w2q, w2s, b2, eps, variant = _mlp_q8_args(dev, dtype, rows, d, f,
                                                                    "exact")
    st = k17._ln_mlp_residual_q8_stages(x, s, b, w1q, w1s, b1, w2q, w2s, b2, eps, variant)
    cols = [slice(r * f // tp, (r + 1) * f // tp) for r in range(tp)]
    fast = dtype == torch.bfloat16
    mids = [ln_fc1_gelu_q8(x, s, b, w1q[:, c].contiguous(), w1s[c].contiguous(),
                           b1[c].contiguous(), eps, variant, fast_erf=fast) for c in cols]
    assert torch.equal(torch.cat(mids, 1), st["mid"])
    mmax = torch.stack([m.abs().amax(-1, keepdim=True) for m in mids]).amax(0)
    ms = torch.clamp(mmax / torch.full_like(mmax, 127.0), min=1e-12)
    assert torch.equal(ms[:, 0], st["ms"])
    acc = sum(fc2_q8_partial(m, ms, w2q[c].contiguous()) for m, c in zip(mids, cols))
    assert torch.equal(acc, quant.int8_dot(st["mq"], w2q).to(torch.int32))
    out = ((acc.float() * ms * w2s + b2.float()) + x.float()).to(dtype)
    ulp = 2.0 ** (-23 if dtype == torch.float32 else -7)  # one rounding of the dtype
    assert ((out.float() - st["out"].float()).abs()
            <= ulp * st["out"].float().abs().clamp(min=1.0)).all()


def _k18_shard(dev, rows, d, f):
    """The bf16 K18a's operands at a shard width f = F/tp (fast erf, the
    tensor-parallel MLP's form), and K18b's W2q rows of that shard."""
    x, s, b, w1q, w1s, b1, w2q, *_ = _mlp_q8_args(dev, torch.bfloat16, rows, d, f, "exact")
    return (x, s, b, w1q, w1s, b1, 1e-6, "exact", True), w2q


def _row_scales(mid):
    mmax = mid.abs().amax(-1, keepdim=True)
    return torch.clamp(mmax / torch.full_like(mmax, 127.0), min=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(TP_SHAPES))
def test_k18_kmajor_copies_and_two_runs(dev, shape):
    # the bf16 K18a and K18b read this shard's W1q and W2q through K-major
    # copies (their transposes), and give the same bits in two runs
    from vit_tpu_torch.ops.kernels import fc2_q8_partial as k18b
    from vit_tpu_torch.ops.kernels import ln_fc1_gelu_q8 as k18a

    rows, d, f, _ = TP_SHAPES[shape]
    a18a, w2q = _k18_shard(dev, rows, d, f)
    st = [k18a._ln_fc1_gelu_q8_stages(*a18a) for _ in range(2)]
    assert torch.equal(st[0]["w1t"], a18a[3].t().contiguous())
    mid = st[0]["mid"]
    ms = _row_scales(mid)
    st2 = [k18b._fc2_q8_partial_stages(mid, ms, w2q) for _ in range(2)]
    assert torch.equal(st2[0]["w2t"], w2q.t().contiguous())
    for a, b in (st, st2):
        assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    # fp32 keeps the WMMA core: no K-major copy
    x32 = (a18a[0].float(), *(t.float() for t in a18a[1:3]), *a18a[3:5], a18a[5].float())
    assert "w1t" not in k18a._ln_fc1_gelu_q8_stages(*x32, *a18a[6:])


@pytest.mark.cuda
@pytest.mark.parametrize("fast_erf", [False, True], ids=["erf", "fast_erf"])
@pytest.mark.parametrize("rows", [19700, 123, 1])
def test_k18a_bf16_is_the_wmma_design(dev, rows, fast_erf):
    # the bf16 K18a at B/16 b100 tp 2's shard (F/tp 1,536) and ragged rows:
    # its stages against the twin's, and hq, hs and mid bit for bit those
    # of the fp32 K18a (gemm_q8.cuh's WMMA core, the first design) on the
    # same values widened: the int32 sums are exact and the epilogue the
    # same functor
    from vit_tpu_torch.ops.kernels import ln_fc1_gelu_q8 as k18a

    a18a, _ = _k18_shard(dev, rows, 768, 1536)
    args = (*a18a[:8], fast_erf)
    st = k18a._ln_fc1_gelu_q8_stages(*args)
    quant_stages.check_ln_fc1_gelu_q8(st, k18a.ln_fc1_gelu_q8_plain(*args), *args)
    wide = (args[0].float(), args[1].float(), args[2].float(), *args[3:5], args[5].float(),
            *args[6:])
    st32 = k18a._ln_fc1_gelu_q8_stages(*wide)
    for k in ("hq", "hs", "mid"):
        assert torch.equal(st[k], st32[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("rows", [1, 123, 591, 19700])
def test_k18b_codes_and_sums_are_the_twins(dev, tp, rows):
    # K18b at B/16 shard widths and ragged rows: codes and int32 sums bit
    # for bit the twin's, on a mid with exact ties and a row of zeros
    from vit_tpu_torch.ops.kernels import fc2_q8_partial as k18b

    f = 3072 // tp
    mid = _rn(dev, 11, rows, f, scale=0.7)
    mid[0] = ((torch.arange(f, device=dev) % 254).float() - 126.5) * 2.0 ** -7
    mid[0, 0] = 127 * 2.0 ** -7  # row 0's scale is 2^-7: its other values are ties
    if rows > 1:
        mid[-1] = 0
    ms = _row_scales(mid)
    w2q, _ = _q8_weight(dev, 12, f, 768)
    st = k18b._fc2_q8_partial_stages(mid, ms, w2q)
    quant_stages.check_fc2_q8_partial(st, k18b.fc2_q8_partial_plain(mid, ms, w2q), mid, ms, w2q)


@pytest.mark.cuda
def test_k18_wrappers_refuse_off_grid_operands(dev):
    from vit_tpu_torch.ops.kernels import fc2_q8_partial as k18b
    from vit_tpu_torch.ops.kernels import ln_fc1_gelu_q8 as k18a

    a18a, w2q = _k18_shard(dev, 10, 64, 128)
    mid = k18a.ln_fc1_gelu_q8(*a18a)
    ms = _row_scales(mid)
    launches = (k18a.ln_fc1_gelu_q8.launches, k18b.fc2_q8_partial.launches)

    def off(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)[1:].view(*t.shape).copy_(t)

    with pytest.raises(ValueError, match="ln_fc1_gelu_q8: .*16-byte aligned"):
        k18a.ln_fc1_gelu_q8(*a18a[:3], off(a18a[3]), *a18a[4:])
    with pytest.raises(ValueError, match="ln_fc1_gelu_q8: .*multiples of 16"):
        k18a.ln_fc1_gelu_q8(*a18a[:3], a18a[3][:, :120].contiguous(), a18a[4][:120].contiguous(),
                            a18a[5][:120].contiguous(), *a18a[6:])
    with pytest.raises(ValueError, match="fc2_q8_partial: mid must start on a 16-byte"):
        k18b.fc2_q8_partial(off(mid), ms, w2q)
    with pytest.raises(ValueError, match="fc2_q8_partial: mid must be a contiguous float32"):
        k18b.fc2_q8_partial(mid.bfloat16(), ms, w2q)
    with pytest.raises(ValueError, match="fc2_q8_partial: .*16-byte aligned"):
        k18b.fc2_q8_partial(mid, ms, off(w2q))
    assert (k18a.ln_fc1_gelu_q8.launches, k18b.fc2_q8_partial.launches) == launches


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tp", [2, 4])
def test_k1_k15_at_local_heads(dev, dtype, tp):
    """K1 and K15 over a tp shard's whole heads (d3 = 3D/tp, the context
    D/tp wide): each rank's columns of the whole attention context."""
    b, t, d, h = 3, 197, 768, 12
    x = _rn(dev, 0, b * t, d, scale=2.0, dtype=dtype)
    s, bb = _rn(dev, 1, d, scale=0.2, shift=1.0, dtype=dtype), _rn(dev, 2, d, scale=0.2, dtype=dtype)
    w = _rn(dev, 3, d, 3 * d, scale=d ** -0.5, dtype=dtype)
    bq = _rn(dev, 4, 3 * d, scale=0.1, dtype=dtype)
    wq, ws = _q8_weight(dev, 5, d, 3 * d)
    cols = 3 * d // tp
    for r in range(tp):
        c = slice(r * cols, (r + 1) * cols)
        local = (x, s, bb, w[:, c].contiguous(), bq[c].contiguous(), h // tp, t, 1e-6)
        got = ln_qkv_attn(*local)
        assert got.shape == (b * t, d // tp)
        _check(got, ln_qkv_attn_plain(*local))
        args = (x, s, bb, wq[:, c].contiguous(), ws[c].contiguous(), bq[c].contiguous(), h // tp,
                t, 1e-6)
        st = k15._ln_qkv_attn_q8_stages(*args)
        quant_stages.check_ln_qkv_attn_q8(st, k15.ln_qkv_attn_q8_plain(*args), *args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("quant_pv", [True, False], ids=["q8_pv", "dtype_pv"])
@pytest.mark.parametrize(
    "b,t,d,h", [(2, 5, 64, 4), (3, 197, 768, 12), (2, 65, 256, 8), (1, 77, 768, 6),
                (2, 257, 160, 2), (3, 1, 128, 2), (2, 129, 256, 4)],
    ids=["tiny_dh16", "b16_t197", "t65_dh32", "wide_dh128", "h14_t257_dh80", "t1_dh64",
         "t129_dh64"],
)
def test_ln_qkv_attn_q8a(dev, dtype, quant_pv, b, t, d, h):
    args = _k15_args(dev, dtype, b, t, d, h)
    st = k15._ln_qkv_attn_q8a_stages(*args, quant_pv=quant_pv, return_p=True)
    quant_stages.check_ln_qkv_attn_q8a(st, k15.ln_qkv_attn_q8a_plain(*args, quant_pv=quant_pv),
                                       *args, quant_pv=quant_pv)
    again = k15._ln_qkv_attn_q8a_stages(*args, quant_pv=quant_pv)
    assert torch.equal(st["ctx"], again["ctx"])  # the p codes' write changes nothing
    assert torch.equal(st["qkv"], k15._ln_qkv_attn_q8_stages(*args)["qkv"])  # K15's stages 1-2
    with pytest.raises(ValueError, match="no ToMe hooks"):
        k15.ln_qkv_attn_q8a(*args, log_size=_log_size(dev, b, t))


@pytest.mark.cuda
@pytest.mark.parametrize("quant_pv", [True, False], ids=["q8_pv", "dtype_pv"])
def test_ln_qkv_attn_q8a_bf16_kernels(dev, quant_pv):
    # the bf16 K19 runs K15's stages 1-2 (the K-major copy, the row codes,
    # the int8 TMA + wgmma core), the vectorized code passes and the
    # mma.sync s8 attention; none of the WMMA GEMM, the one-thread code
    # passes or the __dp4a tiles the fp32 form keeps
    args = _k15_args(dev, torch.bfloat16, 3, 197, 768, 12)
    names = " ".join(sorted(_kernel_names(lambda: k15.ln_qkv_attn_q8a(*args, quant_pv=quant_pv))))
    for want in ("transpose_q8_kernel", "ln_quant_rows_kernel", "gemm_mma_q8_kernel",
                 "quant_qk_vec_kernel", "attention_s8_kernel"):
        assert want in names, names
    assert ("quant_v_vec_kernel" in names) == quant_pv
    for old in ("gemm_q8_kernel", "quant_qk_kernel", "quant_v_kernel", "attention_q8_kernel"):
        assert old not in names, names


@pytest.mark.cuda
def test_ln_qkv_attn_q8a_rejects_off_grid_wq(dev):
    args = list(_k15_args(dev, torch.bfloat16, 2, 5, 64, 4))
    wq = args[3]
    args[3] = torch.empty(wq.numel() + 1, dtype=torch.int8, device=dev)[1:].view(
        wq.shape).copy_(wq)
    launches = k15.ln_qkv_attn_q8a.launches
    with pytest.raises(ValueError, match="ln_qkv_attn_q8a: .*16-byte aligned"):
        k15.ln_qkv_attn_q8a(*args)
    assert k15.ln_qkv_attn_q8a.launches == launches


# -- serving: the InferenceServer on the card ----------------------------------


def _serving_engine(dev, ops):
    from vit_tpu_torch.io.params import params_to_numpy
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = dataclasses.replace(VIT_B_16, depth=2, embed_dim=128, num_heads=2,
                              image_size=64, num_classes=11, name="vit_card_test")
    tree = params_to_numpy(vit.init_params(torch.Generator().manual_seed(1), cfg))
    return cfg, InferenceEngine(cfg, tree, "float32", ops, dev, batch_pad=8)


@pytest.mark.cuda
@pytest.mark.parametrize("ops", ["fused", "quant"])
def test_server_answers_match_engine(dev, ops, monkeypatch):
    """Coalesced requests, numpy and device-resident, through the two-stage
    pipeline (depth 2): each answer is the engine's classify of that request
    alone, and no host synchronization runs while the server serves (the
    completer waits on each batch's own event)."""
    from vit_tpu_torch.runtime import serving

    cfg, eng = _serving_engine(dev, ops)
    sizes = [int(n) for n in np.random.default_rng(0).integers(1, 9, 24)]
    reqs = [synth_images(n, cfg, seed=i) for i, n in enumerate(sizes)]
    want = [eng.classify(r) for r in reqs]
    staged = [torch.from_numpy(r).to(dev) if i % 2 else r for i, r in enumerate(reqs)]
    srv = serving.InferenceServer(eng, max_batch=16, max_delay_ms=5.0, pipeline_depth=2)
    srv.warmup()

    def refuse(*a, **k):
        raise AssertionError("a host synchronization while serving")

    with srv:
        monkeypatch.setattr(torch.cuda, "synchronize", refuse)
        monkeypatch.setattr(torch.Tensor, "cpu", refuse)
        monkeypatch.setattr(torch.Tensor, "item", refuse)
        futures = [srv.submit(r, return_probs=(i % 3 == 0)) for i, r in enumerate(staged)]
        got = [f.result(timeout=120) for f in futures]
        monkeypatch.undo()
    assert srv.stats.batches < len(reqs) and srv._pending == 0
    for i, ((labels, top, probs), (want_labels, want_top)) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(labels, want_labels)
        np.testing.assert_allclose(top, want_top, atol=1e-5, rtol=0)
        if i % 3 == 0:
            assert probs.shape == (sizes[i], cfg.num_classes)
            np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
            np.testing.assert_array_equal(probs.argmax(-1), labels)
        else:
            assert probs is None


@pytest.mark.cuda
def test_readback_is_pinned_per_batch(dev):
    """Each batch's outputs go into pinned host tensors of its own, copied
    without blocking, with an event of its own recorded after them."""
    from vit_tpu_torch.runtime import serving

    batches = []
    for seed in range(2):  # two batches in flight, as at pipeline depth 2
        probs = torch.softmax(_rn(dev, seed, 64, 1000), -1)
        labels = probs.argmax(-1)
        top = probs.gather(-1, labels[:, None])[:, 0]
        batches.append(((labels, top, probs), serving.start_async_readback(labels, top, probs)))
    assert batches[0][1].labels.data_ptr() != batches[1][1].labels.data_ptr()
    for (labels, top, probs), rb in batches:
        assert rb.labels.is_pinned() and rb.top.is_pinned() and rb.probs.is_pinned()
        assert isinstance(rb.event, torch.cuda.Event)
        got = rb.wait()
        for g, w in zip(got, (labels, top, probs)):
            np.testing.assert_array_equal(g, w.cpu().numpy())
    rb = serving.start_async_readback(labels, top)
    assert rb.probs is None and rb.wait()[2] is None


# -- MAE's shapes: the decoder (D 512, 16 heads of width 32, F 2,048, T 197)
# and the B/16 encoder on the visible tokens (T 50 at the 0.75 mask), each at
# batch 4 and a ragged 3 --------------------------------------------------------

MAE_SHAPES = {"decoder_b4": (4, 197, 512, 16, 2048), "decoder_b3": (3, 197, 512, 16, 2048),
              "encoder_b4": (4, 50, 768, 12, 3072), "encoder_b3": (3, 50, 768, 12, 3072)}


def _mae_kernel_case(dev, dtype, kernel, b, t, d, h, f):
    """(kernel, plain twin, args, backward) of one training kernel at one
    MAE shape."""
    rows = b * t
    if kernel == "K1":
        args = (_rn(dev, 0, rows, d, scale=2.0, dtype=dtype),
                _rn(dev, 1, d, scale=0.2, shift=1.0, dtype=dtype),
                _rn(dev, 2, d, scale=0.2, dtype=dtype),
                _rn(dev, 3, d, 3 * d, scale=d ** -0.5, dtype=dtype),
                _rn(dev, 4, 3 * d, scale=0.1, dtype=dtype), h, t, 1e-6)
        return ln_qkv_attn, ln_qkv_attn_plain, args, False
    if kernel == "K4":
        args = (_rn(dev, 0, rows, d, dtype=dtype), _rn(dev, 1, rows, d, scale=2.0, dtype=dtype),
                _rn(dev, 2, d, d, scale=d ** -0.5, dtype=dtype),
                _rn(dev, 3, d, scale=0.1, dtype=dtype))
        return out_residual, out_residual_plain, args, False
    if kernel == "K5":
        return (ln_mlp_residual, ln_mlp_residual_plain,
                (*_mlp_args(dev, dtype, rows, d, f), 1e-6, "exact"), False)
    if kernel == "K6":
        return ln_qkv_attn_bwd, ln_qkv_attn_bwd_plain, _k6_args(dev, dtype, b, t, d, h), True
    return (ln_mlp_out_residual_bwd, ln_mlp_out_residual_bwd_plain,
            _k7_args(dev, dtype, rows, d, f, "exact"), True)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", list(MAE_SHAPES))
@pytest.mark.parametrize("kernel", ["K1", "K4", "K5", "K6", "K7"])
def test_training_kernels_at_mae_shapes(dev, dtype, case, kernel):
    fn, plain, args, backward = _mae_kernel_case(dev, dtype, kernel, *MAE_SHAPES[case])
    (_check_all if backward else _check)(fn(*args), plain(*args))


# -- the input prefetch's stream discipline (runtime/prefetch.py) -------------------


@pytest.mark.cuda
def test_prefetch_consumer_waits_and_keeps_what_it_reads(dev):
    """A consumer whose stream lags far behind the side stream's copies
    still reads every batch whole: its stream waits on each batch's event,
    and ``record_stream`` keeps the caching allocator from handing a freed
    batch's memory to a later copy before the consumer's reads of it run."""
    from vit_tpu_torch.runtime.prefetch import prefetch_to_device

    n, shape = 10, (16, 3, 224, 224)
    items = [(np.full(shape, i, np.float32), np.full(16, i, np.int32)) for i in range(n)]
    sums = []
    for x, y in prefetch_to_device(iter(items), size=2, device=dev):
        assert x.device == dev and y.device == dev and y.dtype == torch.int32
        torch.cuda._sleep(20_000_000)  # the consumer's stream lags the copies
        sums.append((x.double().sum(), y.sum()))
        del x, y  # freed while the reads above are still queued
    torch.cuda.synchronize(dev)
    per = float(np.prod(shape))
    assert [(float(a), int(b)) for a, b in sums] == [(i * per, 16 * i) for i in range(n)]


@pytest.mark.cuda
def test_prefetch_refills_a_pinned_buffer_only_after_its_copy(dev):
    """One pinned buffer, its first copy queued behind a busy side stream:
    staging the next batch into it waits for that copy, so the first batch
    arrives with its own values."""
    from vit_tpu_torch.runtime.prefetch import _PinnedSlots

    slots, stream = _PinnedSlots(1), torch.cuda.Stream(dev)
    out = []
    for value in (1.0, 2.0):
        with torch.cuda.stream(stream):
            torch.cuda._sleep(50_000_000)
        copies = []
        out.append(slots.stage(torch.full((1 << 22,), value), dev, stream, copies))
        event = torch.cuda.Event()
        event.record(stream)
        slots.done(copies, event)
    torch.cuda.synchronize(dev)
    assert bool((out[0] == 1.0).all()) and bool((out[1] == 2.0).all())


@pytest.mark.cuda
def test_prefetch_producer_runs_on_the_consumers_device(dev):
    """Threads do not inherit the current device: the producer sets it."""
    from vit_tpu_torch.runtime.prefetch import prefetch_to_device

    for index in range(torch.cuda.device_count()):
        target, seen = torch.device("cuda", index), []

        def items():  # drawn in the producer thread
            for _ in range(2):
                seen.append(torch.cuda.current_device())
                yield np.ones(4, np.float32)

        got = list(prefetch_to_device(items(), device=target))
        assert seen == [index, index] and [x.device for x in got] == [target, target]
