"""K4/K5 (training forward) and K6/K7 (backward): the plain PyTorch twins
against the JAX package's Pallas kernels in interpret mode on the CPU, the
wrappers' device rules and the backward's routing.

The CUDA kernels have no CPU mode; ``test_torch_cuda.py`` holds them to
these twins on the card (and ``chip_smoke.py`` at B/16 shapes).

Tolerances:
  - forward, fp32 1e-5 absolute: fp32 accumulation on both sides, only the
    summation order differs; bf16 2e-2 absolute plus 2^-7 relative: both
    sides round at the same points, so they differ where the accumulation
    order flips one bf16 rounding (one ulp, at most 2^-7 of the value).
  - backward, fp32 atol = rtol = 1e-4 (tests/test_backward.py's bar for the
    Pallas kernels against autodiff).  bf16: 2e-2 of each output's largest
    |value|.  The twin and the kernel round at the same points (h, du_c,
    dx1, p_c, ds_c, dqkv), but a flipped rounding of an intermediate (one
    bf16 ulp, 2^-8 of it) is carried through the next GEMM into every
    gradient that contracts it, so the bound is a few ulps of the output's
    scale rather than of each element.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops.pallas.backward as JB
import vit_tpu.ops.pallas.fused_block as JF
from vit_tpu.config import DEIT_T_16, VIT_B_16
from vit_tpu_torch.ops import backward as TB
from vit_tpu_torch.ops.kernels.ln_mlp_out_residual_bwd import (
    ln_mlp_out_residual_bwd,
    ln_mlp_out_residual_bwd_plain,
)
from vit_tpu_torch.ops.kernels.ln_mlp_residual import ln_mlp_residual, ln_mlp_residual_plain
from vit_tpu_torch.ops.kernels.ln_qkv_attn_bwd import ln_qkv_attn_bwd, ln_qkv_attn_bwd_plain
from vit_tpu_torch.ops.kernels.out_residual import out_residual, out_residual_plain

DTYPES = ["float32", "bfloat16"]
FWD_TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=2e-2, rtol=2 ** -7)}
EPS = 1e-6


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _pairs(arrays, dtype):
    """numpy arrays -> ([jax operands], [torch operands]) of ``dtype``, same bits."""
    return (
        [jnp.asarray(a).astype(dtype) for a in arrays],
        [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays],
    )


def _f32(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x.astype(jnp.float32))


def _close_fwd(got, want, dtype):
    np.testing.assert_allclose(_f32(got), _f32(want), **FWD_TOL[dtype])


def _close_bwd(got, want, dtype):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _f32(g), _f32(w).reshape(g.shape)
        if dtype == "float32":
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=1e-4, err_msg=f"output {i}")
        else:
            bound = 2e-2 * float(np.abs(w).max())
            err = float(np.abs(g - w).max())
            assert err <= bound, f"output {i}: max|d| {err} > {bound}"


# -- K4: out_proj + residual, rounded ----------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rows", [10, 100], ids=["tiny", "ragged_100"])
def test_out_residual_twin_matches_pallas(dtype, rows):
    d = 64
    ops = _pairs([_np(1, rows, d), _np(2, rows, d, scale=2.0),
                  _np(3, d, d, scale=d ** -0.5), _np(4, d, scale=0.1)], dtype)
    want = JF.out_residual(*ops[0], block_rows=32, interpret=True)
    got = out_residual_plain(*ops[1])
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (rows, d)
    _close_fwd(got, want, dtype)


# -- K5: LN2 -> MLP -> residual ----------------------------------------------


def _k5_arrays(rows, d, f, seed):
    return [
        _np(seed, rows, d, scale=2.0),
        _np(seed + 1, d, scale=0.2, shift=1.0), _np(seed + 2, d, scale=0.2),
        _np(seed + 3, d, f, scale=d ** -0.5), _np(seed + 4, f, scale=0.1),
        _np(seed + 5, f, d, scale=f ** -0.5), _np(seed + 6, d, scale=0.1),
    ]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows", [10, 100], ids=["tiny", "ragged_100"])
def test_ln_mlp_residual_twin_matches_pallas(dtype, variant, rows):
    jops, tops = _pairs(_k5_arrays(rows, 64, 256, 10), dtype)
    want = JF.ln_mlp_residual(*jops, EPS, variant, block_rows=32, interpret=True)
    got = ln_mlp_residual_plain(*tops, EPS, variant)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (rows, 64)
    _close_fwd(got, want, dtype)


# -- the GELU gradient -------------------------------------------------------


@pytest.mark.parametrize("variant,fast", [("exact", False), ("exact", True), ("tanh", False)])
def test_gelu_grad_matches_jax(variant, fast):
    # 1e-5: where tanh saturates (|arg| > ~4), XLA's CPU tanh and torch's
    # differ by a few ulps of 1, and the (1 - t^2) factor turns that into a
    # few 1e-6 of a value near 1
    x = np.linspace(-12, 12, 20001, dtype=np.float32)
    got = TB._gelu_grad(torch.from_numpy(x), variant, fast_erf=fast).numpy()
    want = np.asarray(JB._gelu_grad(jnp.asarray(x), variant, fast))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-6)


def test_ln_helpers_match_jax():
    x, dh, g = _np(20, 7, 64, scale=3.0, shift=1.0), _np(21, 7, 64), _np(22, 64, shift=1.0)
    (xh, inv), (jxh, jinv) = TB._ln_stats(torch.from_numpy(x), EPS), JB._ln_stats(jnp.asarray(x), EPS)
    np.testing.assert_allclose(xh.numpy(), np.asarray(jxh), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jinv), atol=1e-6, rtol=1e-6)
    got = TB._ln_bwd_dx(torch.from_numpy(dh), xh, inv, torch.from_numpy(g))
    want = JB._ln_bwd_dx(jnp.asarray(dh), jxh, jinv, jnp.asarray(g))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


# -- K7: merged d[LN2 + MLP + residual] o d[out_proj + residual] -------------


def _k7_arrays(rows, d, f, seed):
    return [
        _np(seed, rows, d),  # dy
        _np(seed + 1, rows, d, scale=2.0),  # x1
        _np(seed + 2, rows, d),  # ctx
        _np(seed + 3, d, scale=0.2, shift=1.0), _np(seed + 4, d, scale=0.2),
        _np(seed + 5, d, f, scale=d ** -0.5), _np(seed + 6, f, scale=0.1),
        _np(seed + 7, f, d, scale=f ** -0.5),
        _np(seed + 8, d, d, scale=d ** -0.5),  # wo
    ]


# token counts: tiny T = 5 (x3 images), T = 17 (image 64 / patch 16, x2),
# DeiT's two prefix tokens T = 6 (x3); B/16's rows 591 = 3 x 197 appear on
# the card only
ROW_CASES = {"tiny_t5": 15, "t17": 34, "deit_t6": 18, "ragged_100": 100}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows", list(ROW_CASES.values()), ids=list(ROW_CASES))
def test_ln_mlp_out_residual_bwd_twin_matches_pallas(dtype, variant, rows):
    jops, tops = _pairs(_k7_arrays(rows, 64, 256, 30), dtype)
    want = JB.ln_mlp_out_residual_bwd(*jops, EPS, variant, block_rows=32, interpret=True)
    got = ln_mlp_out_residual_bwd_plain(*tops, EPS, variant)
    assert got[0].dtype == got[1].dtype == getattr(torch, dtype)
    assert all(g.dtype == torch.float32 for g in got[2:])
    _close_bwd(got, want, dtype)


# -- K6: d[LN1 + QKV + attention] with the residual join ---------------------


def _k6_arrays(rows, d, seed):
    return [
        _np(seed, rows, d),  # dctx
        _np(seed + 1, rows, d),  # dres
        _np(seed + 2, rows, d, scale=2.0),  # x
        _np(seed + 3, d, scale=0.2, shift=1.0), _np(seed + 4, d, scale=0.2),
        _np(seed + 5, d, 3 * d, scale=d ** -0.5), _np(seed + 6, 3 * d, scale=0.1),
    ]


def _seq_len(case):
    tiny = dataclasses.replace(VIT_B_16, embed_dim=64, num_heads=4, patch_size=16, image_size=32)
    return {
        "tiny_t5": tiny.seq_len,
        "t17": dataclasses.replace(tiny, image_size=64).seq_len,
        "deit_t6": dataclasses.replace(DEIT_T_16, embed_dim=64, num_heads=4, image_size=32).seq_len,
    }[case]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,batch", [("tiny_t5", 3), ("t17", 2), ("deit_t6", 3)])
def test_ln_qkv_attn_bwd_twin_matches_pallas(dtype, case, batch):
    t = _seq_len(case)
    assert t == {"tiny_t5": 5, "t17": 17, "deit_t6": 6}[case]
    jops, tops = _pairs(_k6_arrays(batch * t, 64, 40), dtype)
    want = JB.ln_qkv_attn_bwd(*jops, 4, t, EPS, interpret=True)
    got = ln_qkv_attn_bwd_plain(*tops, 4, t, EPS)
    assert got[0].dtype == getattr(torch, dtype)
    _close_bwd(got, want, dtype)


# -- wrappers: CPU twin, no fallback, launch counts, hooks of later slices ---


def test_cpu_wrappers_run_the_twin_and_count_no_launch():
    fns = (out_residual, ln_mlp_residual, ln_mlp_out_residual_bwd, ln_qkv_attn_bwd)
    counts = [fn.launches for fn in fns]
    k4 = [torch.from_numpy(a) for a in (_np(1, 10, 64), _np(2, 10, 64), _np(3, 64, 64), _np(4, 64))]
    torch.testing.assert_close(out_residual(*k4), out_residual_plain(*k4), rtol=0, atol=0)
    k5 = [torch.from_numpy(a) for a in _k5_arrays(10, 64, 256, 5)]
    torch.testing.assert_close(ln_mlp_residual(*k5, EPS), ln_mlp_residual_plain(*k5, EPS),
                               rtol=0, atol=0)
    k7 = [torch.from_numpy(a) for a in _k7_arrays(10, 64, 256, 6)]
    for got, want in zip(ln_mlp_out_residual_bwd(*k7, EPS), ln_mlp_out_residual_bwd_plain(*k7, EPS)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    k6 = [torch.from_numpy(a) for a in _k6_arrays(10, 64, 7)]
    for got, want in zip(ln_qkv_attn_bwd(*k6, 4, 5, EPS), ln_qkv_attn_bwd_plain(*k6, 4, 5, EPS)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert [fn.launches for fn in fns] == counts


@pytest.mark.parametrize("kernel", ["out_residual", "ln_mlp_residual", "ln_mlp_out_residual_bwd",
                                    "ln_qkv_attn_bwd"])
def test_wrappers_refuse_other_devices(kernel):
    # a non-CPU tensor either launches the kernel or raises; never the twin
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    calls = {
        "out_residual": lambda: out_residual(m(10, 64), m(10, 64), m(64, 64), m(64)),
        "ln_mlp_residual": lambda: ln_mlp_residual(
            m(10, 64), m(64), m(64), m(64, 256), m(256), m(256, 64), m(64), EPS),
        "ln_mlp_out_residual_bwd": lambda: ln_mlp_out_residual_bwd(
            m(10, 64), m(10, 64), m(10, 64), m(64), m(64), m(64, 256), m(256), m(256, 64),
            m(64, 64), EPS),
        "ln_qkv_attn_bwd": lambda: ln_qkv_attn_bwd(
            m(10, 64), m(10, 64), m(10, 64), m(64), m(64), m(64, 192), m(192), 4, 5, EPS),
    }
    with pytest.raises(ValueError, match="CUDA or CPU"):
        calls[kernel]()


def test_hooks_of_later_slices_raise():
    arrays = _k5_arrays(10, 64, 256, 5)
    for dtype in DTYPES:
        jx, tx = _pairs(arrays, dtype)
        # tensor parallelism's partial form is ported: fp32 g @ W2, no b2, no residual
        want = JF.ln_mlp_residual(*jx, EPS, interpret=True, partial=True)
        got = ln_mlp_residual(*tx, EPS, partial=True)
        assert got.dtype == torch.float32 and want.dtype == jnp.float32
        np.testing.assert_allclose(_f32(got), _f32(want), **FWD_TOL[dtype])
        # and so is the pre-GELU stash, in both forms: (out, u), u in x's dtype
        for partial in (False, True):
            want_out, want_u = JF.ln_mlp_residual(*jx, EPS, interpret=True, partial=partial,
                                                  return_u=True)
            got_out, got_u = ln_mlp_residual(*tx, EPS, partial=partial, return_u=True)
            assert got_u.dtype == getattr(torch, dtype) and want_u.dtype == jnp.dtype(dtype)
            assert got_out.dtype == (torch.float32 if partial else getattr(torch, dtype))
            assert got_u.shape == (10, 256) and want_u.shape == (10, 256)
            np.testing.assert_allclose(_f32(got_out), _f32(want_out), **FWD_TOL[dtype])
            np.testing.assert_allclose(_f32(got_u), _f32(want_u), **FWD_TOL[dtype])
    k7 = [torch.from_numpy(a) for a in _k7_arrays(10, 64, 256, 6)]
    with pytest.raises(NotImplementedError, match="u= stash"):
        ln_mlp_out_residual_bwd(*k7, EPS, u=torch.zeros(10, 256))
    k6 = [torch.from_numpy(a) for a in _k6_arrays(10, 64, 7)]
    with pytest.raises(NotImplementedError, match="qkv"):
        ln_qkv_attn_bwd(*k6, 4, 5, EPS, qkv=torch.zeros(10, 192))
    # token merging's log_size and the form without dres are ported: they run
    dx, *_ = ln_qkv_attn_bwd(k6[0], None, *k6[2:], 4, 5, EPS, log_size=torch.zeros(2, 5))
    assert dx.shape == k6[2].shape


def test_block_backward_runs_merged_k7_at_every_width(monkeypatch):
    # the JAX package splits the backward into K8 + K9 past its VMEM budget
    # (H/14 in fp32); the port's K7 has no such bound, so it always merges
    from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7

    assert JB._merged_bwd_vmem_bytes(1280, 5120, 1280, 4) > JB.MERGED_BWD_VMEM_BUDGET
    seen = []
    real = k7.ln_mlp_out_residual_bwd
    monkeypatch.setattr(k7, "ln_mlp_out_residual_bwd",
                        lambda *a, **k: seen.append(a[0].shape) or real(*a, **k))
    d, f, t = 80, 320, 3
    blk = {
        "ln1_scale": torch.ones(d), "ln1_bias": torch.zeros(d),
        "wqkv": torch.from_numpy(_np(1, d, 3 * d, scale=0.1)), "bqkv": torch.zeros(3 * d),
        "wo": torch.from_numpy(_np(2, d, d, scale=0.1)), "bo": torch.zeros(d),
        "ln2_scale": torch.ones(d), "ln2_bias": torch.zeros(d),
        "w1": torch.from_numpy(_np(3, d, f, scale=0.1)), "b1": torch.zeros(f),
        "w2": torch.from_numpy(_np(4, f, d, scale=0.1)), "b2": torch.zeros(d),
    }
    x, ctx, x1, g = (torch.from_numpy(_np(s, 2 * t, d)) for s in (5, 6, 7, 8))
    dx, dblk = TB.fused_encoder_block_bwd(x, blk, ctx, x1, g, 5, t, EPS)
    assert seen == [(2 * t, d)]
    assert dx.shape == x.shape and {k: v.shape for k, v in dblk.items()} == {
        k: v.shape for k, v in blk.items()}
