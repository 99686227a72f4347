"""K1/K2/K3: the plain PyTorch twins against the JAX package's Pallas
kernels (interpret mode on the CPU), the GELU helpers, the wrappers'
device rules and the kernel build's failure mode.

The CUDA kernels themselves have no CPU mode; ``test_torch_cuda.py`` holds
them to these twins on the card (and ``chip_smoke.py`` at B/16 shapes).

Tolerances: fp32 1e-5 absolute (fp32 accumulation on both sides, only the
summation order differs).  bf16 2e-2 absolute plus 2^-7 relative: both
sides round at the same points, so they differ only where fp32
accumulation order flips a bf16 rounding — one ulp, at most 2^-7 of the
value (BENCH_r05's B/16 bf16 spread against the fp64 oracle is 0.027).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops.pallas.fused_block as JF
import vit_tpu.ops.pallas.ln_kernel as JLN
from vit_tpu.config import DEIT_T_16
from vit_tpu.ops.pallas.mlp_kernel import _erf as j_erf
from vit_tpu_torch.ops import fused_block as TF
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.layer_norm import layer_norm, layer_norm_plain
from vit_tpu_torch.ops.kernels.ln_qkv_attn import ln_qkv_attn, ln_qkv_attn_plain
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import (
    out_ln_mlp_residual,
    out_ln_mlp_residual_plain,
)

TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=2e-2, rtol=2 ** -7)}
DTYPES = ["float32", "bfloat16"]


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _pair(a, dtype):
    """One numpy array as (jax, torch) operands of ``dtype``, same bits."""
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _close(got, want, dtype):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)), **TOL[dtype]
    )


def _ln_operands(d, seed):
    return _np(seed, d, scale=0.2, shift=1.0), _np(seed + 1, d, scale=0.2)


# -- K3 ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(3, 37, 128), (197, 256), (2, 5, 64)])
def test_layer_norm_twin_matches_pallas(dtype, shape):
    x = _np(0, *shape, scale=3.0, shift=1.0)
    s, b = _ln_operands(shape[-1], 1)
    (jx, tx), (js, ts), (jb, tb) = (_pair(a, dtype) for a in (x, s, b))
    want = JLN.layer_norm(jx, js, jb, 1e-6, block_rows=64, interpret=True)
    _close(layer_norm_plain(tx, ts, tb, 1e-6), want, dtype)


# -- K1 ----------------------------------------------------------------------


def _k1_operands(b, t, d, seed):
    x = _np(seed, b * t, d, scale=2.0)
    s, bias = _ln_operands(d, seed + 1)
    w = _np(seed + 3, d, 3 * d, scale=d ** -0.5)
    bq = _np(seed + 4, 3 * d, scale=0.1)
    return x, s, bias, w, bq


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,t,d,h",
    [(3, 5, 64, 4), (2, 19, 64, 4), (2, 37, 128, 2)],
    ids=["tiny", "ragged_t19", "dh64"],
)
def test_ln_qkv_attn_twin_matches_pallas(dtype, b, t, d, h):
    ops = [_pair(a, dtype) for a in _k1_operands(b, t, d, 10)]
    want = JF.ln_qkv_attn(*(o[0] for o in ops), h, t, 1e-6, interpret=True)
    got = ln_qkv_attn_plain(*(o[1] for o in ops), h, t, 1e-6)
    assert tuple(got.shape) == (b * t, d) and got.dtype == getattr(torch, dtype)
    _close(got, want, dtype)


def test_ln_qkv_attn_deit_tiny_cfg_block():
    # DeiT's extra prefix token: T = patches + 2, from tiny DeiT params
    from vit_tpu.io import weights as wio

    cfg = dataclasses.replace(
        DEIT_T_16, depth=1, embed_dim=64, num_heads=4, image_size=32, name="deit_k1"
    )
    blk = wio.params_from_tensors(
        wio.synth_reference_tensors(dataclasses.replace(cfg, distilled=False), 2),
        dataclasses.replace(cfg, distilled=False),
    )["blocks"]
    t = cfg.seq_len
    assert t == 6
    x = _np(3, 2 * t, 64)
    names = ["ln1_scale", "ln1_bias", "wqkv", "bqkv"]
    want = JF.ln_qkv_attn(jnp.asarray(x), *(jnp.asarray(blk[n][0]) for n in names),
                          cfg.num_heads, t, 1e-6, interpret=True)
    got = ln_qkv_attn_plain(torch.from_numpy(x), *(torch.from_numpy(blk[n][0]) for n in names),
                            cfg.num_heads, t, 1e-6)
    _close(got, want, "float32")


# -- K2 ----------------------------------------------------------------------


def _k2_operands(rows, d, f, seed):
    ctx, res = _np(seed, rows, d), _np(seed + 1, rows, d, scale=2.0)
    wo, bo = _np(seed + 2, d, d, scale=d ** -0.5), _np(seed + 3, d, scale=0.1)
    s, bias = _ln_operands(d, seed + 4)
    w1, b1 = _np(seed + 6, d, f, scale=d ** -0.5), _np(seed + 7, f, scale=0.1)
    w2, b2 = _np(seed + 8, f, d, scale=f ** -0.5), _np(seed + 9, d, scale=0.1)
    return ctx, res, wo, bo, s, bias, w1, b1, w2, b2


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows", [10, 133], ids=["tiny", "ragged_133"])
def test_out_ln_mlp_residual_twin_matches_pallas(dtype, variant, rows):
    ops = [_pair(a, dtype) for a in _k2_operands(rows, 64, 256, 20)]
    want = JF.out_ln_mlp_residual(
        *(o[0] for o in ops), 1e-6, variant, block_rows=64, interpret=True
    )
    got = out_ln_mlp_residual_plain(*(o[1] for o in ops), 1e-6, variant)
    assert tuple(got.shape) == (rows, 64)
    _close(got, want, dtype)


# -- the fused block ---------------------------------------------------------


@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_fused_encoder_block_matches_pallas(tiny_cfg, tiny_params, variant):
    t, d = tiny_cfg.seq_len, tiny_cfg.embed_dim
    x = _np(30, 2 * t, d)
    jblk = jax.tree.map(lambda a: a[0], tiny_params["blocks"])
    tblk = {k: torch.from_numpy(np.array(v)) for k, v in jblk.items()}
    want = JF.fused_encoder_block(
        jnp.asarray(x), jblk, tiny_cfg.num_heads, t, tiny_cfg.layernorm_eps,
        variant, interpret=True,
    )
    got = TF.fused_encoder_block(
        torch.from_numpy(x), tblk, tiny_cfg.num_heads, t, tiny_cfg.layernorm_eps, variant
    )
    _close(got, want, "float32")


def test_fused_encoder_block_long_sequence_not_ported(tiny_params, monkeypatch):
    # past VMEM_ATTENTION_MAX_T the block runs K3 + QKV + K13 + K2 (their
    # twins here) and computes what the K1 + K2 block does
    import vit_tpu_torch.ops.kernels.flash_attention as KFA

    calls = []
    plain = KFA.flash_attention_fwd_plain
    monkeypatch.setattr(KFA, "flash_attention_fwd_plain", lambda *a: calls.append(1) or plain(*a))
    t = TF.VMEM_ATTENTION_MAX_T + 1
    x = torch.from_numpy(_np(31, t, 64))
    blk = {k: torch.from_numpy(np.array(v[0])) for k, v in tiny_params["blocks"].items()}
    got = TF.fused_encoder_block(x, blk, 4, t, 1e-6)
    assert calls == [1]
    ctx = ln_qkv_attn_plain(x, blk["ln1_scale"], blk["ln1_bias"], blk["wqkv"], blk["bqkv"],
                            4, t, 1e-6)
    want = out_ln_mlp_residual_plain(ctx, x, blk["wo"], blk["bo"], blk["ln2_scale"],
                                     blk["ln2_bias"], blk["w1"], blk["b1"], blk["w2"], blk["b2"],
                                     1e-6)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)


# -- GELU helpers ------------------------------------------------------------

_X = np.linspace(-12, 12, 20001, dtype=np.float32)


def test_erf_matches_jax_as_form():
    np.testing.assert_allclose(TF._erf(torch.from_numpy(_X)).numpy(), np.asarray(j_erf(_X)),
                               atol=1e-7, rtol=0)


def test_erf_tanh_inner_matches_jax():
    for got, want in zip(TF._erf_tanh_inner(torch.from_numpy(_X)), JF._erf_tanh_inner(jnp.asarray(_X))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("variant,fast", [("exact", False), ("exact", True), ("tanh", False)])
def test_gelu_matches_jax(variant, fast):
    got = TF._gelu(torch.from_numpy(_X), variant, fast_erf=fast).numpy()
    np.testing.assert_allclose(got, np.asarray(JF._gelu(jnp.asarray(_X), variant, fast)),
                               atol=2e-6, rtol=1e-6)


def test_use_fast_erf():
    assert TF.use_fast_erf(torch.bfloat16) and JF.use_fast_erf(jnp.bfloat16)
    assert not TF.use_fast_erf(torch.float32) and not JF.use_fast_erf(jnp.float32)


# -- wrappers: CPU twin, no fallback, launch counts --------------------------


def test_cpu_wrappers_run_the_twin_and_count_no_launch():
    counts = (layer_norm.launches, ln_qkv_attn.launches, out_ln_mlp_residual.launches)
    x, s, b, w, bq = (torch.from_numpy(a) for a in _k1_operands(2, 5, 64, 40))
    torch.testing.assert_close(layer_norm(x, s, b), layer_norm_plain(x, s, b), rtol=0, atol=0)
    ctx = ln_qkv_attn(x, s, b, w, bq, 4, 5, 1e-6)
    torch.testing.assert_close(ctx, ln_qkv_attn_plain(x, s, b, w, bq, 4, 5, 1e-6), rtol=0, atol=0)
    k2 = [torch.from_numpy(a) for a in _k2_operands(10, 64, 256, 41)]
    torch.testing.assert_close(out_ln_mlp_residual(*k2, 1e-6),
                               out_ln_mlp_residual_plain(*k2, 1e-6), rtol=0, atol=0)
    assert (layer_norm.launches, ln_qkv_attn.launches, out_ln_mlp_residual.launches) == counts


@pytest.mark.parametrize("kernel", ["layer_norm", "ln_qkv_attn", "out_ln_mlp_residual"])
def test_wrappers_refuse_other_devices(kernel):
    # a non-CPU tensor either launches the kernel or raises; never the twin
    m = lambda *s: torch.empty(*s, device="meta")  # noqa: E731
    calls = {
        "layer_norm": lambda: layer_norm(m(4, 64), m(64), m(64)),
        "ln_qkv_attn": lambda: ln_qkv_attn(m(10, 64), m(64), m(64), m(64, 192), m(192), 4, 5, 1e-6),
        "out_ln_mlp_residual": lambda: out_ln_mlp_residual(
            m(10, 64), m(10, 64), m(64, 64), m(64), m(64), m(64), m(64, 256), m(256),
            m(256, 64), m(64), 1e-6),
    }
    with pytest.raises(ValueError, match="CUDA or CPU"):
        calls[kernel]()


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_build_hash_covers_every_source():
    cu, cuh = _build.sources()
    assert {p.name for p in cu} == {
        "layer_norm.cu", "ln_qkv_attn.cu", "out_ln_mlp_residual.cu", "out_residual.cu",
        "ln_mlp_residual.cu", "ln_mlp_out_residual_bwd.cu", "ln_qkv_attn_bwd.cu",
        "out_residual_train.cu", "ln_mlp_residual_train.cu", "ln_mlp_out_residual_bwd_train.cu",
        "flash_attention.cu", "flash_attention_bwd.cu", "ln_mlp_residual_bwd.cu",
        "out_residual_bwd.cu", "ln_qkv_attn_q8.cu", "out_ln_mlp_residual_q8.cu",
        "ln_mlp_residual_q8.cu", "ln_mlp_residual_bwd_train.cu", "out_residual_bwd_train.cu",
        "scaled_dot_product_attention.cu", "mlp.cu", "adamw.cu", "ln_fc1_gelu_q8.cu",
        "fc2_q8_partial.cu", "ln_qkv_attn_q8a.cu", "gemm_bf16.cu"}
    assert {p.name for p in cuh} == {"common.cuh", "gemm.cuh", "epilogue.cuh", "attention.cuh",
                                      "ln_mlp_out_residual_bwd.cuh", "flash.cuh", "gemm_q8.cuh",
                                      "quant_rows.cuh", "mlp_q8.cuh", "mma_bf16.cuh",
                                      "gemm_mma.cuh", "sdpa_mma.cuh", "mlp_bwd_mma.cuh"}
    assert _build.library_path().name == f"libvit_tpu_torch_{_build.source_hash()}.so"
