"""The operand rules of the bf16 K22 and K16, on the CPU.

The bf16 K22 (``mlp``, the per-op tier's MLP) runs both GEMMs on
``csrc/gemm_mma.cuh``, whose TMA tensor maps read x, w1 and w2 in rows of
whole 16 bytes; the bf16 K16 (``out_ln_mlp_residual_q8``) runs its out_proj
on that core (ctx and W_o) and its two int8 GEMMs on ``csrc/gemm_mma_q8.cuh``,
which reads both operands K-major: the activation codes as they lie and
W1q, W2q through K-major copies that K16's launch sequence makes
(``kmajor_q8``).  Their wrappers refuse an operand off the 16-byte grid, a
bf16 width that is not a multiple of 8 elements, or an int8 matrix whose
dimensions are not multiples of 16 (``check_tile_operands``, over
``_build.check_tiles`` and ``_build.check_q8_matrices``).

These tests hold those rules on CPU tensors, and show that every operand
the port's own callers hand K22 and K16 passes them: the ``per_op``
forward, ``InferenceEngine.phase_report`` on ``per_op`` and ``fused``, the
``quant`` forward at @224 and past the 1,024-token switch, and
``cli/bench_kernels``' ``c8`` run, at the tiny test config's widths and at
ViT-B/16's.  The callers run on the CPU (the wrappers take their plain
twins there); a spy records what they pass.  Last, the K-major copies of
the JAX package's quantized weights are their transposes, and the int8
reference product through them is the JAX package's bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops import quant as JQ
from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops import quant as TQ
from vit_tpu_torch.ops.kernels import mlp as k22
from vit_tpu_torch.ops.kernels.kmajor_q8 import kmajor_q8
from vit_tpu_torch.ops.kernels import out_ln_mlp_residual_q8 as k16

from torch_spy_record import record

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
# (D, heads, MLP width): the tiny test config's and ViT-B/16's
WIDTHS = {"tiny": (64, 4, 256), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads,
                                        VIT_B_16.mlp_dim)}


def _t(shape, dtype=torch.bfloat16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(
        dtype)


def _q8(shape, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(-127, 128, shape).astype(np.int8))


def _off(t):
    """The same shape, contiguous, one element past the 16-byte grid."""
    flat = torch.zeros(t.numel() + 1, dtype=t.dtype)[1:]
    return flat.copy_(t.reshape(-1)).view(*t.shape)


def _k22_args(rows, d, f, dtype=torch.bfloat16):
    """K22's operands (x, w1, b1, w2, b2), x as (batch, T, D)."""
    return (_t((2, rows, d), dtype, 1), _t((d, f), dtype, 2), _t((f,), dtype, 3),
            _t((f, d), dtype, 4), _t((d,), dtype, 5))


def _k16_args(rows, d, f, dtype=torch.bfloat16):
    """K16's operands (ctx, res, wo, bo, ln_scale, ln_bias, w1q, w1s, b1,
    w2q, w2s, b2, eps)."""
    return (_t((rows, d), dtype, 1), _t((rows, d), dtype, 2), _t((d, d), dtype, 3),
            _t((d,), dtype, 4), _t((d,), dtype, 5), _t((d,), dtype, 6), _q8((d, f), 7),
            _t((f,), torch.float32, 8).abs(), _t((f,), dtype, 9), _q8((f, d), 10),
            _t((d,), torch.float32, 11).abs(), _t((d,), dtype, 12), EPS)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_aligned_operands_pass(width, dtype):
    d, _, f = WIDTHS[width]
    k22.check_tile_operands(*_k22_args(10, d, f, dtype))
    k16.check_tile_operands(*_k16_args(10, d, f, dtype))
    # a view 16 bytes into a buffer is on the grid
    flat = _t((10 * d + 16,), dtype)
    step = 16 // flat.element_size()
    view = flat[step:step + 10 * d].view(10, d)
    k22.check_tile_operands(view, *_k22_args(10, d, f, dtype)[1:])
    k16.check_tile_operands(view, *_k16_args(10, d, f, dtype)[1:])


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("kernel,i,name", [("k22", 0, "x"), ("k22", 1, "w1"), ("k22", 3, "w2"),
                                           ("k16", 0, "ctx"), ("k16", 2, "wo")])
def test_off_grid_views_are_refused(width, kernel, i, name):
    d, _, f = WIDTHS[width]
    mod, args = (k22, list(_k22_args(10, d, f))) if kernel == "k22" else (k16, list(
        _k16_args(10, d, f)))
    args[i] = _off(args[i])
    with pytest.raises(ValueError, match=f"{name} must start on a 16-byte boundary"):
        mod.check_tile_operands(*args)


@pytest.mark.parametrize("i", [6, 9], ids=["w1q", "w2q"])
def test_off_grid_int8_weights_are_refused(i):
    args = list(_k16_args(10, 64, 256))
    args[i] = _off(args[i])
    with pytest.raises(ValueError, match="16-byte aligned"):
        k16.check_tile_operands(*args)


@pytest.mark.parametrize("kernel,d,f,what", [
    ("k22", 60, 256, "x is 60 elements wide.*multiples of 8"),
    ("k22", 64, 252, "w1 is 252 elements wide.*multiples of 8"),
    ("k16", 60, 256, "ctx is 60 elements wide.*multiples of 8"),
    ("k16", 72, 256, "multiples of 16"),
    ("k16", 64, 264, "multiples of 16")])
def test_widths_off_the_grid_are_refused(kernel, d, f, what):
    mod, args = (k22, _k22_args(10, d, f)) if kernel == "k22" else (k16, _k16_args(10, d, f))
    with pytest.raises(ValueError, match=what):
        mod.check_tile_operands(*args)


def _spy(monkeypatch, owner, name):
    """Record every call's arguments to owner.name, then make the call."""
    calls, real = [], getattr(owner, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, spy)
    return calls


def _spy_k22(monkeypatch):
    """K22 as the op tables hold it: the ``per_op`` and ``fused`` tables'
    ``mlp`` slot (the per-op forward's and phase_report's)."""
    from vit_tpu_torch.ops import fused

    calls = []
    for table in ("PER_OP_OPS", "FUSED_OPS"):
        ops = getattr(fused, table)
        assert ops.mlp is k22.mlp

        def spy(*args, **kwargs):
            calls.append((args, kwargs))
            return k22.mlp(*args, **kwargs)

        monkeypatch.setattr(fused, table, dataclasses.replace(ops, mlp=spy))
    return calls


def _model_cfg(width, image_size=32):
    # 17 tokens at 32 px; two layers
    d, h, _ = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h,
                               image_size=image_size, patch_size=8, num_classes=11,
                               name=f"vit_q8_mma_{width}")


def _params(cfg, dtype):
    from vit_tpu_torch.models import vit

    params = vit.init_params(torch.Generator().manual_seed(1), cfg)
    return {k: v.to(dtype) if torch.is_tensor(v) else {n: x.to(dtype) for n, x in v.items()}
            for k, v in params.items()}


def _images(cfg, n=2):
    from vit_tpu_torch.io.images import synth_images

    return torch.from_numpy(synth_images(n, cfg, seed=2))


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_per_op_forward_operands_pass(monkeypatch, width, dtype):
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import get_ops

    cfg = _model_cfg(width)
    calls = _spy_k22(monkeypatch)
    with torch.inference_mode():
        vit.forward(_params(cfg, dtype), _images(cfg).to(dtype), cfg, get_ops("per_op"))
    assert len(calls) == cfg.depth
    for args, kwargs in calls:
        assert args[0].shape == (2, cfg.seq_len, cfg.embed_dim) and args[0].dtype == dtype
        k22.check_tile_operands(*args, **kwargs)


@pytest.mark.parametrize("ops", ["per_op", "fused"])
@pytest.mark.parametrize("width", list(WIDTHS))
def test_phase_report_operands_pass(monkeypatch, ops, width):
    from vit_tpu_torch.io.params import params_to_numpy
    from vit_tpu_torch.runtime.engine import InferenceEngine

    cfg = _model_cfg(width)
    calls = _spy_k22(monkeypatch)
    eng = InferenceEngine(cfg, params_to_numpy(_params(cfg, torch.float32)), dtype="bfloat16",
                          ops=ops, device="cpu", batch_pad=2)
    eng.phase_report(_images(cfg).numpy(), iters=2)
    assert len(calls) == 2 * cfg.depth
    for args, kwargs in calls:
        assert args[0].dtype == torch.bfloat16
        k22.check_tile_operands(*args, **kwargs)


def _quant_forward_run(monkeypatch, long, width, dtype):
    """The ``quant`` forward with K16's spy -> (cfg, calls)."""
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import fused_block, get_ops, quant_block

    if long:
        monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    cfg = _model_cfg(width)
    params = TQ.cast_quantized_params(TQ.quantize_params(_params(cfg, torch.float32)), dtype)
    calls = _spy(monkeypatch, quant_block, "out_ln_mlp_residual_q8")
    with torch.inference_mode():
        vit.forward(params, _images(cfg).to(dtype), cfg, get_ops("quant"))
    return cfg, calls


@pytest.fixture(scope="module")
def quant_forward_b16():
    """The B/16-width runs of the cases below, each once: their record."""
    return record(_quant_forward_run, [(long, "b16", dtype) for long in (False, True)
                                       for dtype in DTYPES])


@pytest.mark.parametrize("long", [False, True], ids=["short", "long_blocks"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_quant_forward_operands_pass(monkeypatch, request, long, width, dtype):
    # K16 behind K15 (@224), and behind ln_qkv_q8 + K13 past the switch,
    # reached at 17 tokens by lowering it, as tests/test_torch_quant.py does
    cfg, calls = (request.getfixturevalue("quant_forward_b16")[long, width, dtype]
                  if width == "b16" else _quant_forward_run(monkeypatch, long, width, dtype))
    assert len(calls) == cfg.depth
    for args, kwargs in calls:
        assert args[0].shape == (2 * cfg.seq_len, cfg.embed_dim) and args[0].dtype == dtype
        k16.check_tile_operands(*args, **kwargs)


def test_bench_kernels_operands_pass(monkeypatch):
    # cli/bench_kernels' `c8` run (B/16, one layer's weights of its
    # 12-layer stack each call), at batch 1; its card checks and timer made
    # CPU ones
    from vit_tpu_torch.cli import bench_kernels
    from vit_tpu_torch.io import params as io_params

    monkeypatch.setattr(io_params, "device_or_raise", lambda device: torch.device("cpu"))
    monkeypatch.setattr(bench_kernels, "time_layers",
                        lambda body, x, weights: [body(x, w) for w in weights] and 1.0)
    calls = _spy(monkeypatch, k16, "out_ln_mlp_residual_q8")
    assert bench_kernels.main(["--batch", "1", "--which", "c8"]) in (0, None)
    assert len(calls) == bench_kernels.L
    for args, kwargs in calls:
        assert args[0].shape == (197, 768) and args[0].dtype == torch.bfloat16
        k16.check_tile_operands(*args, **kwargs)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_kmajor_copies_of_the_jax_leaves(width):
    # the quantized tree stays the JAX package's ([in, out] int8 leaves);
    # K16's K-major copies are their transposes, and the int8 reference
    # product through a copy (the core's operand form) is the JAX package's
    # int8 product bit for bit, sums past 2^24 included at B/16's F
    d, _, f = WIDTHS[width]
    rng = np.random.default_rng(3)
    blocks = {"w1": rng.normal(size=(2, d, f)).astype(np.float32) * d ** -0.5,
              "w2": rng.normal(size=(2, f, d)).astype(np.float32) * f ** -0.5}
    jq = JQ.quantize_params({"blocks": {**blocks, "wqkv": np.zeros((2, d, 3 * d), np.float32)}})
    for name in ("w1", "w2"):
        leaves, scales = np.asarray(jq["blocks"][name]), np.asarray(jq["blocks"][f"{name}_scale"])
        k = leaves.shape[1]
        x_q = rng.integers(-127, 128, (5, k)).astype(np.int8)
        x_q[0] = 127
        s_x = (np.abs(rng.normal(size=5)) + 0.1).astype(np.float32)
        for layer in range(2):
            w, s = torch.from_numpy(leaves[layer].copy()), torch.from_numpy(scales[layer].copy())
            wt = kmajor_q8(w)
            assert wt.dtype == torch.int8 and wt.is_contiguous()
            np.testing.assert_array_equal(wt.numpy(), leaves[layer].T)
            want = np.asarray(JQ.int8_matmul_reference(
                jnp.asarray(x_q), jnp.asarray(s_x), jnp.asarray(leaves[layer]), jnp.asarray(s)))
            for got in (TQ.int8_matmul_reference(torch.from_numpy(x_q), torch.from_numpy(s_x),
                                                 wt.t(), s),
                        k16.gemm_q8_mma_dequant(torch.from_numpy(x_q), torch.from_numpy(s_x), wt,
                                                s)):
                np.testing.assert_array_equal(got.numpy(), want)
