"""The operand rules of the bf16 K15 and K17, on the CPU.

The bf16 K15 (``ln_qkv_attn_q8``, and its stages 1-2 ``ln_qkv_q8``) runs its
QKV GEMM on ``csrc/gemm_mma_q8.cuh``, the int8 TMA + ``wgmma`` core, which
reads both operands K-major: the row codes as they lie and W_qkv through a
K-major copy its launch sequence makes (``kmajor_q8``); its attention is
K1's bf16 stage, whose 16-byte loads read the packed QKV's rows.  The bf16
K17 (``ln_mlp_residual_q8``) runs K16's int8 chain from LN2 on, FC1 and FC2
on the same core through copies of W1q and W2q.  Their wrappers refuse an
int8 weight off the 16-byte grid or with a dimension that is not a
multiple of 16 (``check_tile_operands``, over
``_build.check_q8_matrices``); a W_qkv width that is a multiple of 16 also
gives the attention tiles whole 16-byte rows of the packed QKV.

These tests hold those rules on CPU tensors, and show that every operand
the port's own callers hand K15 and K17 passes them: the ``quant`` forward
at @224 and past the 1,024-token switch, the ToMe ``quant`` forward,
``parallel/tp_forward`` at tp 2 and 4 (each rank's shard, at @224 and past
the switch) and ``cli/bench_kernels``' ``a8`` run, at the tiny test
config's widths and at ViT-B/16's.  The callers run on the CPU (the
wrappers take their plain twins there); a spy records what they pass.
Last, the K-major copy of the JAX package's quantized W_qkv is its
transpose, and the int8 reference product through it is the JAX package's
bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops import quant as JQ
from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops import quant as TQ
from vit_tpu_torch.ops.kernels import ln_mlp_residual_q8 as k17
from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15
from vit_tpu_torch.ops.kernels.kmajor_q8 import kmajor_q8

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


def _k15_args(rows, d, d3, heads=4, dtype=torch.bfloat16):
    """K15's operands (x, ln_scale, ln_bias, wq, w_scale, bqkv, heads, T,
    eps)."""
    return (_t((rows, d), dtype, 1), _t((d,), dtype, 2), _t((d,), dtype, 3), _q8((d, d3), 4),
            _t((d3,), torch.float32, 5).abs(), _t((d3,), dtype, 6), heads, rows, EPS)


def _k17_args(rows, d, f, dtype=torch.bfloat16):
    """K17's operands (x, ln_scale, ln_bias, w1q, w1s, b1, w2q, w2s, b2,
    eps)."""
    return (_t((rows, d), dtype, 1), _t((d,), dtype, 2), _t((d,), dtype, 3), _q8((d, f), 4),
            _t((f,), torch.float32, 5).abs(), _t((f,), dtype, 6), _q8((f, d), 7),
            _t((d,), torch.float32, 8).abs(), _t((d,), dtype, 9), EPS)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_aligned_operands_pass(width, dtype):
    d, h, f = WIDTHS[width]
    k15.check_tile_operands(*_k15_args(10, d, 3 * d, h, dtype))
    k17.check_tile_operands(*_k17_args(10, d, f, dtype))
    # an int8 view 16 bytes into a buffer is on the grid
    flat = _q8((d * f + 16,))
    view = flat[16:16 + d * f].view(d, f)
    k17.check_tile_operands(*_k17_args(10, d, f, dtype)[:3], view, *_k17_args(10, d, f)[4:])
    k15.check_tile_operands(*_k15_args(10, d, 3 * d, h, dtype)[:3], flat[16:16 + 3 * d * d].view(
        d, 3 * d))


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("kernel,i,name", [("k15", 3, "wq"), ("k17", 3, "w1q"),
                                           ("k17", 6, "w2q")])
def test_off_grid_int8_weights_are_refused(width, kernel, i, name):
    d, h, f = WIDTHS[width]
    mod, args = ((k15, list(_k15_args(10, d, 3 * d, h))) if kernel == "k15"
                 else (k17, list(_k17_args(10, d, f))))
    args[i] = _off(args[i])
    with pytest.raises(ValueError, match="16-byte aligned"):
        mod.check_tile_operands(*args)


@pytest.mark.parametrize("kernel,d,n", [("k15", 72, 216), ("k15", 64, 200), ("k17", 72, 256),
                                        ("k17", 64, 264)],
                         ids=["k15_d72", "k15_3d200", "k17_d72", "k17_f264"])
def test_int8_widths_off_the_grid_are_refused(kernel, d, n):
    args = _k15_args(10, d, n) if kernel == "k15" else _k17_args(10, d, n)
    with pytest.raises(ValueError, match="multiples of 16"):
        (k15 if kernel == "k15" else k17).check_tile_operands(*args)


def _spy(monkeypatch, owner, name):
    """Record every call's arguments to owner.name, then make the call."""
    calls, real = [], getattr(owner, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(owner, name, spy)
    return calls


def _check_k15(calls, n, dtype, d):
    assert len(calls) == n
    for args, kwargs in calls:
        assert args[0].shape[-1] == d and args[0].dtype == dtype
        k15.check_tile_operands(*args, **kwargs)


def _model_cfg(width, image_size=32):
    # 17 tokens at 32 px, 65 at 64 px (ToMe merges there); two layers
    d, h, _ = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h,
                               image_size=image_size, patch_size=8, num_classes=11,
                               name=f"vit_q8_attn_{width}")


def _quant_params(cfg, dtype):
    from vit_tpu_torch.models import vit

    params = vit.init_params(torch.Generator().manual_seed(1), cfg)
    return TQ.cast_quantized_params(TQ.quantize_params(params), dtype)


def _images(cfg, dtype, n=2):
    from vit_tpu_torch.io.images import synth_images

    return torch.from_numpy(synth_images(n, cfg, seed=2)).to(dtype)


def _quant_forward_run(monkeypatch, long, width, dtype):
    """The ``quant`` forward with K15's (or its stages 1-2's) spy -> (cfg,
    calls)."""
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import fused_block, get_ops, quant_block

    if long:
        monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    cfg = _model_cfg(width)
    calls = _spy(monkeypatch, quant_block, "ln_qkv_q8" if long else "ln_qkv_attn_q8")
    with torch.inference_mode():
        vit.forward(_quant_params(cfg, dtype), _images(cfg, dtype), cfg, get_ops("quant"))
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
    # K15 @224, and its stages 1-2 (ln_qkv_q8) past the switch, reached at
    # 17 tokens by lowering it, as tests/test_torch_quant.py does
    cfg, calls = (request.getfixturevalue("quant_forward_b16")[long, width, dtype]
                  if width == "b16" else _quant_forward_run(monkeypatch, long, width, dtype))
    _check_k15(calls, cfg.depth, dtype, cfg.embed_dim)
    assert all(args[0].shape[0] == 2 * cfg.seq_len for args, _ in calls)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tome_quant_forward_operands_pass(monkeypatch, width, dtype):
    # models/tome.forward_quant: K15 with the log-size bias and the k-mean,
    # K17 after each layer's merge, at the merged counts
    from vit_tpu_torch.models import tome

    cfg = _model_cfg(width, image_size=64)
    k15_calls = _spy(monkeypatch, k15, "ln_qkv_attn_q8")
    k17_calls = _spy(monkeypatch, k17, "ln_mlp_residual_q8")
    with torch.inference_mode():
        tome.forward_quant(_quant_params(cfg, dtype), _images(cfg, dtype), cfg, 4)
    _check_k15(k15_calls, cfg.depth, dtype, cfg.embed_dim)
    assert len(k17_calls) == cfg.depth
    for args, kwargs in k17_calls:
        assert args[0].dtype == dtype
        k17.check_tile_operands(*args, **kwargs)
    assert all(args[0].shape[0] < 2 * cfg.seq_len for args, _ in k17_calls)
    assert any(kwargs.get("log_size") is not None for _, kwargs in k15_calls)


def _tp_quant_run(monkeypatch, long, tp, width, dtype):
    """``shard_forward_tp`` on ``quant`` at every rank of tp with K15's (or
    its stages 1-2's) spy -> (cfg, each rank's calls)."""
    from vit_tpu_torch.ops import fused_block
    from vit_tpu_torch.parallel.mesh import Mesh
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.tp_forward import shard_forward_tp

    cfg = _model_cfg(width)
    params, images = _quant_params(cfg, dtype), _images(cfg, dtype)
    ranks = []
    for rank in range(tp):
        if long:
            monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
        calls = _spy(monkeypatch, k15, "ln_qkv_q8" if long else "ln_qkv_attn_q8")
        mesh = Mesh({"tp": tp}, rank, {"tp": None})
        with torch.inference_mode():
            shard_forward_tp(cfg, mesh, "quant")(shard_params(params, mesh), images)
        ranks.append(calls)
        monkeypatch.undo()
    return cfg, ranks


@pytest.fixture(scope="module")
def tp_quant_b16():
    """The B/16-width runs of the cases below, each once: their record."""
    return record(_tp_quant_run, [(long, tp, "b16", dtype) for long in (False, True)
                                  for tp in (2, 4) for dtype in DTYPES])


@pytest.mark.parametrize("long", [False, True], ids=["short", "long_blocks"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tp_quant_operands_pass(monkeypatch, request, long, tp, width, dtype):
    # parallel/tp_forward on `quant`: K15 at each rank's local heads (W_qkv
    # d x 3D/tp: 1,152 and 576 columns at B/16), its stages 1-2 past the
    # switch (sharding.shard_params at that rank's coordinates; a
    # one-process mesh whose all-reduces do nothing)
    cfg, ranks = (request.getfixturevalue("tp_quant_b16")[long, tp, width, dtype]
                  if width == "b16" else _tp_quant_run(monkeypatch, long, tp, width, dtype))
    d = cfg.embed_dim
    assert len(ranks) == tp
    for calls in ranks:
        _check_k15(calls, cfg.depth, dtype, d)
        assert all(args[3].shape == (d, 3 * d // tp) for args, _ in calls)


def test_bench_kernels_operands_pass(monkeypatch):
    # cli/bench_kernels' `a8` run (B/16, one layer's weights of its
    # 12-layer stack each call), at batch 1; its card checks and timer made
    # CPU ones
    from vit_tpu_torch.cli import bench_kernels
    from vit_tpu_torch.io import params as io_params

    monkeypatch.setattr(io_params, "device_or_raise", lambda device: torch.device("cpu"))
    monkeypatch.setattr(bench_kernels, "time_layers",
                        lambda body, x, weights: [body(x, w) for w in weights] and 1.0)
    calls = _spy(monkeypatch, k15, "ln_qkv_attn_q8")
    assert bench_kernels.main(["--batch", "1", "--which", "a8"]) in (0, None)
    assert len(calls) == bench_kernels.L
    for args, kwargs in calls:
        assert args[0].shape == (197, 768) and args[0].dtype == torch.bfloat16
        k15.check_tile_operands(*args, **kwargs)


@pytest.mark.parametrize("width", list(WIDTHS))
def test_kmajor_copy_of_the_jax_wqkv(width):
    # the quantized tree stays the JAX package's ([in, out] int8 leaves);
    # K15's K-major copy of W_qkv is its transpose, and the int8 reference
    # product through the copy (the core's operand form) is the JAX
    # package's int8 product bit for bit
    d, _, f = WIDTHS[width]
    rng = np.random.default_rng(4)
    wqkv = rng.normal(size=(2, d, 3 * d)).astype(np.float32) * d ** -0.5
    jq = JQ.quantize_params({"blocks": {"wqkv": wqkv, "w1": np.zeros((2, d, f), np.float32),
                                        "w2": np.zeros((2, f, d), np.float32)}})
    leaves, scales = np.asarray(jq["blocks"]["wqkv"]), np.asarray(jq["blocks"]["wqkv_scale"])
    x_q = rng.integers(-127, 128, (5, d)).astype(np.int8)
    x_q[0] = 127
    s_x = (np.abs(rng.normal(size=5)) + 0.1).astype(np.float32)
    for layer in range(2):
        w, s = torch.from_numpy(leaves[layer].copy()), torch.from_numpy(scales[layer].copy())
        wt = kmajor_q8(w)
        assert wt.dtype == torch.int8 and wt.is_contiguous() and wt.shape == (3 * d, d)
        np.testing.assert_array_equal(wt.numpy(), leaves[layer].T)
        want = np.asarray(JQ.int8_matmul_reference(
            jnp.asarray(x_q), jnp.asarray(s_x), jnp.asarray(leaves[layer]), jnp.asarray(s)))
        got = TQ.int8_matmul_reference(torch.from_numpy(x_q), torch.from_numpy(s_x), wt.t(), s)
        np.testing.assert_array_equal(got.numpy(), want)
