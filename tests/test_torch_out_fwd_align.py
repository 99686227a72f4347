"""The operand rule of the bf16 K4 and K10, on the CPU.

The bf16 K4 (``out_residual``) and K10 (``out_residual_train``) run their
GEMM on ``csrc/gemm_mma.cuh``'s TMA + ``wgmma`` core, whose tensor maps read
ctx and wo in rows of whole 16 bytes; their wrappers refuse either off the
16-byte grid, or a width (d_ctx, D) that is not a multiple of 8 elements
(``check_tile_operands``, over ``_build.check_tiles``), and only in bf16:
fp32 keeps ``gemm.cuh``'s FMA core, which takes any width.  The residual,
the row scale and x1 are touched by the epilogue only, element by element,
so they take any grid.  These tests hold that rule on CPU tensors, then at
the wrappers' own gate on meta tensors (which stand in for CUDA ones: a meta
view's address is its offset, so an off-grid view stays off the grid) with
the library faked, and show that every operand the port's own callers hand
K4 and K10 passes it: ``ops/trainable``'s ``FusedEncoderBlockFn`` and
``FusedEncoderBlockTrainFn`` in the ``fused_train`` model, ``OutResidualFn``
in the long-sequence block (past the 1,024-token switch, reached at tiny T
by lowering the switch), ``models/tome``'s ``fused`` and ``quant`` classify
forwards, its ``forward_train`` plain (K4), regularized (K10) and with
drop-path only (K4 around the row scale), and ``cli/bench_kernels``' ``b``
run, at the tiny test config's widths and at ViT-B/16's.  The callers run
on the CPU (the wrappers take their plain twins there); a spy records what
they pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels import out_residual as k4
from vit_tpu_torch.ops.kernels import out_residual_train as k10

from torch_spy_record import record

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
# (D, heads, MLP width): the tiny test config's and ViT-B/16's
WIDTHS = {"tiny": (64, 4, 256), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads,
                                        VIT_B_16.mlp_dim)}
KERNELS = {"k4": k4, "k10": k10}
# each kernel's entry point
ENTRY = {"k4": "out_residual", "k10": "out_residual_train"}
# the operands the rule names, by position
OPERANDS = [(0, "ctx"), (2, "wo")]


def _t(shape, dtype=torch.bfloat16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(
        dtype)


def _off(t):
    """The same shape and device, contiguous, one element past the 16-byte
    grid."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(*t.shape)


def _args(rows, d, d_ctx=None, dtype=torch.bfloat16, device="cpu"):
    """K4's operands (ctx, res, wo, bo); K10 adds (dp_scale, seed, dropout_p)."""
    d_ctx = d if d_ctx is None else d_ctx
    shapes = ((rows, d_ctx), (rows, d), (d_ctx, d), (d,))
    if device == "meta":
        return tuple(torch.empty(s, dtype=dtype, device=device) for s in shapes)
    return tuple(_t(s, dtype, i) for i, s in enumerate(shapes))


def _reg(args):
    rows, dev = args[0].shape[0], args[0].device
    return (*args, torch.ones(rows, dtype=torch.float32, device=dev), 11, 0.1)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_aligned_operands_pass(kernel, width, dtype):
    d = WIDTHS[width][0]
    args = _args(10, d, dtype=dtype)
    KERNELS[kernel].check_tile_operands(*args)
    # a view 16 bytes into a buffer is on the grid; the residual may lie anywhere
    flat = _t((10 * d + 16,), dtype)
    step = 16 // flat.element_size()
    KERNELS[kernel].check_tile_operands(flat[step:step + 10 * d].view(10, d), _off(args[1]),
                                        *args[2:])


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("i,name", OPERANDS)
def test_off_grid_views_are_refused(kernel, width, i, name):
    args = list(_args(10, WIDTHS[width][0]))
    args[i] = _off(args[i])
    with pytest.raises(ValueError, match=f"{ENTRY[kernel]}: {name} must start on a 16-byte "
                                         "boundary"):
        KERNELS[kernel].check_tile_operands(*args)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("d,d_ctx,what", [(64, 60, "ctx is 60"), (60, 64, "wo is 60"),
                                          (100, 100, "ctx is 100"), (76, 64, "wo is 76")])
def test_widths_off_the_grid_are_refused(kernel, d, d_ctx, what):
    with pytest.raises(ValueError, match=f"{ENTRY[kernel]}: {what} elements wide.*multiples of 8"):
        KERNELS[kernel].check_tile_operands(*_args(10, d, d_ctx))


# -- the wrappers' own gate, past their CPU branch -----------------------------


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors in place of CUDA ones and a library that records its
    launches: the wrapper runs its own checks, allocations and call."""
    launched = []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: launched.append(name) or 0

    monkeypatch.setattr(_build, "check_operands", lambda *a: None)
    monkeypatch.setattr(_build, "load_library", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "check", lambda rc, name: None)
    return launched


def _call(kernel, args):
    return getattr(KERNELS[kernel], ENTRY[kernel])(*(_reg(args) if kernel == "k10" else args))


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("i,name", OPERANDS)
def test_wrapper_refuses_off_grid_bf16(fake_card, kernel, i, name):
    args = list(_args(10, 64, device="meta"))
    args[i] = _off(args[i])
    with pytest.raises(ValueError, match=f"{ENTRY[kernel]}: {name} must start on a 16-byte"):
        _call(kernel, args)
    assert fake_card == []  # refused before any launch: no fallback


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("d,d_ctx", [(60, 64), (64, 60)])
def test_wrapper_refuses_bf16_widths_off_the_grid(fake_card, kernel, d, d_ctx):
    with pytest.raises(ValueError, match="elements wide.*multiples of 8"):
        _call(kernel, _args(10, d, d_ctx, device="meta"))
    assert fake_card == []


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wrapper_launches_aligned_bf16_on_any_residual(fake_card, kernel):
    # the residual is read by the epilogue alone: off the grid, it launches
    args = list(_args(10, 64, 96, device="meta"))
    args[1] = _off(args[1])
    out = _call(kernel, args)
    assert fake_card == ["vt_" + ENTRY[kernel]]
    assert (out.shape, out.dtype) == ((10, 64), torch.bfloat16)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("off", [None, 0, 1, 2], ids=["aligned", "ctx", "res", "wo"])
@pytest.mark.parametrize("d,d_ctx", [(64, 64), (60, 76)])
def test_wrapper_takes_fp32_anywhere(fake_card, kernel, off, d, d_ctx):
    # fp32 runs gemm.cuh's FMA core: any width, any element offset
    args = list(_args(10, d, d_ctx, torch.float32, device="meta"))
    if off is not None:
        args[off] = _off(args[off])
    out = _call(kernel, args)
    assert fake_card == ["vt_" + ENTRY[kernel]]
    assert (out.shape, out.dtype) == ((10, d), torch.float32)


# -- the callers' operands -----------------------------------------------------


def _spy(monkeypatch, module, name):
    """Record every call's arguments to module.name, then make the call."""
    calls, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _spies(monkeypatch):
    return _spy(monkeypatch, k4, "out_residual"), _spy(monkeypatch, k10, "out_residual_train")


def _check_calls(k4_calls, k10_calls, n4, n10, dtype):
    assert (len(k4_calls), len(k10_calls)) == (n4, n10)
    for kernel, calls in ((k4, k4_calls), (k10, k10_calls)):
        for args, kwargs in calls:
            assert args[0].dtype == dtype
            kernel.check_tile_operands(*args, **kwargs)


def _cast(params, dtype, grad=False):
    return {k: v.to(dtype).requires_grad_(grad) if torch.is_tensor(v)
            else {n: x.to(dtype).requires_grad_(grad) for n, x in v.items()}
            for k, v in params.items()}


def _model_cfg(width, image_size=32, dropout=0.0, drop_path=0.0):
    # 17 tokens at 32 px, 65 at 64 px (ToMe merges there); two layers
    d, h, _ = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h,
                               image_size=image_size, patch_size=8, num_classes=11,
                               dropout=dropout, drop_path=drop_path,
                               name=f"vit_out_fwd_{width}")


def _params(cfg, dtype, grad=False):
    from vit_tpu_torch.models import vit

    return _cast(vit.init_params(torch.Generator().manual_seed(1), cfg), dtype, grad)


def _images(cfg, dtype):
    from vit_tpu_torch.io.images import synth_images

    return torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)


@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_fused_train_model_operands_pass(monkeypatch, regularized, width, dtype):
    # FusedEncoderBlockFn (K4) and FusedEncoderBlockTrainFn (K10), one per
    # layer, on K1's context
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import get_ops

    cfg = _model_cfg(width, 32, *((0.1, 0.1) if regularized else ()))
    k4_calls, k10_calls = _spies(monkeypatch)
    rng = torch.Generator().manual_seed(3) if regularized else None
    vit.forward(_params(cfg, dtype, True), _images(cfg, dtype), cfg, get_ops("fused_train"),
                dropout_rng=rng)
    _check_calls(k4_calls, k10_calls, *((0, cfg.depth) if regularized else (cfg.depth, 0)),
                 dtype)
    assert all(args[0].shape[0] == 2 * cfg.seq_len for args, _ in k4_calls + k10_calls)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_long_block_operands_pass(monkeypatch, width, dtype):
    # OutResidualFn in the @512 path's block, reached at T 5 by lowering the
    # 1,024-token switch, as tests/test_torch_flash.py does: ctx is the
    # flash context K13 writes from the packed QKV
    from vit_tpu_torch.ops import fused_block, trainable

    monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    d, h, f = WIDTHS[width]
    shapes = {"ln1_scale": (d,), "ln1_bias": (d,), "wqkv": (d, 3 * d), "bqkv": (3 * d,),
              "wo": (d, d), "bo": (d,), "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, f),
              "b1": (f,), "w2": (f, d), "b2": (d,)}
    blk = {k: _t(s, dtype, 20 + i) * (s[0] ** -0.5 if len(s) == 2 else 0.2)
           for i, (k, s) in enumerate(shapes.items())}
    k4_calls, k10_calls = _spies(monkeypatch)
    out = trainable.encoder_block_trainable(_t((2 * 5, d), dtype, 1), blk, h, 5, EPS)
    assert torch.isfinite(out.float()).all()
    _check_calls(k4_calls, k10_calls, 1, 0, dtype)
    assert k4_calls[0][0][0].shape == (2 * 5, d)


@pytest.mark.parametrize("ops", ["fused", "quant"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tome_classify_operands_pass(monkeypatch, ops, width, dtype):
    # models/tome's classify forwards: K4 on K1's (or K15's) hooked context,
    # each layer at the count the earlier layers' merges left
    from vit_tpu_torch.models import tome
    from vit_tpu_torch.ops import quant

    cfg = _model_cfg(width, 64)
    params = _params(cfg, torch.float32)
    k4_calls, k10_calls = _spies(monkeypatch)
    with torch.inference_mode():
        if ops == "quant":
            params = quant.cast_quantized_params(quant.quantize_params(params), dtype)
            tome.forward_quant(params, _images(cfg, dtype), cfg, 4)
        else:
            tome.forward_fused(_cast(params, dtype), _images(cfg, dtype), cfg, 4)
    _check_calls(k4_calls, k10_calls, cfg.depth, 0, dtype)
    counts = tome.schedule(cfg, 4)
    rows = [args[0].shape[0] for args, _ in k4_calls]
    assert rows == [2 * (cfg.seq_len - sum(counts[:l])) for l in range(cfg.depth)]
    assert rows[1] < 2 * cfg.seq_len  # a merged layer among them


# (dropout, drop-path): plain runs K4, regularized K10, drop-path only K4
# with the row scale composed around it
TOME_REG = {"plain": (0.0, 0.0), "regularized": (0.1, 0.1), "drop_path": (0.0, 0.1)}


def _tome_train_run(monkeypatch, reg, width, dtype):
    """models/tome.forward_train with K4's and K10's spies -> (cfg, K4
    calls, K10 calls)."""
    from vit_tpu_torch.models import tome

    cfg = _model_cfg(width, 64, *TOME_REG[reg])
    k4_calls, k10_calls = _spies(monkeypatch)
    rng = torch.Generator().manual_seed(3) if reg != "plain" else None
    tome.forward_train(_params(cfg, dtype, True), _images(cfg, dtype), cfg, 4, dropout_rng=rng)
    return cfg, k4_calls, k10_calls


@pytest.fixture(scope="module")
def tome_b16():
    """The B/16-width runs of the cases below, each once: their record."""
    return record(_tome_train_run, [(reg, "b16", dtype) for reg in TOME_REG for dtype in DTYPES])


@pytest.mark.parametrize("reg", list(TOME_REG))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tome_train_operands_pass(monkeypatch, request, reg, width, dtype):
    # models/tome.forward_train: OutResidualFn (K4) or OutResidualTrainFn
    # (K10) before each layer's merge; r = 4 with the training chunk of 2
    from vit_tpu_torch.models import tome

    cfg, k4_calls, k10_calls = (request.getfixturevalue("tome_b16")[reg, width, dtype]
                                if width == "b16"
                                else _tome_train_run(monkeypatch, reg, width, dtype))
    n10 = cfg.depth if reg == "regularized" else 0
    _check_calls(k4_calls, k10_calls, cfg.depth - n10, n10, dtype)
    counts = tome.schedule(cfg, 4, tome.TRAIN_MERGE_CHUNK)
    rows = [args[0].shape[0] for args, _ in k4_calls + k10_calls]
    assert rows == [2 * (cfg.seq_len - sum(counts[:l])) for l in range(cfg.depth)]
    assert counts[0] > 0 and rows[1] < 2 * cfg.seq_len


def test_bench_kernels_operands_pass(monkeypatch):
    # cli/bench_kernels' `b` run (B/16, one layer's W_o and b_o of its
    # 12-layer stack each call, ctx as its own residual), at batch 1; its
    # card check and timer made CPU ones
    from vit_tpu_torch.cli import bench_kernels
    from vit_tpu_torch.io import params as io_params

    monkeypatch.setattr(io_params, "device_or_raise", lambda device: torch.device("cpu"))
    monkeypatch.setattr(bench_kernels, "time_layers",
                        lambda body, x, weights: [body(x, w) for w in weights] and 1.0)
    k4_calls, k10_calls = _spies(monkeypatch)
    assert bench_kernels.main(["--batch", "1", "--which", "b"]) in (0, None)
    _check_calls(k4_calls, k10_calls, bench_kernels.L, 0, torch.bfloat16)
    assert all(args[0].shape == (197, 768) for args, _ in k4_calls)
