"""The operand rule of the bf16 K9 and K12c, on the CPU.

The bf16 K9 (``out_residual_bwd``) and K12c (``out_residual_bwd_train``) run
the bf16 K7's out_proj tail (``out_proj_bwd_mma``, ``csrc/mlp_bwd_mma.cuh``)
on ``csrc/gemm_mma.cuh``, whose TMA tensor maps read dx1 (K12c: the gated
scratch whose pitch D sets), ctx and wo in rows of whole 16 bytes; their
wrappers refuse an operand off the 16-byte grid or a width (D, d_ctx) that
is not a multiple of 8 elements (``check_tile_operands``, over
``_build.check_tiles``), and only in bf16: fp32 keeps ``gemm.cuh``'s FMA
core, which takes any width.  These tests hold that rule on CPU tensors,
then at the wrappers' own gate on meta tensors (which stand in for CUDA
ones: a meta view's address is its offset, so an off-grid view stays off
the grid) with the library faked, and show that every operand the port's
own callers hand K9 and K12c passes it: ``ops/trainable.OutResidualFn`` in
the long-sequence train block (past the 1,024-token switch, reached at tiny
T by lowering the switch) alone and in the ``fused_train`` model, and
``models/tome.forward_train`` plain (K9), regularized (K12c) and with
drop-path only (K9 around the row scale), at the tiny test config's widths
and at ViT-B/16's.  The callers run on the CPU (the wrappers take their
plain twins there); a spy records what they pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels import out_residual_bwd as k9
from vit_tpu_torch.ops.kernels import out_residual_bwd_train as k12c

from torch_spy_record import record

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
# (D, heads, MLP width): the tiny test config's and ViT-B/16's
WIDTHS = {"tiny": (64, 4, 256), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads,
                                        VIT_B_16.mlp_dim)}
KERNELS = {"k9": k9, "k12c": k12c}
# each kernel's entry point
ENTRY = {"k9": "out_residual_bwd", "k12c": "out_residual_bwd_train"}
OPERANDS = [(0, "dx1"), (1, "ctx"), (2, "wo")]


def _t(shape, dtype=torch.bfloat16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(
        dtype)


def _off(t):
    """The same shape and device, contiguous, one element past the 16-byte
    grid."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(*t.shape)


def _args(rows, d, d_ctx=None, dtype=torch.bfloat16, device="cpu"):
    """K9's operands (dx1, ctx, wo); K12c adds (dp_attn, seed, dropout_p)."""
    d_ctx = d if d_ctx is None else d_ctx
    if device == "meta":
        return tuple(torch.empty(s, dtype=dtype, device=device)
                     for s in ((rows, d), (rows, d_ctx), (d_ctx, d)))
    return _t((rows, d), dtype, 1), _t((rows, d_ctx), dtype, 2), _t((d_ctx, d), dtype, 3)


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
    # a view 16 bytes into a buffer is on the grid
    flat = _t((10 * d + 16,), dtype)
    step = 16 // flat.element_size()
    KERNELS[kernel].check_tile_operands(flat[step:step + 10 * d].view(10, d), *args[1:])


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
@pytest.mark.parametrize("d,d_ctx,what", [(60, 64, "dx1 is 60"), (64, 60, "ctx is 60"),
                                          (100, 100, "dx1 is 100"), (64, 76, "ctx is 76")])
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
    monkeypatch.setattr(_build, "workspace", lambda *a: torch.empty(0, dtype=torch.uint8))
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "check", lambda rc, name: None)
    return launched


def _call(kernel, args):
    return getattr(KERNELS[kernel], ENTRY[kernel])(*(_reg(args) if kernel == "k12c" else args))


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
@pytest.mark.parametrize("off", [None, 0, 1, 2], ids=["aligned", "dx1", "ctx", "wo"])
@pytest.mark.parametrize("d,d_ctx", [(64, 64), (60, 76)])
def test_wrapper_takes_fp32_anywhere(fake_card, kernel, off, d, d_ctx):
    # fp32 runs gemm.cuh's FMA core: any width, any element offset
    args = list(_args(10, d, d_ctx, torch.float32, device="meta"))
    if off is not None:
        args[off] = _off(args[off])
    dctx, dwo, dbo = _call(kernel, args)
    assert fake_card == ["vt_" + ENTRY[kernel]]
    assert (dctx.shape, dwo.shape, dbo.shape) == ((10, d_ctx), (d_ctx, d), (d,))


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wrapper_launches_aligned_bf16(fake_card, kernel):
    dctx, dwo, dbo = _call(kernel, _args(10, 64, 96, device="meta"))
    assert fake_card == ["vt_" + ENTRY[kernel]]
    assert (dctx.dtype, dwo.dtype, dbo.dtype) == (torch.bfloat16, torch.float32, torch.float32)


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
    return (_spy(monkeypatch, k9, "out_residual_bwd"),
            _spy(monkeypatch, k12c, "out_residual_bwd_train"))


def _check_calls(k9_calls, k12c_calls, n9, n12c):
    assert (len(k9_calls), len(k12c_calls)) == (n9, n12c)
    for args, kwargs in k9_calls:
        k9.check_tile_operands(*args, **kwargs)
    for args, kwargs in k12c_calls:
        k12c.check_tile_operands(*args, **kwargs)


def _block(d, f, dtype):
    shapes = {"ln1_scale": (d,), "ln1_bias": (d,), "wqkv": (d, 3 * d), "bqkv": (3 * d,),
              "wo": (d, d), "bo": (d,), "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, f),
              "b1": (f,), "w2": (f, d), "b2": (d,)}
    return {k: (_t(shape, dtype, 20 + i) * (shape[0] ** -0.5 if len(shape) == 2 else 0.2))
            .requires_grad_(True) for i, (k, shape) in enumerate(shapes.items())}


def _cast(params, dtype):
    return {k: v.to(dtype).requires_grad_(True) if torch.is_tensor(v)
            else {n: x.to(dtype).requires_grad_(True) for n, x in v.items()}
            for k, v in params.items()}


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_long_block_operands_pass(monkeypatch, width, dtype):
    # the @512 path's block (K4/K9 after flash attention), reached at T 5
    # by lowering the 1,024-token switch, as tests/test_torch_flash.py does:
    # ctx is K13's packed context, dx1 the MLP backward's dx1 plus the
    # residual's gradient
    from vit_tpu_torch.ops import fused_block, trainable

    monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    d, h, f = WIDTHS[width]
    k9_calls, k12c_calls = _spies(monkeypatch)
    b, t = 2, 5
    x = _t((b * t, d), dtype, 1).requires_grad_(True)
    out = trainable.encoder_block_trainable(x, _block(d, f, dtype), h, t, EPS)
    out.float().sum().backward()
    assert torch.isfinite(x.grad.float()).all()
    _check_calls(k9_calls, k12c_calls, 1, 0)
    assert k9_calls[0][0][0].shape == (b * t, d)


def _model_cfg(width, image_size, dropout=0.0, drop_path=0.0, name="long"):
    d, h, _ = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h,
                               image_size=image_size, patch_size=8, num_classes=11,
                               dropout=dropout, drop_path=drop_path,
                               name=f"vit_out_bwd_{name}_{width}")


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_fused_train_long_model_operands_pass(monkeypatch, width, dtype):
    # the fused_train model past the (lowered) switch: one K9 per layer
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import fused_block, get_ops

    monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    cfg = _model_cfg(width, 32)  # 17 tokens
    params = _cast(vit.init_params(torch.Generator().manual_seed(1), cfg), dtype)
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    k9_calls, k12c_calls = _spies(monkeypatch)
    vit.forward(params, images, cfg, get_ops("fused_train")).float().sum().backward()
    _check_calls(k9_calls, k12c_calls, cfg.depth, 0)
    assert all(args[0].shape[0] == 2 * cfg.seq_len for args, _ in k9_calls)


# (dropout, drop-path): plain runs K9, regularized K12c, drop-path only K9
# with the row scale composed around it
TOME_REG = {"plain": (0.0, 0.0), "regularized": (0.1, 0.1), "drop_path": (0.0, 0.1)}


def _tome_train_run(monkeypatch, reg, width, dtype):
    """models/tome.forward_train and its backward with K9's and K12c's spies
    -> (cfg, K9 calls, K12c calls)."""
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import tome, vit

    dropout, drop_path = TOME_REG[reg]
    cfg = _model_cfg(width, 64, dropout, drop_path, "tome")
    params = _cast(vit.init_params(torch.Generator().manual_seed(1), cfg), dtype)
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    k9_calls, k12c_calls = _spies(monkeypatch)
    rng = torch.Generator().manual_seed(3) if reg != "plain" else None
    tome.forward_train(params, images, cfg, 4, dropout_rng=rng).float().sum().backward()
    return cfg, k9_calls, k12c_calls


@pytest.fixture(scope="module")
def tome_b16():
    """The B/16-width runs of the cases below, each once: their record."""
    return record(_tome_train_run, [(reg, "b16", dtype) for reg in TOME_REG for dtype in DTYPES])


@pytest.mark.parametrize("reg", list(TOME_REG))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tome_train_operands_pass(monkeypatch, request, reg, width, dtype):
    # 65 tokens; r = 4 with the training chunk of 2 merges 8 at layer 0:
    # ctx is each layer's context at its merged count, dx1 the merge GEMM's
    # backward plus the MLP half's
    from vit_tpu_torch.models import tome

    cfg, k9_calls, k12c_calls = (request.getfixturevalue("tome_b16")[reg, width, dtype]
                                 if width == "b16"
                                 else _tome_train_run(monkeypatch, reg, width, dtype))
    n12c = cfg.depth if reg == "regularized" else 0
    _check_calls(k9_calls, k12c_calls, cfg.depth - n12c, n12c)
    counts = tome.schedule(cfg, 4, tome.TRAIN_MERGE_CHUNK)
    rows = [args[0].shape[0] for args, _ in k9_calls + k12c_calls]
    # each layer's out_proj half runs before its merge, at the count the
    # earlier layers left; autograd runs the layers' backwards last first
    assert rows == [2 * (cfg.seq_len - sum(counts[:l])) for l in range(cfg.depth)][::-1]
    assert counts[0] > 0 and rows[0] < 2 * cfg.seq_len  # a merged layer among them
