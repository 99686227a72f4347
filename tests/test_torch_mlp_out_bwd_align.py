"""The operand rule of the bf16 K7 and K12a, on the CPU.

The bf16 K7 (``ln_mlp_out_residual_bwd``) and K12a
(``ln_mlp_out_residual_bwd_train``) run their seven GEMMs on
``csrc/gemm_mma.cuh`` (``csrc/mlp_bwd_mma.cuh``'s chain with the out_proj
tail), whose TMA tensor maps read dy, ctx, w1, w2 and wo (and the scratches
whose pitches D and F set) in rows of whole 16 bytes; their wrappers refuse
an operand off the 16-byte grid or a width (D, F, d_ctx) that is not a
multiple of 8 elements (``check_tile_operands``, over
``_build.check_tiles``).  These tests hold that rule on CPU tensors, and
show that every operand the port's own callers hand K7 and K12a passes it:
``ops/trainable``'s plain and regularized block autograd functions, through
``ops/backward.fused_encoder_block_bwd`` and
``fused_encoder_block_bwd_train``, alone and inside the ``fused_train``
model, at the tiny test config's widths and at ViT-B/16's.  The callers run
on the CPU (the wrappers take their plain twins there); a spy records what
they pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd as k7
from vit_tpu_torch.ops.kernels import ln_mlp_out_residual_bwd_train as k12a

from torch_spy_record import record

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
# (D, heads, MLP width): the tiny test config's and ViT-B/16's
WIDTHS = {"tiny": (64, 4, 256), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads,
                                        VIT_B_16.mlp_dim)}
KERNELS = {"k7": k7, "k12a": k12a}
# the wrappers' operands the rule names, by position
OPERANDS = [(0, "dy"), (1, "x1"), (2, "ctx"), (5, "w1"), (7, "w2"), (8, "wo")]


def _t(shape, dtype=torch.bfloat16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(
        dtype)


def _off(t):
    """The same shape, contiguous, one element past the 16-byte grid."""
    return _t((t.numel() + 1,), t.dtype)[1:].view(*t.shape)


def _args(rows, d, f, d_ctx=None, dtype=torch.bfloat16):
    """K7's leading operands (dy, x1, ctx, ln_scale, ln_bias, w1, b1, w2, wo)."""
    d_ctx = d if d_ctx is None else d_ctx
    return (_t((rows, d), dtype, 1), _t((rows, d), dtype, 2), _t((rows, d_ctx), dtype, 3),
            _t((d,), dtype, 4), _t((d,), dtype, 5), _t((d, f), dtype, 6), _t((f,), dtype, 7),
            _t((f, d), dtype, 8), _t((d_ctx, d), dtype, 9))


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_aligned_operands_pass(kernel, width, dtype):
    d, _, f = WIDTHS[width]
    args = _args(10, d, f, dtype=dtype)
    KERNELS[kernel].check_tile_operands(*args)
    # a view 16 bytes into a buffer is on the grid
    flat = _t((10 * d + 16,), dtype)
    step = 16 // flat.element_size()
    KERNELS[kernel].check_tile_operands(flat[step:step + 10 * d].view(10, d), *args[1:])


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("i,name", OPERANDS)
def test_off_grid_views_are_refused(kernel, width, i, name):
    d, _, f = WIDTHS[width]
    args = list(_args(10, d, f))
    args[i] = _off(args[i])
    with pytest.raises(ValueError, match=f"{KERNELS[kernel].__name__.rsplit('.', 1)[1]}: "
                                         f"{name} must start on a 16-byte boundary"):
        KERNELS[kernel].check_tile_operands(*args)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("d,f,d_ctx,what", [(60, 256, 60, "dy is 60"), (64, 252, 64, "w1 is 252"),
                                            (64, 256, 60, "ctx is 60"),
                                            (100, 400, 100, "dy is 100")])
def test_widths_off_the_grid_are_refused(kernel, d, f, d_ctx, what):
    with pytest.raises(ValueError, match=f"{what} elements wide.*multiples of 8"):
        KERNELS[kernel].check_tile_operands(*_args(10, d, f, d_ctx))


def _spy(monkeypatch, module, name):
    """Record every call's arguments to module.name, then make the call."""
    calls, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _spies(monkeypatch):
    return (_spy(monkeypatch, k7, "ln_mlp_out_residual_bwd"),
            _spy(monkeypatch, k12a, "ln_mlp_out_residual_bwd_train"))


def _check_calls(k7_calls, k12a_calls, n7, n12a, rows):
    assert (len(k7_calls), len(k12a_calls)) == (n7, n12a)
    for args, kwargs in k7_calls:
        k7.check_tile_operands(*args, **kwargs)
    for args, kwargs in k12a_calls:
        k12a.check_tile_operands(*args, **kwargs)
    assert all(args[0].shape[0] == rows for args, _ in k7_calls + k12a_calls)


def _block(d, f, dtype):
    shapes = {"ln1_scale": (d,), "ln1_bias": (d,), "wqkv": (d, 3 * d), "bqkv": (3 * d,),
              "wo": (d, d), "bo": (d,), "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, f),
              "b1": (f,), "w2": (f, d), "b2": (d,)}
    return {k: (_t(shape, dtype, 20 + i) * (shape[0] ** -0.5 if len(shape) == 2 else 0.2))
            .requires_grad_(True) for i, (k, shape) in enumerate(shapes.items())}


@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_block_operands_pass(monkeypatch, regularized, width, dtype):
    # FusedEncoderBlockFn (K7) and FusedEncoderBlockTrainFn (K12a), T 7
    from vit_tpu_torch.ops import trainable

    d, h, f = WIDTHS[width]
    k7_calls, k12a_calls = _spies(monkeypatch)
    b, t = 2, 7
    x = _t((b * t, d), dtype, 1).requires_grad_(True)
    blk = _block(d, f, dtype)
    if regularized:
        out = trainable.encoder_block_train(x, blk, h, t, EPS, "exact", 2 ** 31 + 11, 0.1, 0.1)
    else:
        out = trainable.encoder_block_trainable(x, blk, h, t, EPS)
    out.float().sum().backward()
    assert torch.isfinite(x.grad.float()).all()
    _check_calls(k7_calls, k12a_calls, *((0, 1) if regularized else (1, 0)), b * t)


def _model_cfg(width, dropout=0.0, drop_path=0.0):
    # 17 tokens, two layers (the MLP width D x mlp_ratio, as WIDTHS)
    d, h, _ = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h, image_size=32,
                               patch_size=8, num_classes=11, dropout=dropout,
                               drop_path=drop_path, name=f"vit_mlp_out_bwd_{width}")


def _model_run(monkeypatch, regularized, width, dtype):
    """The ``fused_train`` model's forward and backward with K7's and
    K12a's spies -> (cfg, K7 calls, K12a calls)."""
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import get_ops

    cfg = _model_cfg(width, *((0.1, 0.1) if regularized else ()))
    params = vit.init_params(torch.Generator().manual_seed(1), cfg)
    params = {k: v.to(dtype).requires_grad_(True) if torch.is_tensor(v)
              else {n: x.to(dtype).requires_grad_(True) for n, x in v.items()}
              for k, v in params.items()}
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    k7_calls, k12a_calls = _spies(monkeypatch)
    rng = torch.Generator().manual_seed(3) if regularized else None
    logits = vit.forward(params, images, cfg, get_ops("fused_train"), dropout_rng=rng)
    logits.float().sum().backward()
    return cfg, k7_calls, k12a_calls


@pytest.fixture(scope="module")
def model_b16():
    """The B/16-width runs of the cases below, each once: their record."""
    return record(_model_run, [(reg, "b16", dtype) for reg in (False, True) for dtype in DTYPES])


@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_fused_train_model_operands_pass(monkeypatch, request, regularized, width, dtype):
    cfg, k7_calls, k12a_calls = (request.getfixturevalue("model_b16")[regularized, width, dtype]
                                 if width == "b16"
                                 else _model_run(monkeypatch, regularized, width, dtype))
    # one K7 (or K12a) per layer, each over the whole batch's rows
    _check_calls(k7_calls, k12a_calls, *((0, cfg.depth) if regularized else (cfg.depth, 0)),
                 2 * cfg.seq_len)
