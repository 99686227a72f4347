"""The operand rule of the bf16 K8 and K12b, and the core's backward forms'
plain twin, on the CPU.

The bf16 K8 (``ln_mlp_residual_bwd``) and K12b (``ln_mlp_residual_bwd_train``)
run their five GEMMs on ``csrc/gemm_mma.cuh``, whose TMA tensor maps read
dy, w1 and w2 (and the scratches whose pitches D and F set) in rows of
whole 16 bytes; their wrappers refuse an operand off the 16-byte grid or a
width that is not a multiple of 8 elements (``check_tile_operands``, over
``_build.check_tiles``).  These tests hold that rule on CPU tensors, and
show that every operand the port's own callers hand K8 and K12b passes it:
``ops/trainable.LnMlpResidualFn`` in the long-sequence block (past the
1,024-token switch, reached at tiny T by lowering the switch),
``models/tome.forward_train`` plain (K8) and regularized (K12b), and
``ops/trainable.LnMlpResidualTrainFn`` alone, at the tiny test config's
widths and at ViT-B/16's.  The callers run on the CPU (the wrappers take
their plain twins there); a spy records what they pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops.kernels import gemm_bf16 as core
from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd as k8
from vit_tpu_torch.ops.kernels import ln_mlp_residual_bwd_train as k12b

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
# (D, heads, MLP width): the tiny test config's and ViT-B/16's
WIDTHS = {"tiny": (64, 4, 256), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads,
                                        VIT_B_16.mlp_dim)}
KERNELS = {"k8": k8, "k12b": k12b}


def _t(shape, dtype=torch.bfloat16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(
        dtype)


def _off(shape):
    """Contiguous, one bf16 element past the 16-byte grid."""
    return _t((int(np.prod(shape)) + 1,))[1:].view(*shape)


def _args(rows, d, f):
    return (_t((rows, d), seed=1), _t((rows, d), seed=2), _t((d,), seed=3), _t((d,), seed=4),
            _t((d, f), seed=5), _t((f,), seed=6), _t((f, d), seed=7))


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_aligned_operands_pass(kernel):
    KERNELS[kernel].check_tile_operands(*_args(10, 64, 256))
    # a view 16 bytes into a buffer is on the grid
    flat = _t((10 * 64 + 8,))
    dy = flat[8:].view(10, 64)
    KERNELS[kernel].check_tile_operands(dy, *_args(10, 64, 256)[1:])


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("i,name", [(0, "dy"), (1, "x1"), (4, "w1"), (6, "w2")])
def test_off_grid_views_are_refused(kernel, i, name):
    args = list(_args(10, 64, 256))
    args[i] = _off(tuple(args[i].shape))
    with pytest.raises(ValueError, match=f"{KERNELS[kernel].__name__.rsplit('.', 1)[1]}: "
                                         f"{name} must start on a 16-byte boundary"):
        KERNELS[kernel].check_tile_operands(*args)


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("d,f,what", [(60, 256, "dy is 60"), (64, 252, "w1 is 252"),
                                      (100, 400, "dy is 100")])
def test_widths_off_the_grid_are_refused(kernel, d, f, what):
    with pytest.raises(ValueError, match=f"{what} elements wide.*multiples of 8"):
        KERNELS[kernel].check_tile_operands(*_args(10, d, f))


def _spy(monkeypatch, module, name):
    """Record every call's arguments to module.name, then make the call."""
    calls, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _spies(monkeypatch):
    return (_spy(monkeypatch, k8, "ln_mlp_residual_bwd"),
            _spy(monkeypatch, k12b, "ln_mlp_residual_bwd_train"))


def _check_calls(k8_calls, k12b_calls, n8, n12b):
    assert (len(k8_calls), len(k12b_calls)) == (n8, n12b)
    for args, kwargs in k8_calls:
        k8.check_tile_operands(*args, **kwargs)
    for args, kwargs in k12b_calls:
        k12b.check_tile_operands(*args, **kwargs)


def _block(d, f, dtype):
    shapes = {"ln1_scale": (d,), "ln1_bias": (d,), "wqkv": (d, 3 * d), "bqkv": (3 * d,),
              "wo": (d, d), "bo": (d,), "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, f),
              "b1": (f,), "w2": (f, d), "b2": (d,)}
    return {k: (_t(shape, dtype, 20 + i) * (shape[0] ** -0.5 if len(shape) == 2 else 0.2))
            .requires_grad_(True) for i, (k, shape) in enumerate(shapes.items())}


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_long_block_operands_pass(monkeypatch, width, dtype):
    # the @512 path's block (K4/K9, K5/K8 around flash attention), reached
    # at T 5 by lowering the 1,024-token switch, as tests/test_torch_flash.py
    # does
    from vit_tpu_torch.ops import fused_block, trainable

    monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    d, h, f = WIDTHS[width]
    k8_calls, k12b_calls = _spies(monkeypatch)
    b, t = 2, 5
    x = _t((b * t, d), dtype, 1).requires_grad_(True)
    out = trainable.encoder_block_trainable(x, _block(d, f, dtype), h, t, EPS)
    out.float().sum().backward()
    assert torch.isfinite(x.grad.float()).all()
    _check_calls(k8_calls, k12b_calls, 1, 0)


def _tome_cfg(width, dropout=0.0, drop_path=0.0):
    # 65 tokens; r = 4 with the training chunk of 2 merges 8 at layer 0
    d, h, _ = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h,
                               image_size=64, patch_size=8, num_classes=11, dropout=dropout,
                               drop_path=drop_path, name=f"vit_tome_mlp_bwd_{width}")


@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tome_train_operands_pass(monkeypatch, regularized, width, dtype):
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import tome, vit

    cfg = _tome_cfg(width, *((0.1, 0.1) if regularized else ()))
    params = vit.init_params(torch.Generator().manual_seed(1), cfg)
    params = {k: v.to(dtype).requires_grad_(True) if torch.is_tensor(v)
              else {n: x.to(dtype).requires_grad_(True) for n, x in v.items()}
              for k, v in params.items()}
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    k8_calls, k12b_calls = _spies(monkeypatch)
    rng = torch.Generator().manual_seed(3) if regularized else None
    tome.forward_train(params, images, cfg, 4, dropout_rng=rng).float().sum().backward()
    # every layer's MLP half, each after its layer's merge: ragged row counts
    _check_calls(k8_calls, k12b_calls, *((0, cfg.depth) if regularized else (cfg.depth, 0)))
    counts = tome.schedule(cfg, 4, tome.TRAIN_MERGE_CHUNK)
    rows = [args[0].shape[0] for args, _ in (k12b_calls if regularized else k8_calls)]
    # autograd runs the layers' backwards last layer first
    assert rows == [2 * (cfg.seq_len - sum(counts[:l + 1])) for l in range(cfg.depth)][::-1]
    assert counts[0] > 0  # every MLP half runs on merged tokens


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_ln_mlp_residual_train_fn_operands_pass(monkeypatch, width, dtype):
    from vit_tpu_torch.ops import trainable
    from vit_tpu_torch.ops.fused_block import drop_path_scale_rows

    d, _, f = WIDTHS[width]
    blk = _block(d, f, dtype)
    b, t = 2, 7
    x1 = _t((b * t, d), dtype, 1).requires_grad_(True)
    dp = drop_path_scale_rows(11, 5, b, t, 0.1, device=x1.device)
    k8_calls, k12b_calls = _spies(monkeypatch)
    y = trainable.LnMlpResidualTrainFn.apply(
        x1, blk["ln2_scale"], blk["ln2_bias"], blk["w1"], blk["b1"], blk["w2"], blk["b2"], dp,
        11, 0.1, EPS, "exact")
    y.float().sum().backward()
    _check_calls(k8_calls, k12b_calls, 0, 1)


# the core's backward forms: the plain twin transposes as asked, and the
# split leaves the fp32 product as it is (it moves the kernel's summation
# order only)
@pytest.mark.parametrize("trans_a,trans_b", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("splits", [1, 0, 3])
def test_gemm_core_forms_plain_twin(trans_a, trans_b, splits):
    m, k, n = 24, 40, 16
    a = _t((k, m) if trans_a else (m, k), seed=1)
    b = _t((n, k) if trans_b else (k, n), seed=2)
    want = (_t((k, m), torch.float32, 1).T if trans_a else _t((m, k), torch.float32, 1)) @ (
        _t((n, k), torch.float32, 2).T if trans_b else _t((k, n), torch.float32, 2))
    a_ref = a.float().T if trans_a else a.float()
    b_ref = b.float().T if trans_b else b.float()
    got = core.gemm_bf16(a, b, trans_a, trans_b, splits)
    assert got.shape == (m, n) and got.dtype == torch.float32
    assert torch.equal(got, a_ref @ b_ref)
    # the bf16 operands are the fp32 ones rounded: within bf16's 2^-8 of the scale
    assert (got - want).abs().max() <= 2.0 ** -6 * want.abs().max()
