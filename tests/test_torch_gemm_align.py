"""The 16-byte operand rule of the bf16 GEMM core of K1 and K2, on the CPU.

K1 (``ln_qkv_attn``) and K2 (``out_ln_mlp_residual``) run their bf16 GEMMs
on ``csrc/gemm_mma.cuh``, which copies 16 bytes (8 bf16) per lane with
``cp.async``; their wrappers refuse an operand off the 16-byte grid or a
width that is not a multiple of 8 elements (``check_tile_operands``, over
``_build.check_tiles``).  These tests hold that rule on CPU tensors, and
show that every operand the port's own callers hand K1 and K2 passes it:
``fused_block`` (the classify block), ``models/tome.py`` (the hooked K1 of
the ToMe forwards, inference and training), ``ops/trainable.py`` (the
train block, plain and regularized) and ``parallel/tp_forward.py`` (K1 at
local heads on rank 0 and rank 1 of tp 2 and 4), at the tiny test config's
widths and at ViT-B/16's.  The callers run on the CPU (the wrappers take
their plain twins there); a spy records what they pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels import ln_qkv_attn as k1
from vit_tpu_torch.ops.kernels import out_ln_mlp_residual as k2

from torch_spy_record import record

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6


def _t(shape, dtype=torch.bfloat16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(
        dtype)


def test_check_tiles_accepts_and_refuses():
    w = _t((64, 192))
    _build.check_tiles("k", (("D", 64),), w=w)
    flat = _t((64 * 192 + 16,))
    _build.check_tiles("k", w=flat[8:8 + 64 * 192].view(64, 192))  # 16 bytes in: on the grid
    with pytest.raises(ValueError, match="k: w must start on a 16-byte boundary"):
        _build.check_tiles("k", w=flat[1:1 + 64 * 192].view(64, 192))
    with pytest.raises(ValueError, match="k: w is 100 elements wide"):
        _build.check_tiles("k", w=_t((64, 100)))
    with pytest.raises(ValueError, match="k: D is 60 elements wide"):
        _build.check_tiles("k", (("D", 60),), w=w)
    # a column slice keeps a row pitch of whole 16 bytes only at multiples of 8
    wide = _t((64, 200))
    _build.check_tiles("k", w=wide[:, :192])
    with pytest.raises(ValueError, match="16-byte boundary"):
        _build.check_tiles("k", w=wide[:, 4:196])


def test_wrappers_refuse_misaligned_views():
    x, s = _t((10, 64)), _t((64,))
    wqkv = _t((64 * 192 + 1,))[1:].view(64, 192)
    k1.check_tile_operands(x, s, s, _t((64, 192)))
    with pytest.raises(ValueError, match="ln_qkv_attn: wqkv must start"):
        k1.check_tile_operands(x, s, s, wqkv)
    with pytest.raises(ValueError, match="ln_qkv_attn: D is 60 elements wide"):
        k1.check_tile_operands(_t((10, 60)), s, s, _t((60, 192)))
    wo, w1, w2 = _t((64, 64)), _t((64, 256)), _t((256, 64))
    k2.check_tile_operands(x, x, wo, s, s, s, w1, s, w2)
    ctx = _t((10 * 64 + 1,))[1:].view(10, 64)
    with pytest.raises(ValueError, match="out_ln_mlp_residual: ctx must start"):
        k2.check_tile_operands(ctx, x, wo, s, s, s, w1, s, w2)
    with pytest.raises(ValueError, match="out_ln_mlp_residual: w1 is 260 elements wide"):
        k2.check_tile_operands(x, x, wo, s, s, s, _t((64, 260)), s, _t((260, 64)))


def _spy(monkeypatch, module, name):
    """Record every call's arguments to module.name, then make the call."""
    calls, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    spy.launches = 0
    monkeypatch.setattr(module, name, spy)
    return calls


def _spies(monkeypatch):
    return (_spy(monkeypatch, k1, "ln_qkv_attn"), _spy(monkeypatch, k2, "out_ln_mlp_residual"))


def _check_calls(k1_calls, k2_calls, n1, n2):
    assert (len(k1_calls), len(k2_calls)) == (n1, n2)
    for args, kwargs in k1_calls:
        k1.check_tile_operands(*args, **kwargs)
    for args, kwargs in k2_calls:
        k2.check_tile_operands(*args, **kwargs)


# (D, heads, MLP width): the tiny test config's and ViT-B/16's
WIDTHS = {"tiny": (64, 4, 256), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads,
                                        VIT_B_16.mlp_dim)}


def _block(d, f, dtype, grad=False):
    shapes = {"ln1_scale": (d,), "ln1_bias": (d,), "wqkv": (d, 3 * d), "bqkv": (3 * d,),
              "wo": (d, d), "bo": (d,), "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, f),
              "b1": (f,), "w2": (f, d), "b2": (d,)}
    blk = {k: _t(shape, dtype, 20 + i) * (shape[0] ** -0.5 if len(shape) == 2 else 0.2)
           for i, (k, shape) in enumerate(shapes.items())}
    return {k: v.requires_grad_(True) for k, v in blk.items()} if grad else blk


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_fused_block_operands_pass(monkeypatch, width, dtype):
    from vit_tpu_torch.ops import fused_block

    d, h, f = WIDTHS[width]
    k1_calls, k2_calls = _spies(monkeypatch)
    b, t = 2, 5
    out = fused_block.fused_encoder_block(_t((b * t, d), dtype, 1), _block(d, f, dtype), h, t, EPS)
    assert torch.isfinite(out.float()).all()
    _check_calls(k1_calls, k2_calls, 1, 1)


@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_train_block_operands_pass(monkeypatch, regularized, width, dtype):
    from vit_tpu_torch.ops import trainable

    d, h, f = WIDTHS[width]
    k1_calls, k2_calls = _spies(monkeypatch)
    b, t = 2, 5
    x, blk = _t((b * t, d), dtype, 1).requires_grad_(True), _block(d, f, dtype, grad=True)
    if regularized:
        out = trainable.encoder_block_train(x, blk, h, t, EPS, "exact", 7, 0.1, 0.1)
    else:
        out = trainable.encoder_block_trainable(x, blk, h, t, EPS)
    out.float().sum().backward()
    _check_calls(k1_calls, k2_calls, 1, 0)


def _tome_cfg(width):
    # 65 tokens, so r = 4 merges at every layer of the chunked schedules
    d, h, _ = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h,
                               image_size=64, patch_size=8, num_classes=11,
                               name=f"vit_tome_align_{width}")


def _tome_run(monkeypatch, train, width, dtype):
    """models/tome.forward_fused, or forward_train and its backward, with
    K1's and K2's spies -> (cfg, K1 calls, K2 calls)."""
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import tome, vit

    cfg = _tome_cfg(width)
    params = vit.init_params(torch.Generator().manual_seed(1), cfg)
    params = {k: v.to(dtype) if torch.is_tensor(v) else {n: x.to(dtype) for n, x in v.items()}
              for k, v in params.items()}
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    k1_calls, k2_calls = _spies(monkeypatch)
    if train:
        params = {k: v.requires_grad_(True) if torch.is_tensor(v)
                  else {n: x.requires_grad_(True) for n, x in v.items()} for k, v in params.items()}
        tome.forward_train(params, images, cfg, 4).float().sum().backward()
    else:
        assert torch.isfinite(tome.forward_fused(params, images, cfg, 4).float()).all()
    return cfg, k1_calls, k2_calls


@pytest.fixture(scope="module")
def tome_b16():
    """The B/16-width runs of the cases below, each once: their record."""
    return record(_tome_run, [(train, "b16", dtype) for train in (False, True)
                              for dtype in DTYPES])


@pytest.mark.parametrize("train", [False, True], ids=["forward_fused", "forward_train"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tome_operands_pass(monkeypatch, request, train, width, dtype):
    cfg, k1_calls, k2_calls = (request.getfixturevalue("tome_b16")[train, width, dtype]
                               if width == "b16" else _tome_run(monkeypatch, train, width, dtype))
    _check_calls(k1_calls, k2_calls, cfg.depth, 0)
    # layer 2 runs on merged tokens: the hooked K1, its log-size row beside
    # the checked operands
    log_size = k1_calls[1][1].get("log_size")
    assert log_size is not None and log_size.dtype == torch.float32
    assert log_size.is_contiguous()


def _tp_run(monkeypatch, tp, rank, width, dtype):
    """rank's shard of the block (W_qkv's columns of its heads: 3 D / tp
    wide, 1,152 and 576 at B/16) through ``fused_block_tp`` on a mesh whose
    all-reduces are no-ops -> the K1 and K2 calls."""
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.parallel import tp_forward
    from vit_tpu_torch.parallel.mesh import Mesh
    from vit_tpu_torch.parallel.sharding import shard_params

    d, h, f = WIDTHS[width]
    cfg = dataclasses.replace(VIT_B_16, depth=1, embed_dim=d, num_heads=h,
                              image_size=32, name=f"vit_tp_align_{width}")
    mesh = Mesh({"tp": tp}, rank, {"tp": None})
    params = vit.init_params(torch.Generator().manual_seed(1), cfg)
    params = {k: v.to(dtype) if torch.is_tensor(v) else {n: x.to(dtype) for n, x in v.items()}
              for k, v in params.items()}
    blk = vit.layers(shard_params(params, mesh)["blocks"])[0]
    assert blk["wqkv"].shape == (d, 3 * d // tp)
    k1_calls, k2_calls = _spies(monkeypatch)
    b, t = 2, 5
    out = tp_forward.fused_block_tp(_t((b * t, d), dtype, 1), blk, h // tp, t, EPS, "exact", mesh,
                                    quant=False)
    assert torch.isfinite(out.float()).all()
    return k1_calls, k2_calls


@pytest.fixture(scope="module")
def tp_b16():
    """The B/16-width runs of the cases below, each once: their record."""
    return record(_tp_run, [(tp, rank, "b16", dtype) for tp in (2, 4) for rank in (0, 1)
                            for dtype in DTYPES])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("rank", [0, 1])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tp_local_heads_operands_pass(monkeypatch, request, tp, rank, width, dtype):
    k1_calls, k2_calls = (request.getfixturevalue("tp_b16")[tp, rank, width, dtype]
                          if width == "b16" else _tp_run(monkeypatch, tp, rank, width, dtype))
    _check_calls(k1_calls, k2_calls, 1, 0)
