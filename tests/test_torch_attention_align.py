"""The 16-byte operand rule of K21, K13 and K14 on the CPU.

K21 (``scaled_dot_product_attention``), K13 (``flash_attention_fwd``, bf16)
and K14 (``flash_attention_bwd``) read and write 16 bytes per lane on the
card, so their wrappers refuse any (batch, head, token, dh) view whose base
address or strides are off the 16-byte grid (``_build.check_aligned``).
These tests hold the helper to that rule on CPU tensors, and show that
every view the port's own callers hand to the three wrappers passes it:
``attention()``'s packed views (alone, inside the ``per_op`` forward, and
past the switch to K13), ``FlashAttentionFn`` and ``FlashContextFn``'s
packed QKV, dQKV and context — the latter through every long block that
reaches it (``fused``, ``fused_train``, ``quant`` and the tensor-parallel
context at local heads) — at the tiny test config's widths and at
ViT-B/16's, and at head widths 64 and 80.  The callers run on the CPU (the
wrappers take their plain twins there); a spy records what they pass.
"""

import numpy as np
import pytest
import torch

from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_context_from_packed_qkv,
    packed_views,
)
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels import attention as k21
from vit_tpu_torch.ops.kernels import flash_attention as k13
from vit_tpu_torch.ops.kernels import flash_attention_bwd as k14

DTYPES = [torch.float32, torch.bfloat16]
HEAD_DIMS = [16, 32, 64, 80, 128]


def _t(shape, dtype, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(
        dtype)


def _refused(**views):
    with pytest.raises(ValueError, match="16-byte boundary") as err:
        _build.check_aligned("k", **views)
    return str(err.value)


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("dh", HEAD_DIMS)
def test_check_aligned_accepts_and_refuses(dh, dtype):
    b, h, t = 2, 3, 7
    size = torch.tensor([], dtype=dtype).element_size()
    # accepted: a contiguous (B, H, T, dh) tensor, the packed QKV's views,
    # and a slice whose offset is a whole 16 bytes
    _build.check_aligned("k", x=_t((b, h, t, dh), dtype))
    q, k, v = packed_views(_t((b * t, 3 * h * dh), dtype), b, t, h, 3)
    _build.check_aligned("k", q=q, k=k, v=v)
    flat = _t((b * h * t * dh + 64,), dtype)
    whole = 16 // size
    _build.check_aligned("k", x=flat[whole:whole + b * h * t * dh].view(b, h, t, dh))
    # refused: an offset slice (one element in), naming the operand
    msg = _refused(q=q, k=flat[1:1 + b * h * t * dh].view(b, h, t, dh))
    assert msg.startswith("k: k must start")
    # refused: token strides of one element over and of 16 bytes less one
    # element over the packed row
    for extra in (1, 16 // size - 1):
        wide = _t((b * t, 3 * h * dh + extra), dtype)
        qw, kw, vw = packed_views(wide[:, :3 * h * dh], b, t, h, 3)
        assert (qw.stride(2) * size) % 16
        assert _refused(q=qw).startswith("k: q must start")
    # refused: a head stride off the grid with an aligned token stride
    odd_head = _t((b, t, h, dh + 16 // size + 1), dtype)[..., :dh].permute(0, 2, 1, 3)
    assert _refused(v=odd_head).startswith("k: v must start")
    # axes of length 1 are never stepped: their strides do not count
    one = _t((1, 1, 1, dh + 1), dtype)[..., :dh]
    _build.check_aligned("k", x=one)


def _spy(monkeypatch, module, name):
    """Record every call's arguments to module.name, then make the call."""
    calls, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    spy.launches = 0  # the real wrapper counts its launches on its module-level name
    monkeypatch.setattr(module, name, spy)
    return calls


def _k21_views(args, kwargs):
    """The (B, H, T, dh) views K21's wrapper hands its kernel."""
    q4, k4, v4 = k21._flat_views(*args[:3])
    out = kwargs.get("out", args[3] if len(args) > 3 else None)
    views = dict(q=q4, k=k4, v=v4)
    if out is not None:
        views["out"] = out.view(q4.shape)
    return views


def _k14_views(args, kwargs):
    """The views K14's wrapper hands its kernels, and the saved context
    (``out``, read only by the torch reduction for delta)."""
    q, k, v, out, _lse, do, *grads = args
    views = dict(q=q, k=k, v=v, out=out, do=do)
    grads = grads or [kwargs.get(n) for n in ("dq", "dk", "dv")]
    views.update({n: g for n, g in zip(("dq", "dk", "dv"), grads) if g is not None})
    return views


WIDTHS = {"tiny": (64, 4, 5), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads, 197)}


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_attention_packed_views_pass(monkeypatch, width, dtype):
    d, h, t = WIDTHS[width]
    calls = _spy(monkeypatch, k21, "scaled_dot_product_attention")
    b = 2
    x = _t((b, t, d), dtype, 1)
    wqkv, bqkv = _t((d, 3 * d), dtype, 2) * d ** -0.5, _t((3 * d,), dtype, 3)
    wo, bo = _t((d, d), dtype, 4) * d ** -0.5, _t((d,), dtype, 5)
    assert k21.attention(x, wqkv, bqkv, wo, bo, h).shape == (b, t, d)
    assert len(calls) == 1
    views = _k21_views(*calls[0])
    assert set(views) == {"q", "k", "v", "out"}
    assert views["q"].stride(2) == 3 * d  # the packed QKV, read in place
    _build.check_aligned("scaled_dot_product_attention", **views)


def test_per_op_forward_views_pass(monkeypatch, tiny_cfg):
    from vit_tpu.io import weights as wio
    from vit_tpu.io.images import synth_images
    from vit_tpu_torch.io.params import params_from_numpy
    from vit_tpu_torch.models import vit as tvit
    from vit_tpu_torch.ops.dispatch import get_ops

    calls = _spy(monkeypatch, k21, "scaled_dot_product_attention")
    tree = wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=1), tiny_cfg)
    images = torch.from_numpy(synth_images(2, tiny_cfg, seed=2))
    out = tvit.forward(params_from_numpy(tree, "cpu"), images, tiny_cfg, get_ops("per_op"))
    assert out.shape == (2, tiny_cfg.num_classes)
    assert len(calls) == tiny_cfg.depth
    for call in calls:
        _build.check_aligned("scaled_dot_product_attention", **_k21_views(*call))


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_flash_context_views_pass(monkeypatch, width, dtype):
    # FlashContextFn: the packed (B*T, 3D) QKV, its packed dQKV and the
    # (B*T, D) context, as every long path (fused, quant, trainable, tp) uses it
    d, h, t = WIDTHS[width]
    calls = _spy(monkeypatch, k14, "flash_attention_bwd")
    b = 2
    qkv = _t((b * t, 3 * d), dtype, 6).requires_grad_(True)
    ctx = flash_context_from_packed_qkv(qkv, b, t, h)
    ctx.backward(_t((b * t, d), dtype, 7))
    assert len(calls) == 1 and qkv.grad.shape == qkv.shape
    views = _k14_views(*calls[0])
    assert set(views) == {"q", "k", "v", "out", "do", "dq", "dk", "dv"}
    assert views["dq"].stride(2) == 3 * d  # written into the packed dQKV in place
    _build.check_aligned("flash_attention_bwd", **views)


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_flash_attention_fn_views_pass(monkeypatch, width, dtype):
    d, h, t = WIDTHS[width]
    dh = d // h
    calls = _spy(monkeypatch, k14, "flash_attention_bwd")
    q, k, v = (_t((2, h, t, dh), dtype, 8 + i).requires_grad_(True) for i in range(3))
    flash_attention(q, k, v).backward(_t((2, h, t, dh), dtype, 11))
    assert len(calls) == 1
    _build.check_aligned("flash_attention_bwd", **_k14_views(*calls[0]))


# (D, heads) of the views K13 is handed: the tiny test config's (dh 16),
# tiny widths at dh 64 and 80, ViT-B/16's (dh 64) and ViT-H/14's (dh 80)
K13_WIDTHS = {"tiny": (64, 4), "tiny_dh64": (128, 2), "tiny_dh80": (160, 2), "b16": (768, 12),
              "h14_dh80": (1280, 16)}
EPS = 1e-6


def _block_params(d, dtype, quant=False):
    """One encoder block's params at width D (MLP width D), in ``dtype``;
    int8 QKV and MLP weights with their scales when ``quant``."""
    from vit_tpu_torch.ops.quant import quantize_weight

    shapes = {"ln1_scale": (d,), "ln1_bias": (d,), "wqkv": (d, 3 * d), "bqkv": (3 * d,),
              "wo": (d, d), "bo": (d,), "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, d),
              "b1": (d,), "w2": (d, d), "b2": (d,)}
    blk = {k: _t(shape, dtype, 20 + i) * (d ** -0.5 if len(shape) == 2 else 0.2)
           for i, (k, shape) in enumerate(shapes.items())}
    if quant:
        for k in ("wqkv", "w1", "w2"):
            w_q, scale = quantize_weight(blk[k])
            blk[k], blk[k + "_scale"] = w_q, scale
    return blk


def _k13_caller(caller, x2d, b, t, d, h, dtype):
    """Run one of the port's callers of K13 on (B·T, D) rows past the switch."""
    from vit_tpu_torch.ops import fused_block, quant_block, trainable
    from vit_tpu_torch.parallel import tp_forward

    if caller == "flash_attention_fn":
        q, k, v = (_t((b, h, t, d // h), dtype, 30 + i).requires_grad_(True) for i in range(3))
        return flash_attention(q, k, v)
    if caller == "per_op_attention":
        blk = _block_params(d, dtype)
        return k21.attention(x2d.view(b, t, d), blk["wqkv"], blk["bqkv"], blk["wo"], blk["bo"], h)
    if caller == "fused_block":
        return fused_block.fused_encoder_block(x2d, _block_params(d, dtype), h, t, EPS)
    if caller == "trainable":
        blk = {k: p.requires_grad_(True) for k, p in _block_params(d, dtype).items()}
        return trainable.encoder_block_trainable(x2d, blk, h, t, EPS)
    if caller == "quant_block":
        return quant_block.fused_encoder_block_q8(x2d, _block_params(d, dtype, True), h, t, EPS)
    # rank 0's context at tp 2: its half of the heads' packed QKV columns
    quant = caller == "tp_long_quant"
    blk = _block_params(d, dtype, quant)
    blk["wqkv"], blk["bqkv"] = blk["wqkv"][:, :3 * d // 2], blk["bqkv"][:3 * d // 2]
    if quant:
        blk["wqkv_scale"] = blk["wqkv_scale"][:3 * d // 2]
    return tp_forward._ctx_long_seq_tp(x2d, blk, h // 2, t, EPS, quant)


K13_CALLERS = ["flash_attention_fn", "per_op_attention", "fused_block", "trainable",
               "quant_block", "tp_long", "tp_long_quant"]


@pytest.mark.parametrize("caller", K13_CALLERS)
@pytest.mark.parametrize("width", list(K13_WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_k13_caller_views_pass(monkeypatch, caller, width, dtype):
    # every caller past the switch (T = 5 > 4), at every width: K13's
    # operands on the 16-byte grid, packed views read and written in place
    from vit_tpu_torch.ops import fused_block

    monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    d, h = K13_WIDTHS[width]
    b, t = 2, 5
    calls = _spy(monkeypatch, k13, "flash_attention_fwd")
    out = _k13_caller(caller, _t((b * t, d), dtype, 1), b, t, d, h, dtype)
    assert torch.isfinite(out.float()).all()
    assert len(calls) == 1
    args, kwargs = calls[0]
    views = dict(zip("qkv", args[:3]))
    if kwargs.get("out") is not None:
        views["out"] = kwargs["out"]
    heads = h // 2 if caller.startswith("tp_long") else h
    shape = (b * h, 1, t, d // h) if caller == "flash_attention_fn" else (b, heads, t, d // h)
    assert all(x.shape == shape and x.stride(-1) == 1 for x in views.values())
    if caller != "flash_attention_fn":  # the packed QKV read in place, the context written so
        assert views["q"].stride(2) == 3 * heads * (d // h)
        assert views["out"].stride(2) == heads * (d // h)
    assert kwargs.get("return_lse", False) == (caller in ("flash_attention_fn", "trainable"))
    _build.check_aligned("flash_attention_fwd", **views)
