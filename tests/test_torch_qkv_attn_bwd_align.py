"""The operand rule and the reformulated attention backward of the bf16 K6,
on the CPU.

The bf16 K6 (``ln_qkv_attn_bwd``) runs its three GEMMs on
``csrc/gemm_mma.cuh``, whose TMA tensor maps read x's LayerNorm rows, W_qkv
and the scratches whose pitches D and 3D set in rows of whole 16 bytes, and
its attention backward reads dctx in 16-byte copies; the wrapper refuses an
operand off the 16-byte grid or a width that is not a multiple of 8
elements (``check_tile_operands``, over ``_build.check_tiles``).  These
tests hold that rule on CPU tensors, and show that every operand the port's
own callers hand K6 passes it: the block backward, plain and regularized
(``ops/backward.fused_encoder_block_bwd`` and
``fused_encoder_block_bwd_train``, through ``ops/trainable``'s block
functions), ToMe's VJP of K1 (``TomeLnQkvAttnFn``, no residual join, the
log-size bias) inside ``models/tome.forward_train``, and the ``fused_train``
model, at the tiny test config's widths and at ViT-B/16's.  The callers run
on the CPU (the wrapper takes its plain twin there); a spy records what
they pass.

They also hold the kernel's reformulation of the attention backward, in
plain torch and fp32, to the plain twin: p from each query row's log-sum-exp,
delta = Σₖ p·dp, dK/dV summed over query tiles with keys outer and dQ over
key tiles with queries outer, 64-row tiles padded past T.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops.backward import _ln_bwd_dx, _ln_stats
from vit_tpu_torch.ops.kernels import ln_qkv_attn_bwd as k6

from torch_spy_record import record

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
# (D, heads, MLP width): the tiny test config's and ViT-B/16's
WIDTHS = {"tiny": (64, 4, 256), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads,
                                        VIT_B_16.mlp_dim)}
# the wrapper's operands the rule names, by position
OPERANDS = [(0, "dctx"), (2, "x"), (5, "wqkv")]


def _t(shape, dtype=torch.bfloat16, seed=0, scale=1.0):
    return torch.from_numpy(
        (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)).to(dtype)


def _off(t):
    """The same shape, contiguous, one element past the 16-byte grid."""
    return _t((t.numel() + 1,), t.dtype)[1:].view(*t.shape)


def _args(rows, d, d3=None, dtype=torch.bfloat16):
    """K6's leading operands (dctx, dres, x, ln_scale, ln_bias, wqkv, bqkv)."""
    d3 = 3 * d if d3 is None else d3
    return (_t((rows, d3 // 3), dtype, 1), _t((rows, d), dtype, 2), _t((rows, d), dtype, 3),
            _t((d,), dtype, 4), _t((d,), dtype, 5), _t((d, d3), dtype, 6), _t((d3,), dtype, 7))


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_aligned_operands_pass(width, dtype):
    d = WIDTHS[width][0]
    args = _args(10, d, dtype=dtype)
    k6.check_tile_operands(*args)
    # a view 16 bytes into a buffer is on the grid
    flat = _t((10 * d + 16,), dtype)
    step = 16 // flat.element_size()
    x = flat[step:step + 10 * d].view(10, d)
    k6.check_tile_operands(*args[:2], x, *args[3:])


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("i,name", OPERANDS)
def test_off_grid_views_are_refused(width, i, name):
    d = WIDTHS[width][0]
    args = list(_args(10, d))
    args[i] = _off(args[i])
    with pytest.raises(ValueError, match=f"ln_qkv_attn_bwd: {name} must start on a 16-byte "
                                         "boundary"):
        k6.check_tile_operands(*args)


@pytest.mark.parametrize("d,d3,what", [(60, 192, "x is 60"), (100, 300, "dctx is 100"),
                                       (64, 180, "dctx is 60")])
def test_widths_off_the_grid_are_refused(d, d3, what):
    with pytest.raises(ValueError, match=f"{what} elements wide.*multiples of 8"):
        k6.check_tile_operands(*_args(10, d, d3))


def _spy(monkeypatch):
    """Record every call's arguments to K6's wrapper, then make the call."""
    calls, real = [], k6.ln_qkv_attn_bwd

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(k6, "ln_qkv_attn_bwd", spy)
    return calls


def _check_calls(calls, n, rows=None, hooked=False):
    assert len(calls) == n
    for args, kwargs in calls:
        k6.check_tile_operands(*args, **kwargs)
        assert (args[1] is None) == hooked  # ToMe's VJP joins no residual
        if not hooked:
            assert kwargs.get("log_size") is None
        if rows is not None:
            assert args[2].shape[0] == rows


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
    # FusedEncoderBlockFn and FusedEncoderBlockTrainFn: K7 or K12a, then K6
    from vit_tpu_torch.ops import trainable

    d, h, f = WIDTHS[width]
    calls = _spy(monkeypatch)
    b, t = 2, 7
    x = _t((b * t, d), dtype, 1).requires_grad_(True)
    blk = _block(d, f, dtype)
    if regularized:
        out = trainable.encoder_block_train(x, blk, h, t, EPS, "exact", 2 ** 31 + 11, 0.1, 0.1)
    else:
        out = trainable.encoder_block_trainable(x, blk, h, t, EPS)
    out.float().sum().backward()
    assert torch.isfinite(x.grad.float()).all()
    _check_calls(calls, 1, b * t)


def _cfg(width, image_size, name, dropout=0.0, drop_path=0.0):
    d, h, _ = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h,
                               image_size=image_size, patch_size=8, num_classes=11,
                               dropout=dropout, drop_path=drop_path, name=f"{name}_{width}")


def _params(cfg, dtype):
    from vit_tpu_torch.models import vit

    params = vit.init_params(torch.Generator().manual_seed(1), cfg)
    return {k: v.to(dtype).requires_grad_(True) if torch.is_tensor(v)
            else {n: x.to(dtype).requires_grad_(True) for n, x in v.items()}
            for k, v in params.items()}


@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_fused_train_model_operands_pass(monkeypatch, regularized, width, dtype):
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import get_ops

    # 17 tokens, two layers
    cfg = _cfg(width, 32, "vit_qkv_attn_bwd", *((0.1, 0.1) if regularized else ()))
    params = _params(cfg, dtype)
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    calls = _spy(monkeypatch)
    rng = torch.Generator().manual_seed(3) if regularized else None
    logits = vit.forward(params, images, cfg, get_ops("fused_train"), dropout_rng=rng)
    logits.float().sum().backward()
    # one K6 per layer, over the whole batch's rows
    _check_calls(calls, cfg.depth, 2 * cfg.seq_len)


def _tome_train_run(monkeypatch, regularized, width, dtype):
    """models/tome.forward_train and its backward with K6's spy -> (cfg,
    K6 calls)."""
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import tome

    # 65 tokens; r = 4 with the training chunk of 2 merges 8 at layer 0
    cfg = _cfg(width, 64, "vit_tome_qkv_attn_bwd", *((0.1, 0.1) if regularized else ()))
    params = _params(cfg, dtype)
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    calls = _spy(monkeypatch)
    rng = torch.Generator().manual_seed(3) if regularized else None
    tome.forward_train(params, images, cfg, 4, dropout_rng=rng).float().sum().backward()
    return cfg, calls


@pytest.fixture(scope="module")
def tome_b16():
    """The B/16-width runs of the cases below, each once: their record."""
    return record(_tome_train_run, [(reg, "b16", dtype) for reg in (False, True)
                                    for dtype in DTYPES])


@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tome_train_operands_pass(monkeypatch, request, regularized, width, dtype):
    # ToMe's VJP of K1 (TomeLnQkvAttnFn): dres=None and the log-size bias
    from vit_tpu_torch.models import tome

    cfg, calls = (request.getfixturevalue("tome_b16")[regularized, width, dtype]
                  if width == "b16" else _tome_train_run(monkeypatch, regularized, width, dtype))
    # both layers through the hooked VJP: the first before any merge, with
    # no bias, the second over the merged tokens with their log-sizes
    _check_calls(calls, cfg.depth, hooked=True)
    assert sorted(kw["log_size"] is None for _, kw in calls) == [False, True]
    rows = sorted(args[2].shape[0] for args, _ in calls)
    counts = tome.schedule(cfg, 4, tome.TRAIN_MERGE_CHUNK)
    assert rows == sorted(2 * (cfg.seq_len - sum(counts[:l])) for l in range(cfg.depth))


# -- the reformulation, in fp32 ----------------------------------------------

TILE = 64


def _tiles(n):
    return [(i, min(i + TILE, n)) for i in range(0, n, TILE)]


def _reformulated(dctx, dres, x, s, b, w, bias, heads, t, eps, log_size=None):
    """K6's bf16 chain as the kernels order it, in fp32 and plain torch: the
    statistics kernel's lse and delta per query row, then dK/dV with keys
    outer (summed over query tiles) and dQ with queries outer (summed over
    key tiles), each tile recomputing its scores and p = exp(s - lse)."""
    rows, d = x.shape
    d3 = w.shape[1]
    dh = d3 // (3 * heads)
    bsz = rows // t
    xhat, inv = _ln_stats(x, eps)
    h1 = xhat * s + b
    qkv = (h1 @ w + bias).reshape(bsz, t, heads, 3, dh)
    g = dctx.reshape(bsz, t, heads, dh)
    scale = 1.0 / dh ** 0.5
    dqkv = torch.zeros(bsz, t, heads, 3, dh)
    for i in range(bsz):
        for hh in range(heads):
            q_s, k, v = qkv[i, :, hh, 0] * scale, qkv[i, :, hh, 1], qkv[i, :, hh, 2]
            gh = g[i, :, hh]
            kb = log_size[i] if log_size is not None else torch.zeros(t)

            def scores(q0, q1, k0, k1):
                return q_s[q0:q1] @ k[k0:k1].t() + kb[k0:k1]

            # statistics: pass 1 the running max and sum, pass 2 delta
            lse, delta = torch.empty(t), torch.empty(t)
            for q0, q1 in _tiles(t):
                m = torch.full((q1 - q0,), -torch.inf)
                lsum = torch.zeros(q1 - q0)
                for k0, k1 in _tiles(t):
                    sc = scores(q0, q1, k0, k1)
                    mn = torch.maximum(m, sc.amax(-1))
                    lsum = lsum * torch.exp(m - mn) + torch.exp(sc - mn[:, None]).sum(-1)
                    m = mn
                lse[q0:q1] = m + torch.log(lsum)
                acc = torch.zeros(q1 - q0)
                for k0, k1 in _tiles(t):
                    p = torch.exp(scores(q0, q1, k0, k1) - lse[q0:q1, None])
                    acc += (p * (gh[q0:q1] @ v[k0:k1].t())).sum(-1)
                delta[q0:q1] = acc

            def p_ds(q0, q1, k0, k1):
                p = torch.exp(scores(q0, q1, k0, k1) - lse[q0:q1, None])
                return p, p * (gh[q0:q1] @ v[k0:k1].t() - delta[q0:q1, None])

            for k0, k1 in _tiles(t):  # dK/dV, keys outer
                dk, dv = torch.zeros(k1 - k0, dh), torch.zeros(k1 - k0, dh)
                for q0, q1 in _tiles(t):
                    p, ds = p_ds(q0, q1, k0, k1)
                    dv += p.t() @ gh[q0:q1]
                    dk += ds.t() @ q_s[q0:q1]
                dqkv[i, k0:k1, hh, 1], dqkv[i, k0:k1, hh, 2] = dk, dv
            for q0, q1 in _tiles(t):  # dQ, queries outer
                dq = torch.zeros(q1 - q0, dh)
                for k0, k1 in _tiles(t):
                    dq += p_ds(q0, q1, k0, k1)[1] @ k[k0:k1]
                dqkv[i, q0:q1, hh, 0] = dq * scale
    dqkv = dqkv.reshape(rows, d3)
    dh1 = dqkv @ w.t()
    dx = _ln_bwd_dx(dh1, xhat, inv, s)
    if dres is not None:
        dx = dres + dx
    return dx, (dh1 * xhat).sum(0), dh1.sum(0), h1.t() @ dqkv, dqkv.sum(0)


@pytest.mark.parametrize("hooked", [False, True], ids=["plain", "hooked"])
@pytest.mark.parametrize("bsz,t,d,heads", [(2, 5, 64, 4), (1, 65, 64, 2), (1, 130, 32, 1)],
                         ids=["t5_dh16", "t65_dh32", "t130_dh32"])
def test_reformulation_matches_the_plain_twin(hooked, bsz, t, d, heads):
    rows = bsz * t
    dctx, dres, x, s, b, w, bias = (
        _t((rows, d), torch.float32, 1), _t((rows, d), torch.float32, 2),
        _t((rows, d), torch.float32, 3, 2.0), 1.0 + _t((d,), torch.float32, 4, 0.2),
        _t((d,), torch.float32, 5, 0.2), _t((d, 3 * d), torch.float32, 6, d ** -0.5),
        _t((3 * d,), torch.float32, 7, 0.1))
    log_size = None
    if hooked:
        dres = None
        log_size = torch.log(torch.from_numpy(
            np.random.default_rng(8).integers(1, 6, size=(bsz, t))).float())
    got = _reformulated(dctx, dres, x, s, b, w, bias, heads, t, EPS, log_size)
    want = k6.ln_qkv_attn_bwd_plain(dctx, dres, x, s, b, w, bias, heads, t, EPS, log_size)
    for i, (a, e) in enumerate(zip(got, want)):
        tol = 1e-5 * max(1.0, e.abs().max().item())
        err = (a - e).abs().max().item()
        assert err <= tol, f"output {i}: max|d| {err} > {tol}"
