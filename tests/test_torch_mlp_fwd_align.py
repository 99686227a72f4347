"""The operand rule of the bf16 K5 and K11, on the CPU.

The bf16 K5 (``ln_mlp_residual``, the block's form, tensor parallelism's
partial form and the ``return_u`` stash) and K11 (``ln_mlp_residual_train``)
run their two GEMMs on ``csrc/gemm_mma.cuh``, whose TMA tensor maps read
h (a copy of x), w1 and w2 (and the g scratch, whose pitch F sets) in rows
of whole 16 bytes; their wrappers refuse an x, w1 or w2 off the 16-byte
grid or a width (D, F) that is not a multiple of 8 elements
(``check_tile_operands``, over ``_build.check_tiles``).  These tests hold
that rule on CPU tensors, and show that every operand the port's own
callers hand K5 and K11 passes it: ``ops/trainable``'s
``FusedEncoderBlockFn`` and ``FusedEncoderBlockTrainFn`` inside the
``fused_train`` model, ``LnMlpResidualFn`` in the long-sequence block and
in ToMe's ``forward_train``, ``LnMlpResidualTrainFn`` in ToMe's
regularized ``forward_train``, ``models/tome.forward_fused``,
``parallel/tp_forward``'s partial MLP at tp 2 and 4 (each rank's shard),
and ``cli/bench_kernels``' ``c`` run, at the tiny test config's widths and
at ViT-B/16's.  The callers run on the CPU (the wrappers take their plain
twins there); a spy records what they pass.
"""

import dataclasses

import numpy as np
import pytest
import torch

from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops.kernels import ln_mlp_residual as k5
from vit_tpu_torch.ops.kernels import ln_mlp_residual_train as k11

from torch_spy_record import record

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
# (D, heads, MLP width): the tiny test config's and ViT-B/16's
WIDTHS = {"tiny": (64, 4, 256), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads,
                                        VIT_B_16.mlp_dim)}
KERNELS = {"k5": k5, "k11": k11}
# the wrappers' operands the rule names, by position
OPERANDS = [(0, "x"), (3, "w1"), (5, "w2")]


def _t(shape, dtype=torch.bfloat16, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(size=shape).astype(np.float32)).to(
        dtype)


def _off(t):
    """The same shape, contiguous, one element past the 16-byte grid."""
    return _t((t.numel() + 1,), t.dtype)[1:].view(*t.shape)


def _args(rows, d, f, dtype=torch.bfloat16):
    """K5's leading operands (x, ln_scale, ln_bias, w1, b1, w2, b2)."""
    return (_t((rows, d), dtype, 1), _t((d,), dtype, 2), _t((d,), dtype, 3), _t((d, f), dtype, 4),
            _t((f,), dtype, 5), _t((f, d), dtype, 6), _t((d,), dtype, 7))


@pytest.mark.parametrize("kernel", list(KERNELS))
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_aligned_operands_pass(kernel, width, dtype):
    d, _, f = WIDTHS[width]
    args = _args(10, d, f, dtype)
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
@pytest.mark.parametrize("d,f,what", [(60, 256, "x is 60"), (64, 252, "w1 is 252"),
                                      (100, 400, "x is 100"), (768, 1540, "w1 is 1540")])
def test_widths_off_the_grid_are_refused(kernel, d, f, what):
    with pytest.raises(ValueError, match=f"{what} elements wide.*multiples of 8"):
        KERNELS[kernel].check_tile_operands(*_args(10, d, f))


def test_the_partial_forms_shard_widths_pass():
    # F is the shard's width in the partial form: B/16's 1,536 at tp 2, 768 at tp 4
    d, _, f = WIDTHS["b16"]
    x, s, b, w1, b1, w2, _ = _args(10, d, f)
    for tp in (2, 4):
        shard = (w1[:, :f // tp].contiguous(), b1[:f // tp].contiguous(),
                 w2[:f // tp].contiguous())
        k5.check_tile_operands(x, s, b, *shard, None, EPS, partial=True)
    # a shard whose base is off the grid is refused
    with pytest.raises(ValueError, match="w1 must start on a 16-byte boundary"):
        k5.check_tile_operands(x, s, b, w1[:, 4:4 + f // 2], b1, w2)


def _spy(monkeypatch, module, name):
    """Record every call's arguments to module.name, then make the call."""
    calls, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _spies(monkeypatch):
    return (_spy(monkeypatch, k5, "ln_mlp_residual"),
            _spy(monkeypatch, k11, "ln_mlp_residual_train"))


def _check_calls(k5_calls, k11_calls, n5, n11):
    assert (len(k5_calls), len(k11_calls)) == (n5, n11)
    for args, kwargs in k5_calls:
        k5.check_tile_operands(*args, **kwargs)
    for args, kwargs in k11_calls:
        k11.check_tile_operands(*args, **kwargs)


def _cast(params, dtype, grad=False):
    return {k: v.to(dtype).requires_grad_(grad) if torch.is_tensor(v)
            else {n: x.to(dtype).requires_grad_(grad) for n, x in v.items()}
            for k, v in params.items()}


def _model_cfg(width, dropout=0.0, drop_path=0.0, image_size=32):
    # 17 tokens at 32 px, 65 at 64 px (ToMe merges there); two layers
    d, h, _ = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h,
                               image_size=image_size, patch_size=8, num_classes=11,
                               dropout=dropout, drop_path=drop_path, name=f"vit_mlp_fwd_{width}")


@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_fused_train_model_operands_pass(monkeypatch, regularized, width, dtype):
    # FusedEncoderBlockFn (K5) and FusedEncoderBlockTrainFn (K11), one per layer
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import get_ops

    cfg = _model_cfg(width, *((0.1, 0.1) if regularized else ()))
    params = _cast(vit.init_params(torch.Generator().manual_seed(1), cfg), dtype, grad=True)
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    k5_calls, k11_calls = _spies(monkeypatch)
    rng = torch.Generator().manual_seed(3) if regularized else None
    vit.forward(params, images, cfg, get_ops("fused_train"), dropout_rng=rng).float().sum()
    _check_calls(k5_calls, k11_calls, *((0, cfg.depth) if regularized else (cfg.depth, 0)))
    assert all(args[0].shape[0] == 2 * cfg.seq_len for args, _ in k5_calls + k11_calls)


def _block(d, f, dtype):
    shapes = {"ln1_scale": (d,), "ln1_bias": (d,), "wqkv": (d, 3 * d), "bqkv": (3 * d,),
              "wo": (d, d), "bo": (d,), "ln2_scale": (d,), "ln2_bias": (d,), "w1": (d, f),
              "b1": (f,), "w2": (f, d), "b2": (d,)}
    return {k: (_t(shape, dtype, 20 + i) * (shape[0] ** -0.5 if len(shape) == 2 else 0.2))
            .requires_grad_(True) for i, (k, shape) in enumerate(shapes.items())}


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_long_block_operands_pass(monkeypatch, width, dtype):
    # LnMlpResidualFn in the @512 path's block, reached at T 5 by lowering
    # the 1,024-token switch, as tests/test_torch_flash.py does
    from vit_tpu_torch.ops import fused_block, trainable

    monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    d, h, f = WIDTHS[width]
    k5_calls, k11_calls = _spies(monkeypatch)
    x = _t((2 * 5, d), dtype, 1).requires_grad_(True)
    out = trainable.encoder_block_trainable(x, _block(d, f, dtype), h, 5, EPS)
    assert torch.isfinite(out.float()).all()
    _check_calls(k5_calls, k11_calls, 1, 0)


def _tome_train_run(monkeypatch, regularized, width, dtype):
    """models/tome.forward_train with K5's and K11's spies -> (cfg, K5
    calls, K11 calls)."""
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import tome, vit

    cfg = _model_cfg(width, *((0.1, 0.1) if regularized else ()), image_size=64)
    params = _cast(vit.init_params(torch.Generator().manual_seed(1), cfg), dtype, grad=True)
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    k5_calls, k11_calls = _spies(monkeypatch)
    rng = torch.Generator().manual_seed(3) if regularized else None
    tome.forward_train(params, images, cfg, 4, dropout_rng=rng)
    return cfg, k5_calls, k11_calls


@pytest.fixture(scope="module")
def tome_b16():
    """The B/16-width runs of the cases below, each once: their record."""
    return record(_tome_train_run, [(reg, "b16", dtype) for reg in (False, True)
                                    for dtype in DTYPES])


@pytest.mark.parametrize("regularized", [False, True], ids=["plain", "regularized"])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tome_train_operands_pass(monkeypatch, request, regularized, width, dtype):
    # LnMlpResidualFn (K5) and LnMlpResidualTrainFn (K11) after each merge
    from vit_tpu_torch.models import tome

    cfg, k5_calls, k11_calls = (request.getfixturevalue("tome_b16")[regularized, width, dtype]
                                if width == "b16"
                                else _tome_train_run(monkeypatch, regularized, width, dtype))
    _check_calls(k5_calls, k11_calls, *((0, cfg.depth) if regularized else (cfg.depth, 0)))
    counts = tome.schedule(cfg, 4, tome.TRAIN_MERGE_CHUNK)
    rows = [args[0].shape[0] for args, _ in (k11_calls if regularized else k5_calls)]
    assert rows == [2 * (cfg.seq_len - sum(counts[:l + 1])) for l in range(cfg.depth)]
    assert counts[0] > 0  # every MLP half runs on merged tokens


@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tome_fused_operands_pass(monkeypatch, width, dtype):
    # models/tome.forward_fused: K5 after each layer's merge
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import tome, vit

    cfg = _model_cfg(width, image_size=64)
    params = _cast(vit.init_params(torch.Generator().manual_seed(1), cfg), dtype)
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    k5_calls, k11_calls = _spies(monkeypatch)
    with torch.inference_mode():
        tome.forward_fused(params, images, cfg, 4)
    _check_calls(k5_calls, k11_calls, cfg.depth, 0)
    assert all(args[0].shape[0] < 2 * cfg.seq_len for args, _ in k5_calls)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_tp_partial_operands_pass(monkeypatch, tp, width, dtype):
    # parallel/tp_forward's MLP: K5's partial form on each rank's shard
    # (sharding.shard_params at that rank's coordinates; a one-process mesh
    # whose all-reduces do nothing)
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.parallel.mesh import Mesh
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.tp_forward import shard_forward_tp

    cfg = _model_cfg(width)
    params = _cast(vit.init_params(torch.Generator().manual_seed(1), cfg), dtype)
    images = torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)
    d, _, f = WIDTHS[width]
    for rank in range(tp):
        mesh = Mesh({"tp": tp}, rank, {"tp": None})
        k5_calls, k11_calls = _spies(monkeypatch)
        with torch.inference_mode():
            shard_forward_tp(cfg, mesh, "fused")(shard_params(params, mesh), images)
        _check_calls(k5_calls, k11_calls, cfg.depth, 0)
        for args, kwargs in k5_calls:
            assert kwargs.get("partial") and args[3].shape == (d, f // tp)
        monkeypatch.undo()


def test_bench_kernels_operands_pass(monkeypatch):
    # cli/bench_kernels' `c` run (B/16, one layer's weights of its 12-layer
    # stack each call), at batch 1; its card checks and timer made CPU ones
    from vit_tpu_torch.cli import bench_kernels
    from vit_tpu_torch.io import params as io_params

    monkeypatch.setattr(io_params, "device_or_raise", lambda device: torch.device("cpu"))
    monkeypatch.setattr(bench_kernels, "time_layers",
                        lambda body, x, weights: [body(x, w) for w in weights] and 1.0)
    k5_calls, k11_calls = _spies(monkeypatch)
    assert bench_kernels.main(["--batch", "1", "--which", "c"]) in (0, None)
    _check_calls(k5_calls, k11_calls, bench_kernels.L, 0)
    assert all(args[0].shape == (197, 768) and args[0].dtype == torch.bfloat16
               for args, _ in k5_calls)
