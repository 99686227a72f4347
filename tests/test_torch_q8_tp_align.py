"""The operand rules of K18a and K18b, the tensor-parallel W8A8 MLP, on the
CPU.

The bf16 K18a (``ln_fc1_gelu_q8``) runs its int8 FC1 on
``csrc/gemm_mma_q8.cuh``, the int8 TMA + ``wgmma`` core, and K18b
(``fc2_q8_partial``) its int8 FC2 there in every dtype.  The core reads
both operands K-major: the activation codes as they lie and this shard's
W1q or W2q through a K-major copy the kernel's launch sequence makes
(``kmajor_q8``); K18b's requantize pass reads ``mid`` in 16-byte loads.
Their wrappers refuse an int8 shard weight off the 16-byte grid or with a
dimension that is not a multiple of 16 (a shard width F/tp among them), and
K18b an fp32 ``mid`` off the 16-byte grid (``check_tile_operands``, over
``_build.check_q8_matrices`` and ``_build.check_aligned``), before any
launch and with no fallback.

These tests hold that gate at the wrappers themselves, on meta tensors (a
meta view's address is its offset, so an off-grid view stays off the grid)
with the library faked; then show that every operand the port's own callers
hand K18a and K18b passes it: ``parallel/tp_forward.fused_block_tp`` with
``quant=True`` and the engine's tensor-parallel ``quant`` forward at rank 0
of tp 2 and 4, at ``tiny_cfg``'s widths and at ViT-B/16's, @224-like and
past the 1,024-token switch (reached at 5 tokens by lowering it).  A
one-process mesh, ``Mesh({"dp": 1, "tp": tp}, 0, {})``, makes the
all-reduces no-ops, so no process group starts; the wrappers take their
plain twins on the CPU and a spy records what they are handed.  Last, the
K-major copies of the JAX package's sharded W1q and W2q leaves are their
transposes, and the int8 products through them are the JAX package's bit
for bit (K18b's against ``quant_kernels.fc2_q8_partial`` in interpret mode).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops import quant as JQ
from vit_tpu.ops.pallas import quant_kernels as JK
from vit_tpu.parallel.sharding import param_pspecs as jax_param_pspecs
from vit_tpu_torch.config import VIT_B_16
from vit_tpu_torch.ops import quant as TQ
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels import fc2_q8_partial as k18b
from vit_tpu_torch.ops.kernels import ln_fc1_gelu_q8 as k18a
from vit_tpu_torch.ops.kernels.kmajor_q8 import kmajor_q8
from vit_tpu_torch.parallel.mesh import Mesh

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
# (D, heads): tiny_cfg's (tests/conftest.py) and ViT-B/16's; F = 4 D
WIDTHS = {"tiny": (64, 4), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads)}


def _off(t):
    """The same shape and device, contiguous, one element past the 16-byte
    grid."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    return flat[1:].view(*t.shape)


def _k18a_args(rows, d, f, dtype=torch.bfloat16):
    """K18a's operands on meta tensors (x, ln_scale, ln_bias, w1q, w1s, b1,
    eps, gelu_variant, fast_erf)."""
    def e(*shape, dt=dtype):
        return torch.empty(*shape, dtype=dt, device="meta")

    return (e(rows, d), e(d), e(d), e(d, f, dt=torch.int8), e(f, dt=torch.float32), e(f), EPS,
            "exact", True)


def _k18b_args(rows, f, d):
    """K18b's operands on meta tensors (mid, ms, w2q)."""
    return (torch.empty(rows, f, device="meta"), torch.empty(rows, 1, device="meta"),
            torch.empty(f, d, dtype=torch.int8, device="meta"))


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


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_wrappers_launch_on_the_grid(fake_card, dtype):
    # B/16 tp 2's shard; bf16 K18a and K18b allocate the K-major copies
    st = k18a._ln_fc1_gelu_q8_stages(*_k18a_args(10, 768, 1536, dtype))
    assert fake_card == ["vt_ln_fc1_gelu_q8"]
    assert st["mid"].shape == (10, 1536) and st["mid"].dtype == torch.float32
    assert ("w1t" in st) == (dtype == torch.bfloat16)
    if "w1t" in st:
        assert st["w1t"].shape == (1536, 768) and st["w1t"].dtype == torch.int8
    st = k18b._fc2_q8_partial_stages(*_k18b_args(10, 1536, 768))
    assert fake_card[1:] == ["vt_fc2_q8_partial"]
    assert st["w2t"].shape == (768, 1536) and st["out"].dtype == torch.int32


@pytest.mark.parametrize("kernel", ["k18a", "k18b"])
def test_off_grid_shard_weight_is_refused(fake_card, kernel):
    if kernel == "k18a":
        args = list(_k18a_args(10, 64, 128))
        args[3] = _off(args[3])
        call, name = k18a.ln_fc1_gelu_q8, "ln_fc1_gelu_q8"
    else:
        args = list(_k18b_args(10, 128, 64))
        args[2] = _off(args[2])
        call, name = k18b.fc2_q8_partial, "fc2_q8_partial"
    with pytest.raises(ValueError, match=f"{name}: an int8 matrix .*16-byte aligned"):
        call(*args)
    assert fake_card == []  # refused before any launch: no fallback


@pytest.mark.parametrize("kernel", ["k18a", "k18b"])
@pytest.mark.parametrize("f", [120, 200])
def test_shard_width_off_the_grid_is_refused(fake_card, kernel, f):
    # F/tp must be a multiple of 16: the tensor maps' row pitches
    call, args = ((k18a.ln_fc1_gelu_q8, _k18a_args(10, 64, f)) if kernel == "k18a"
                  else (k18b.fc2_q8_partial, _k18b_args(10, f, 64)))
    with pytest.raises(ValueError, match="multiples of 16"):
        call(*args)
    assert fake_card == []


@pytest.mark.parametrize("how", ["offset", "bf16", "strided"])
def test_off_grid_mid_is_refused(fake_card, how):
    mid, ms, w2q = _k18b_args(10, 128, 64)
    bad = {"offset": lambda: _off(mid), "bf16": lambda: mid.bfloat16(),
           "strided": lambda: torch.empty(128, 10, device="meta").t()}[how]()
    what = "mid must start on a 16-byte" if how == "offset" else "mid must be a contiguous float32"
    with pytest.raises(ValueError, match=f"fc2_q8_partial: {what}"):
        k18b.fc2_q8_partial(bad, ms, w2q)
    assert fake_card == []


# -- the callers' operands -----------------------------------------------------


def _spy(monkeypatch, module, name):
    """Record every call's arguments to module.name, then make the call."""
    calls, real = [], getattr(module, name)

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, spy)
    return calls


def _model_cfg(width):
    # tiny_cfg's shape of model (5 tokens at 32 px, patch 16; two layers)
    d, h = WIDTHS[width]
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=d, num_heads=h, image_size=32,
                               patch_size=16, num_classes=11, name=f"vit_q8_tp_{width}")


def _params(cfg):
    from vit_tpu_torch.models import vit

    return vit.init_params(torch.Generator().manual_seed(1), cfg)


def _images(cfg, n=2):
    from vit_tpu_torch.io.images import synth_images

    return torch.from_numpy(synth_images(n, cfg, seed=2))


def _check_k18(a_calls, b_calls, n, rows, d, f_local, dtype):
    """n calls each, every operand through the wrappers' gate."""
    assert len(a_calls) == len(b_calls) == n
    for args, kwargs in a_calls:
        assert args[0].shape == (rows, d) and args[0].dtype == dtype
        assert args[3].shape == (d, f_local) and kwargs["fast_erf"] == (dtype == torch.bfloat16)
        k18a.check_tile_operands(*args, **kwargs)
    for args, kwargs in b_calls:
        assert args[0].shape == (rows, f_local) and args[2].shape == (f_local, d)
        k18b.check_tile_operands(*args, **kwargs)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_fused_block_tp_quant_operands_pass(monkeypatch, tp, width, dtype):
    # one block of parallel/tp_forward on `quant` at rank 0's shard
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.tp_forward import fused_block_tp

    cfg = _model_cfg(width)
    d, rows = cfg.embed_dim, 2 * cfg.seq_len
    mesh = Mesh({"dp": 1, "tp": tp}, 0, {})
    params = TQ.cast_quantized_params(TQ.quantize_params(_params(cfg)), dtype)
    blk = vit.layers(shard_params(params, mesh)["blocks"])[0]
    a_calls, b_calls = _spy(monkeypatch, k18a, "ln_fc1_gelu_q8"), _spy(monkeypatch, k18b,
                                                                       "fc2_q8_partial")
    x = torch.from_numpy(np.random.default_rng(3).normal(size=(rows, d)).astype(np.float32))
    with torch.inference_mode():
        out = fused_block_tp(x.to(dtype), blk, cfg.num_heads // tp, cfg.seq_len,
                             cfg.layernorm_eps, "exact", mesh, quant=True)
    assert out.shape == (rows, d) and out.dtype == dtype
    _check_k18(a_calls, b_calls, 1, rows, d, cfg.mlp_dim // tp, dtype)


@pytest.mark.parametrize("long", [False, True], ids=["short", "long_blocks"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("width", list(WIDTHS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_engine_tp_quant_operands_pass(monkeypatch, long, tp, width, dtype):
    # InferenceEngine(ops="quant", mesh=...) at rank 0: K18a and K18b once
    # per layer, behind K15 or, past the switch, ln_qkv_q8 + K13
    from vit_tpu_torch.io.params import params_to_numpy
    from vit_tpu_torch.ops import fused_block
    from vit_tpu_torch.runtime.engine import InferenceEngine

    if long:
        monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    cfg = _model_cfg(width)
    eng = InferenceEngine(cfg, params_to_numpy(_params(cfg)), dtype=dtype, ops="quant",
                          device="cpu", batch_pad=2, mesh=Mesh({"dp": 1, "tp": tp}, 0, {}))
    a_calls, b_calls = _spy(monkeypatch, k18a, "ln_fc1_gelu_q8"), _spy(monkeypatch, k18b,
                                                                       "fc2_q8_partial")
    with torch.inference_mode():
        logits = eng.logits(_images(cfg))
    assert logits.shape == (2, cfg.num_classes) and torch.isfinite(logits).all()
    _check_k18(a_calls, b_calls, cfg.depth, 2 * cfg.seq_len, cfg.embed_dim, cfg.mlp_dim // tp,
               eng.compute_dtype)


# -- the K-major copies of the JAX package's shards ----------------------------


def _jax_shard(leaf, spec, rank, tp):
    """The JAX package's rule for a leaf (a PartitionSpec), cut at ``rank``
    of ``tp``."""
    for axis, name in enumerate(spec):
        if name == "tp":
            step = leaf.shape[axis] // tp
            leaf = np.take(leaf, range(rank * step, (rank + 1) * step), axis=axis)
    return np.ascontiguousarray(leaf)


@pytest.mark.parametrize("tp", [2, 4])
def test_kmajor_copies_of_the_jax_shards(tp):
    # the JAX package's quantized W1 and W2, cut by its own tp rule; each
    # shard's K-major copy is its transpose, the int8 reference product
    # through the W1q copy is the JAX package's, and K18b's int32 sums
    # through the W2q copy are quant_kernels.fc2_q8_partial's bit for bit
    d, f = 64, 256
    fl = f // tp
    rng = np.random.default_rng(5)
    blocks = {"w1": rng.normal(size=(2, d, f)).astype(np.float32) * d ** -0.5,
              "w2": rng.normal(size=(2, f, d)).astype(np.float32) * f ** -0.5,
              "wqkv": np.zeros((2, d, 3 * d), np.float32)}
    jq = {k: np.asarray(v) for k, v in JQ.quantize_params({"blocks": blocks})["blocks"].items()}
    specs = jax_param_pspecs(("dp", "tp"), {"blocks": jq})["blocks"]
    x_q = rng.integers(-127, 128, (40, d)).astype(np.int8)
    x_q[0] = 127
    s_x = (np.abs(rng.normal(size=40)) + 0.1).astype(np.float32)
    mid = rng.normal(size=(40, fl)).astype(np.float32)
    mid[1] = 0  # a row of zeros: the scale's floor
    mmax = np.abs(mid).max(-1, keepdims=True)
    ms = np.maximum(mmax / np.float32(127), np.float32(1e-12)).astype(np.float32)
    for rank in range(tp):
        sh = {k: _jax_shard(jq[k], specs[k], rank, tp) for k in ("w1", "w1_scale", "w2")}
        assert sh["w1"].shape == (2, d, fl) and sh["w2"].shape == (2, fl, d)
        for layer in range(2):
            w1, w2 = (torch.from_numpy(sh[k][layer].copy()) for k in ("w1", "w2"))
            w1t, w2t = kmajor_q8(w1), kmajor_q8(w2)
            assert w1t.is_contiguous() and w2t.is_contiguous()
            np.testing.assert_array_equal(w1t.numpy(), sh["w1"][layer].T)
            np.testing.assert_array_equal(w2t.numpy(), sh["w2"][layer].T)
            w1s = sh["w1_scale"][layer]
            want = np.asarray(JQ.int8_matmul_reference(
                jnp.asarray(x_q), jnp.asarray(s_x), jnp.asarray(sh["w1"][layer]),
                jnp.asarray(w1s)))
            got = TQ.int8_matmul_reference(torch.from_numpy(x_q), torch.from_numpy(s_x), w1t.t(),
                                           torch.from_numpy(w1s.copy()))
            np.testing.assert_array_equal(got.numpy(), want)
            want = np.asarray(JK.fc2_q8_partial(jnp.asarray(mid), jnp.asarray(ms),
                                                jnp.asarray(sh["w2"][layer]), interpret=True))
            mq = k18b.requantize_plain(torch.from_numpy(mid), torch.from_numpy(ms))
            got = TQ.int8_dot(mq, w2t.t()).to(torch.int32)
            assert want.dtype == np.int32
            np.testing.assert_array_equal(got.numpy(), want)
