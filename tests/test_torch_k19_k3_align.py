"""The operand rules and layouts of the bf16 K19 and K3, on the CPU.

The bf16 K19 (``ln_qkv_attn_q8a``, the kernel study's int8-attention
kernel) runs K15's stages 1-2 through the host function the bf16 K15 runs:
its QKV GEMM on the int8 TMA + ``wgmma`` core through a K-major copy of Wq,
so it takes K15's operand rule (``check_tile_operands``: Wq 16-byte
aligned, both dimensions multiples of 16).  Its p·v reads the v codes as a
K-major operand, so it writes them keys-contiguous, (B, H, dh, T padded to
16); the plain twin writes the same layout for bf16 (``v8_keys_major``) and
its context is the JAX package's ``_head_context_q8`` on the JAX package's
own packed QKV.  These tests hold that rule on meta tensors (shapes only,
at the tiny, ViT-B/16 and ViT-H/14 widths), at the wrapper's own gate with
the library faked, on every operand ``cli/bench_kernels``' ``a8qk`` and
``a8a`` runs hand the kernel (a recorder in the kernel's place: no B/16
forward runs), and hold the keys-major twin to the JAX package at 1e-5.

K3 (``layer_norm``) picks one of two kernels by shape before the launch
(``register_vecs``): the bf16 register row pass for rows up to 2,048 wide
whose width is a multiple of 8 with every operand on the 16-byte grid, the
two-read row kernel otherwise.  These tests hold that choice on CPU and
meta tensors, then record the choice each of K3's callers' operands select
— the ``fused`` and ``per_op`` forwards, the long block's LN1 past the
1,024-token switch, ``parallel/tp_forward`` at tp 2 — and that each choice
is legal, at the tiny config's widths (ViT-B/16's by shape).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vit_tpu.ops.pallas import quant_kernels as JK
from vit_tpu_torch.config import VIT_B_16, VIT_H_14
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels import layer_norm as k3
from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as k15

DTYPES = [torch.float32, torch.bfloat16]
EPS = 1e-6
# (D, heads): the tiny test config's, ViT-B/16's and ViT-H/14's (dh 80)
WIDTHS = {"tiny": (64, 4), "b16": (VIT_B_16.embed_dim, VIT_B_16.num_heads),
          "h14": (VIT_H_14.embed_dim, VIT_H_14.num_heads)}


def _meta_k19(b, t, d, h, dtype=torch.bfloat16):
    """K19's operands on meta tensors (x, ln_scale, ln_bias, wq, w_scale,
    bqkv, heads, T, eps)."""
    def m(*shape, dt=dtype):
        return torch.empty(*shape, dtype=dt, device="meta")

    return (m(b * t, d), m(d), m(d), m(d, 3 * d, dt=torch.int8), m(3 * d, dt=torch.float32),
            m(3 * d), h, t, EPS)


def _off(t):
    """The same shape and device, contiguous, one element past the 16-byte
    grid."""
    return torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(*t.shape)


# -- K19: K15's operand rule -------------------------------------------------------


@pytest.mark.parametrize("width", list(WIDTHS))
def test_k19_rule_on_the_widths(width):
    # shapes only: the study's B/16 operands, and H/14's, pass; Wq off the
    # 16-byte grid or with a width that is not a multiple of 16 does not
    d, h = WIDTHS[width]
    args = _meta_k19(100, 197, d, h)
    k15.check_tile_operands(*args, kernel="ln_qkv_attn_q8a")
    with pytest.raises(ValueError, match="ln_qkv_attn_q8a: .*16-byte aligned"):
        k15.check_tile_operands(*args[:3], _off(args[3]), kernel="ln_qkv_attn_q8a")
    narrow = torch.empty(d, 3 * d - 8, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="ln_qkv_attn_q8a: .*multiples of 16"):
        k15.check_tile_operands(*args[:3], narrow, kernel="ln_qkv_attn_q8a")


@pytest.fixture
def fake_card(monkeypatch):
    """Meta tensors in place of CUDA ones and a library that records its
    launches with their arguments: the wrapper runs its own checks,
    allocations and call."""
    launched = []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: launched.append((name, a)) or 0

    monkeypatch.setattr(_build, "check_operands", lambda *a: None)
    monkeypatch.setattr(_build, "load_library", Lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(_build, "check", lambda rc, name: None)
    return launched


@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_k19_wrapper_refuses_off_grid_wq(fake_card, dtype):
    args = list(_meta_k19(2, 5, 64, 4, dtype))
    args[3] = _off(args[3])
    with pytest.raises(ValueError, match="ln_qkv_attn_q8a: .*16-byte aligned"):
        k15.ln_qkv_attn_q8a(*args)
    assert fake_card == []  # refused before any launch: no fallback


@pytest.mark.parametrize("quant_pv", [True, False], ids=["q8_pv", "dtype_pv"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("t", [1, 37, 64, 65])
def test_k19_wrapper_scratches(fake_card, dtype, quant_pv, t):
    # bf16: Wq's K-major copy, v codes keys-contiguous with T padded to 16;
    # fp32: no copy, v codes in (B*T, D) rows; one launch with the C entry
    # point's argument count
    b, d, h = 3, 64, 4
    st = k15._ln_qkv_attn_q8a_stages(*_meta_k19(b, t, d, h, dtype), quant_pv=quant_pv,
                                     return_p=True)
    (name, a), = fake_card
    assert name == "vt_ln_qkv_attn_q8a"
    assert len(a) == len(_build.SIGNATURES[name])
    bf16 = dtype == torch.bfloat16
    assert ("wqt" in st) == bf16 and k15.v8_keys_major(dtype) == bf16
    if bf16:
        assert st["wqt"].shape == (3 * d, d) and st["wqt"].dtype == torch.int8
    assert st["ctx"].shape == (b * t, d) and st["ctx"].dtype == dtype
    if quant_pv:
        tp = -(-t // k15.V8_KEY_PAD) * k15.V8_KEY_PAD
        assert st["v8"].shape == ((b, h, d // h, tp) if bf16 else (b * t, d))
        assert st["p8"].shape == (b, h, t, t) and st["vs"].shape == (b, h, d // h)
    else:
        assert "v8" not in st and "p8" not in st


def test_bench_kernels_a8qk_a8a_operands_pass(monkeypatch):
    # cli/bench_kernels' `a8qk` and `a8a` runs (B/16, one layer's weights of
    # its 12-layer stack each call), at batch 1, a recorder in K19's place
    from vit_tpu_torch.cli import bench_kernels
    from vit_tpu_torch.io import params as io_params

    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        return args[0]

    monkeypatch.setattr(io_params, "device_or_raise", lambda device: torch.device("cpu"))
    monkeypatch.setattr(bench_kernels, "time_layers",
                        lambda body, x, weights: [body(x, w) for w in weights] and 1.0)
    monkeypatch.setattr(k15, "ln_qkv_attn_q8a", record)
    assert bench_kernels.main(["--batch", "1", "--which", "a8qk,a8a"]) in (0, None)
    assert [kw["quant_pv"] for _, kw in calls] == [False] * bench_kernels.L + [True] * \
        bench_kernels.L
    for args, kwargs in calls:
        assert args[0].shape == (197, 768) and args[0].dtype == torch.bfloat16
        assert args[6:8] == (12, 197)
        k15.check_tile_operands(*args, kernel="ln_qkv_attn_q8a", **kwargs)


# -- K19: the keys-major v codes against the JAX package ---------------------------


def _jax_p8(qkv, hh, dh, scale):
    """The p codes of ``_head_context_q8`` for head ``hh`` of one image's
    packed QKV, in the JAX package's own ops (its row quantizer on q and on
    k, whose rows are the keys)."""
    base = hh * 3 * dh
    q8, qs = JK._quant_rows(qkv[:, base:base + dh])
    k8, ks = JK._quant_rows(qkv[:, base + dh:base + 2 * dh])
    acc = jnp.dot(q8.astype(jnp.int32), k8.astype(jnp.int32).T)
    s = acc.astype(jnp.float32) * (qs * scale) * ks.T
    return jnp.round(jnp.exp(s - jnp.max(s, -1, keepdims=True)) * 127.0).astype(jnp.int8)


@pytest.mark.parametrize("t,d,heads", [(37, 32, 2), (64, 64, 2), (65, 160, 2)],
                         ids=["t37_dh16", "t64_dh32", "t65_dh80"])
def test_k19_keys_major_twin_matches_jax_head_context(t, d, heads):
    # per image: the JAX package's packed QKV (_qkv_q8, fp32) and its
    # per-head context (_head_context_q8).  The twin's codes in the bf16
    # kernel's layout are the rows layout's transposed, zero past T, and
    # give the same context; on the JAX package's p codes that context is
    # _head_context_q8's at 1e-5.  The twin's own p codes are the JAX
    # package's within one step, at most 1e-3 of them moved (torch's and
    # XLA's exp differ in the last bits: a code on a rounding boundary moves)
    rng = np.random.default_rng(21)
    b, dh = 2, d // heads
    scale = 1.0 / dh ** 0.5
    x = rng.normal(size=(b * t, d)).astype(np.float32)
    wq = rng.integers(-127, 128, (d, 3 * d)).astype(np.int8)
    ws = rng.uniform(0.0002, 0.0008, (3 * d,)).astype(np.float32)
    bq = (0.01 * rng.normal(size=(3 * d,))).astype(np.float32)
    s1, b1 = np.ones((1, d), np.float32), np.zeros((1, d), np.float32)
    images = [JK._qkv_q8(jnp.asarray(x[i * t:(i + 1) * t]), jnp.asarray(s1), jnp.asarray(b1),
                         jnp.asarray(wq), jnp.asarray(ws), jnp.asarray(bq), EPS) for i in range(b)]
    want = np.concatenate([np.concatenate([np.asarray(JK._head_context_q8(qi, hh, dh, scale))
                                           for hh in range(heads)], axis=1) for qi in images])
    jp8 = torch.from_numpy(np.stack([np.stack([np.asarray(_jax_p8(qi, hh, dh, scale))
                                               for hh in range(heads)]) for qi in images]))
    tq = torch.from_numpy(np.concatenate([np.asarray(qi) for qi in images]))
    codes = k15.attention_q8_codes_plain(tq, heads, t, True, keys_major=True)
    rows = k15.attention_q8_codes_plain(tq, heads, t, True)
    pad = -t % k15.V8_KEY_PAD
    assert codes["v8"].shape == (b, heads, dh, t + pad) and codes["v8"].is_contiguous()
    assert not codes["v8"][..., t:].any()
    torch.testing.assert_close(
        codes["v8"][..., :t].permute(0, 3, 1, 2).reshape(b * t, d), rows["v8"], rtol=0, atol=0)
    ctx, p8 = k15.attention_q8_plain(codes, tq, heads, t, True)
    ctx_rows, p8_rows = k15.attention_q8_plain(rows, tq, heads, t, True)
    assert torch.equal(ctx, ctx_rows) and torch.equal(p8, p8_rows)
    step = (p8.int() - jp8.int()).abs()
    assert step.max() <= 1 and (step != 0).float().mean() <= 1e-3
    ctx_j, _ = k15.attention_q8_plain(codes, tq, heads, t, True, p8=jp8)
    np.testing.assert_allclose(ctx_j.numpy(), want, atol=1e-5, rtol=1e-5)


def test_k19_bf16_stages_on_the_cpu_use_the_kernel_layout():
    rng = np.random.default_rng(3)
    t, d, h = 21, 64, 4
    x = torch.from_numpy(rng.normal(size=(2 * t, d)).astype(np.float32)).bfloat16()
    wq = torch.from_numpy(rng.integers(-127, 128, (d, 3 * d)).astype(np.int8))
    ws = torch.from_numpy(rng.uniform(0.0002, 0.0008, (3 * d,)).astype(np.float32))
    args = (x, torch.ones(d).bfloat16(), torch.zeros(d).bfloat16(), wq, ws,
            torch.zeros(3 * d).bfloat16(), h, t, EPS)
    st = k15._ln_qkv_attn_q8a_stages(*args, quant_pv=True, return_p=True)
    assert st["v8"].shape == (2, h, d // h, 32)
    ctx, _ = k15.attention_q8_plain(st, st["qkv"], h, t, True, p8=st["p8"])
    assert torch.equal(ctx, st["ctx"])
    assert torch.equal(st["ctx"], k15.ln_qkv_attn_q8a_plain(*args))


# -- K3: the kernel each operand selects -------------------------------------------


def _ln_ops(shape, dtype=torch.bfloat16, device="cpu"):
    return (torch.zeros(*shape, dtype=dtype, device=device),
            torch.ones(shape[-1], dtype=dtype, device=device),
            torch.zeros(shape[-1], dtype=dtype, device=device))


@pytest.mark.parametrize("d,vecs", [(8, 2), (64, 2), (512, 2), (520, 4), (768, 4), (1024, 4),
                                    (1032, 8), (1280, 8), (2048, 8), (2056, 0), (772, 0),
                                    (100, 0)])
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_k3_choice_by_width(d, vecs, device):
    assert k3.register_vecs(*_ln_ops((5, d), device=device)) == vecs
    assert k3.register_vecs(*_ln_ops((5, d), torch.float32, device)) == 0


@pytest.mark.parametrize("rows", [19700, 16400, 1])
def test_k3_choice_at_b16_and_h14_shapes(rows):
    # shapes only: the final LayerNorm @224 b100 and @512 b16, and one row
    for d, vecs in ((VIT_B_16.embed_dim, 4), (VIT_H_14.embed_dim, 8)):
        assert k3.register_vecs(*_ln_ops((rows, d), device="meta")) == vecs


@pytest.mark.parametrize("which", [0, 1, 2], ids=["x", "scale", "bias"])
@pytest.mark.parametrize("offset,vecs", [(1, 0), (4, 0), (8, 4)],
                         ids=["2_bytes", "8_bytes", "16_bytes"])
def test_k3_choice_on_storage_offsets(which, offset, vecs):
    ops = list(_ln_ops((3, 768)))
    t = ops[which]
    ops[which] = torch.zeros(t.numel() + offset, dtype=t.dtype)[offset:].view(t.shape)
    assert ops[which].storage_offset() == offset
    assert k3.register_vecs(*ops) == vecs


def _legal(choice) -> None:
    """A recorded choice (vecs, x, scale, bias) is one the launcher takes:
    the register pass only for contiguous bf16 rows whose width is a
    multiple of 8 that fits its tiles (the least instance that holds it),
    every operand on the 16-byte grid; else the row kernel, for a reason."""
    vecs, x, scale, bias = choice
    d = x.shape[-1]
    assert all(t.is_contiguous() for t in (x, scale, bias))
    assert scale.shape == bias.shape == (d,)
    if vecs:
        assert x.dtype == torch.bfloat16 and d % 8 == 0
        assert vecs in k3.REG_VECS and d <= 256 * vecs
        assert all(256 * v < d for v in k3.REG_VECS if v < vecs)
        assert all(t.data_ptr() % 16 == 0 for t in (x, scale, bias))
    else:
        assert (x.dtype != torch.bfloat16 or d % 8 or d > 256 * max(k3.REG_VECS)
                or any(t.data_ptr() % 16 for t in (x, scale, bias)))


@pytest.fixture
def k3_spy(monkeypatch):
    """Every K3 call's choice: the wrapper takes its plain twin on the CPU,
    so a spy there records ``register_vecs`` of the operands."""
    choices, real = [], k3.layer_norm_plain

    def spy(x, scale, bias, eps=1e-6):
        choices.append((k3.register_vecs(x, scale, bias), x, scale, bias))
        return real(x, scale, bias, eps)

    monkeypatch.setattr(k3, "layer_norm_plain", spy)
    return choices


def _tiny_cfg():
    # 17 tokens at 32 px, two layers, the tiny test config's width
    return dataclasses.replace(VIT_B_16, depth=2, embed_dim=64, num_heads=4, mlp_ratio=4,
                               image_size=32, patch_size=8, num_classes=11, name="vit_k3_tiny")


def _params_images(cfg, dtype):
    from vit_tpu_torch.io.images import synth_images
    from vit_tpu_torch.models import vit

    params = vit.cast_params(vit.init_params(torch.Generator().manual_seed(1), cfg), dtype)
    return params, torch.from_numpy(synth_images(2, cfg, seed=2)).to(dtype)


@pytest.mark.parametrize("ops,long,calls", [("fused", False, 1), ("per_op", False, 5),
                                            ("fused", True, 3), ("quant", False, 1)],
                         ids=["fused", "per_op", "fused_long_blocks", "quant"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_k3_callers_choices(monkeypatch, k3_spy, ops, long, calls, dtype):
    # the final LayerNorm (every table), per_op's LN1 and LN2, and the long
    # block's LN1 past the switch (lowered to 4 tokens, as the flash tests do)
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import fused_block, get_ops
    from vit_tpu_torch.ops import quant as TQ

    if long:
        monkeypatch.setattr(fused_block, "VMEM_ATTENTION_MAX_T", 4)
    cfg = _tiny_cfg()
    params, images = _params_images(cfg, dtype)
    if ops == "quant":
        params = TQ.cast_quantized_params(TQ.quantize_params(
            vit.init_params(torch.Generator().manual_seed(1), cfg)), dtype)
    with torch.inference_mode():
        vit.forward(params, images, cfg, get_ops(ops))
    assert len(k3_spy) == calls
    for choice in k3_spy:
        _legal(choice)
        assert choice[1].shape[-1] == cfg.embed_dim and choice[1].dtype == dtype
        assert choice[0] == (2 if dtype == torch.bfloat16 else 0)


@pytest.mark.parametrize("quant", [False, True], ids=["fused", "quant"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["fp32", "bf16"])
def test_k3_tp_choices(k3_spy, quant, dtype):
    # parallel/tp_forward's final LayerNorm on every rank of tp 2 (a
    # one-process mesh whose all-reduces do nothing)
    from vit_tpu_torch.models import vit
    from vit_tpu_torch.ops import quant as TQ
    from vit_tpu_torch.parallel.mesh import Mesh
    from vit_tpu_torch.parallel.sharding import shard_params
    from vit_tpu_torch.parallel.tp_forward import shard_forward_tp

    cfg = _tiny_cfg()
    params, images = _params_images(cfg, dtype)
    if quant:
        params = TQ.cast_quantized_params(TQ.quantize_params(
            vit.init_params(torch.Generator().manual_seed(1), cfg)), dtype)
    for rank in range(2):
        mesh = Mesh({"tp": 2}, rank, {"tp": None})
        with torch.inference_mode():
            shard_forward_tp(cfg, mesh, "quant" if quant else "fused")(
                shard_params(params, mesh), images)
    assert len(k3_spy) == 2
    for choice in k3_spy:
        _legal(choice)
        assert choice[1].shape == (2, cfg.seq_len, cfg.embed_dim)
        assert choice[0] == (2 if dtype == torch.bfloat16 else 0)
