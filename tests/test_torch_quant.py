"""The W8A8 slice of the port — ``ops/quant.py``, the K15/K16/K17 plain
twins, the quant blocks, ``get_ops("quant")``, ``InferenceEngine(ops=
"quant")`` and ``vit-tpu-torch --ops quant`` — against the JAX package on
the CPU (its Pallas kernels in interpret mode; the port's kernels through
their plain twins, which is what a CPU tensor gets).

Tolerances.  The quantizers and the int8 reference GEMM are exact
operations (an fp32 divide, round-half-to-even, a clip, integer sums): the
port's codes, scales and products equal the JAX package's bit for bit.

The composed functions quantize a LayerNorm output whose last bits depend
on the order in which torch and XLA reduce the mean and the variance, so
once in some ten thousand codes one that sat on a rounding boundary moves
by one step, and every output of that row moves by a quantization step
(about 1e-2 here) instead of by rounding noise (about 1e-6).  So: all but
``OUTLIER_ROWS`` of the rows agree within the usual tolerance of the dtype
(fp32 1e-5 absolute; bf16 2e-2 absolute plus 2^-7 relative, as in
``test_torch_kernels.py``), and every element agrees within ``STEP_RTOL`` =
2^-6 of the largest |value| — a few code steps (one step is 127^-1 of a
row's largest value).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vit_tpu.ops.pallas.fused_block as JF
import vit_tpu.ops.pallas.quant_kernels as JK
from vit_tpu.io import weights as wio
from vit_tpu.io.images import synth_images
from vit_tpu.models import vit as jvit
from vit_tpu.ops import quant as JQ
from vit_tpu.ops.dispatch import get_ops as jget_ops
from vit_tpu_torch.eval import quant_stages
from vit_tpu_torch.io.params import params_from_numpy, params_to_numpy
from vit_tpu_torch.models import vit as tvit
from vit_tpu_torch.ops import fused_block as TF
from vit_tpu_torch.ops import quant as TQ
from vit_tpu_torch.ops import quant_block as TQB
from vit_tpu_torch.ops.dispatch import get_ops
from vit_tpu_torch.ops.kernels import ln_mlp_residual_q8 as K17
from vit_tpu_torch.ops.kernels import ln_qkv_attn_q8 as K15
from vit_tpu_torch.ops.kernels import out_ln_mlp_residual_q8 as K16
from vit_tpu_torch.runtime.engine import InferenceEngine

TOL = {"float32": dict(atol=1e-5, rtol=0), "bfloat16": dict(atol=2e-2, rtol=2 ** -7)}
DTYPES = ["float32", "bfloat16"]
OUTLIER_ROWS = 0.02  # share of rows that may hold a moved code
STEP_RTOL = 2.0 ** -6


def _np(seed, *shape, scale=1.0, shift=0.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale + shift).astype(np.float32)


def _pair(a, dtype):
    """One numpy array as (jax, torch) operands: float arrays in ``dtype``,
    int8 arrays as they are.  Same bits on both sides."""
    if a.dtype == np.int8:
        return jnp.asarray(a), torch.from_numpy(a)
    return jnp.asarray(a).astype(dtype), torch.from_numpy(a).to(getattr(torch, dtype))


def _same(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def _close_q8(got: torch.Tensor, want, dtype: str, outlier_rows: float = OUTLIER_ROWS) -> None:
    """The composed functions' tolerance (module docstring), by rows."""
    got = got.float().numpy().reshape(-1, got.shape[-1])
    want = want.float().numpy() if torch.is_tensor(want) else np.asarray(want.astype(jnp.float32))
    want = want.reshape(got.shape)
    assert np.isfinite(got).all()
    tol = TOL[dtype]
    bad = (np.abs(got - want) > tol["atol"] + tol["rtol"] * np.abs(want)).any(-1)
    assert bad.mean() <= outlier_rows, f"{bad.sum()} of {len(bad)} rows outside {tol}"
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=STEP_RTOL * max(1.0, np.abs(want).max()) + tol["atol"])


# -- ops/quant.py: bit for bit -------------------------------------------------


def _tie_rows():
    """Rows whose absmax is 127, so the scale is exactly 1 and x.5 values
    are exact ties; and an all-zero row."""
    x = np.zeros((4, 16), np.float32)
    x[0, :9] = [127, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    x[1, :4] = [-127, 63.5, 64.5, 1e-30]
    x[3, :3] = [254, 1.0, 3.0]  # scale 2: ties at odd values
    return x


@pytest.mark.parametrize("case", ["normal", "ties_and_zero_row", "tiny_values", "wide"])
def test_quantize_activations_bit_for_bit(case):
    x = {"normal": _np(0, 5, 7, 64, scale=3.0), "ties_and_zero_row": _tie_rows(),
         "tiny_values": _np(1, 6, 32, scale=1e-14), "wide": _np(2, 9, 3072, scale=10.0)}[case]
    q, s = TQ.quantize_activations(torch.from_numpy(x))
    jq, js = JQ.quantize_activations(jnp.asarray(x))
    _same(q, jq)
    _same(s, js)
    if case == "ties_and_zero_row":
        assert q[0, :9].tolist() == [127, 0, 2, 2, 0, -2, -2, 126, -126]  # half to even
        assert q[2].abs().max() == 0 and s[2] == np.float32(1e-12) and torch.isfinite(s).all()


@pytest.mark.parametrize("shape", [(64, 32), (3, 64, 48), (2, 256, 64)])
def test_quantize_weight_bit_for_bit(shape):
    w = _np(3, *shape, scale=shape[-2] ** -0.5)
    w[..., 0] = 0.0  # an all-zero output channel
    got, want = TQ.quantize_weight(torch.from_numpy(w)), JQ.quantize_weight(w)
    _same(got.w_q, want.w_q)
    _same(got.scale, want.scale)
    assert got.scale.shape == (shape[-1],) and isinstance(got, TQ.QuantizedLinear)
    if len(shape) == 3:
        (q, s), (jq, js) = TQ.quantize_weight_stacked(torch.from_numpy(w)), JQ.quantize_weight_stacked(w)
        _same(q, jq)
        _same(s, js)
        assert s.shape == (shape[0], shape[2]) and q.dtype == torch.int8


@pytest.mark.parametrize("k", [64, 3072])
def test_int8_matmul_reference_bit_for_bit(k):
    # K = 3,072 with +-127 operands: sums of 4.95e7, past fp32's 2^24
    rng = np.random.default_rng(4)
    a = rng.integers(-127, 128, (7, k)).astype(np.int8)
    b = rng.integers(-127, 128, (k, 32)).astype(np.int8)
    a[0], b[:, 0] = 127, 127
    a[1], b[:, 1] = 127, -127
    sa, sb, bias = np.abs(_np(5, 7)) + 0.1, np.abs(_np(6, 32)) + 0.1, _np(7, 32)
    args = (a, sa, b, sb)
    for extra in ((), (bias,)):
        got = TQ.int8_matmul_reference(*(torch.from_numpy(v) for v in (*args, *extra)))
        _same(got, JQ.int8_matmul_reference(*(jnp.asarray(v) for v in (*args, *extra))))
    assert TQ.int8_dot(torch.from_numpy(a), torch.from_numpy(b))[0, 0] == 127 * 127 * k
    x = _np(8, 2, 5, k, scale=2.0)
    _same(TQ.linear_w8a8(torch.from_numpy(x), torch.from_numpy(b), torch.from_numpy(sb),
                         torch.from_numpy(bias)),
          JQ.linear_w8a8(jnp.asarray(x), jnp.asarray(b), jnp.asarray(sb), jnp.asarray(bias)))


def _assert_same_tree(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, dict):
            _assert_same_tree(got[k], v)
        else:
            v = np.asarray(v.astype(jnp.float32)) if v.dtype == jnp.bfloat16 else np.asarray(v)
            g = got[k].float() if got[k].dtype == torch.bfloat16 else got[k]
            assert g.numpy().dtype == v.dtype, k
            np.testing.assert_array_equal(g.numpy(), v, err_msg=k)


@pytest.fixture(scope="module")
def tree(tiny_cfg):
    return wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=1), tiny_cfg)


def test_quantize_params_matches_jax(tree):
    got = TQ.quantize_params(params_from_numpy(tree, "cpu"))
    want = JQ.quantize_params(jax.tree.map(jnp.asarray, tree))
    _assert_same_tree(got, want)
    blocks = got["blocks"]
    for name in ("wqkv", "w1", "w2"):
        assert blocks[name].dtype == torch.int8 and blocks[name + "_scale"].dtype == torch.float32
    assert blocks["wo"].dtype == torch.float32 and "wo_scale" not in blocks  # wo stays fp
    assert TQ._QUANT_SCALE_KEYS == JQ._QUANT_SCALE_KEYS


def test_cast_quantized_params_matches_jax(tree):
    got = TQ.cast_quantized_params(TQ.quantize_params(params_from_numpy(tree, "cpu")),
                                   torch.bfloat16)
    want = JQ.cast_quantized_params(JQ.quantize_params(jax.tree.map(jnp.asarray, tree)),
                                    jnp.bfloat16)
    _assert_same_tree(got, want)
    blocks = got["blocks"]
    assert blocks["ln1_scale"].dtype == torch.bfloat16  # LayerNorm gains ARE cast
    assert blocks["wqkv_scale"].dtype == torch.float32 and blocks["wqkv"].dtype == torch.int8
    assert blocks["wo"].dtype == torch.bfloat16 and got["pos_embed"].dtype == torch.bfloat16


# -- the kernels' twins against the Pallas kernels ----------------------------


def _ln_operands(d, seed):
    return _np(seed, d, scale=0.2, shift=1.0), _np(seed + 1, d, scale=0.2)


def _q(w):
    q = TQ.quantize_weight(torch.from_numpy(w))
    return q.w_q.numpy(), q.scale.numpy()


def _k15_operands(b, t, d, seed):
    x = _np(seed, b * t, d, scale=2.0)
    s, bias = _ln_operands(d, seed + 1)
    wq, ws = _q(_np(seed + 3, d, 3 * d, scale=d ** -0.5))
    return x, s, bias, wq, ws, _np(seed + 4, 3 * d, scale=0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize(
    "b,t,d,h", [(3, 5, 64, 4), (7, 19, 64, 4), (2, 37, 128, 2)],
    ids=["tiny", "ragged_133_rows", "dh64"],
)
def test_ln_qkv_attn_q8_twin_matches_pallas(dtype, b, t, d, h):
    raw = _k15_operands(b, t, d, 10)
    ops = [_pair(a, dtype) for a in raw]
    ops[4] = _pair(raw[4], "float32")
    want = JK.ln_qkv_attn_q8(*(o[0] for o in ops), h, t, 1e-6, interpret=True)
    got = K15.ln_qkv_attn_q8_plain(*(o[1] for o in ops), h, t, 1e-6)
    assert tuple(got.shape) == (b * t, d) and got.dtype == getattr(torch, dtype)
    _close_q8(got, want, dtype)
    # stages 1-2 alone are the JAX package's _qkv_q8, rounded to the dtype
    hq, hs, qkv = K15.ln_qkv_q8_plain(*(o[1] for o in ops), 1e-6)
    jqkv = JK._qkv_q8(*(o[0] for o in ops), 1e-6).astype(dtype)
    assert hq.dtype == torch.int8 and hs.dtype == torch.float32 and qkv.dtype == got.dtype
    _close_q8(qkv, jqkv, dtype)


def _mlp_operands(rows, d, f, seed):
    x = _np(seed + 1, rows, d, scale=2.0)
    s, bias = _ln_operands(d, seed + 4)
    w1q, w1s = _q(_np(seed + 6, d, f, scale=d ** -0.5))
    w2q, w2s = _q(_np(seed + 8, f, d, scale=f ** -0.5))
    return x, s, bias, w1q, w1s, _np(seed + 7, f, scale=0.1), w2q, w2s, _np(seed + 9, d, scale=0.1)


def _mlp_pairs(raw, dtype):
    return [_pair(a, "float32" if i in (4, 7) else dtype) for i, a in enumerate(raw)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows", [10, 133], ids=["tiny", "ragged_133"])
def test_out_ln_mlp_residual_q8_twin_matches_pallas(dtype, variant, rows):
    d, f = 64, 256
    head = [_pair(a, dtype) for a in (_np(20, rows, d), _np(22, d, d, scale=d ** -0.5),
                                      _np(23, d, scale=0.1))]
    res, *mlp = _mlp_pairs(_mlp_operands(rows, d, f, 20), dtype)
    ops = [head[0], res, head[1], head[2], *mlp]
    want = JK.out_ln_mlp_residual_q8(*(o[0] for o in ops), 1e-6, variant, block_rows=64,
                                     interpret=True)
    got = K16.out_ln_mlp_residual_q8_plain(*(o[1] for o in ops), 1e-6, variant)
    assert tuple(got.shape) == (rows, d) and got.dtype == getattr(torch, dtype)
    _close_q8(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
@pytest.mark.parametrize("rows", [10, 133], ids=["tiny", "ragged_133"])
def test_ln_mlp_residual_q8_twin_matches_pallas(dtype, variant, rows):
    ops = _mlp_pairs(_mlp_operands(rows, 64, 256, 40), dtype)
    want = JK.ln_mlp_residual_q8(*(o[0] for o in ops), 1e-6, variant, block_rows=64,
                                 interpret=True)
    got = K17.ln_mlp_residual_q8_plain(*(o[1] for o in ops), 1e-6, variant)
    assert tuple(got.shape) == (rows, 64) and got.dtype == getattr(torch, dtype)
    _close_q8(got, want, dtype)


def test_mlp_q8_keeps_mid_in_fp32_and_zero_rows_finite():
    # a zero mid row (W1 = 0, b1 = 0 -> gelu(0) = 0) quantizes to codes 0
    # with the floor scale, and the block output is b2 + x
    raw = list(_mlp_operands(6, 64, 256, 50))
    raw[3], raw[5] = np.zeros_like(raw[3]), np.zeros_like(raw[5])
    ops = [o[1] for o in _mlp_pairs(raw, "bfloat16")]
    st = K17.mlp_q8_plain(*ops, 1e-6, "exact", torch.bfloat16)
    assert st["mid"].dtype == torch.float32 and st["mid"].abs().max() == 0
    assert st["mq"].abs().max() == 0 and (st["ms"] == np.float32(1e-12)).all()
    torch.testing.assert_close(st["out"], (ops[8].float() + ops[0].float()).bfloat16(),
                               rtol=0, atol=0)


# -- the blocks ----------------------------------------------------------------


def _quant_blocks(tiny_params, dtype="float32"):
    """Layer 0 of the quantized tiny params, as (jax, torch) dicts."""
    qp = JQ.cast_quantized_params(JQ.quantize_params(tiny_params), getattr(jnp, dtype))
    jblk = jax.tree.map(lambda a: a[0], qp["blocks"])
    tblk = {k: v[0] for k, v in params_from_numpy(
        {k: np.array(v.astype(jnp.float32) if v.dtype == jnp.bfloat16 else v)
         for k, v in qp["blocks"].items()}, "cpu", getattr(torch, dtype)).items()}
    return jblk, tblk


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_fused_encoder_block_q8_matches_pallas(tiny_cfg, tiny_params, dtype, variant):
    t, d = tiny_cfg.seq_len, tiny_cfg.embed_dim
    jblk, tblk = _quant_blocks(tiny_params, dtype)
    assert tblk["wqkv"].dtype == torch.int8 and tblk["w1_scale"].dtype == torch.float32
    jx, tx = _pair(_np(30, 6 * t, d), dtype)
    args = (tiny_cfg.num_heads, t, tiny_cfg.layernorm_eps, variant)
    want = JK.fused_encoder_block_q8(jx, jblk, *args, interpret=True)
    _close_q8(TQB.fused_encoder_block_q8(tx, tblk, *args), want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_long_seq_block_q8_matches_pallas_and_the_short_block(tiny_cfg, tiny_params, dtype,
                                                              monkeypatch):
    import vit_tpu_torch.ops.kernels.flash_attention as KFA

    t, d = tiny_cfg.seq_len, tiny_cfg.embed_dim
    jblk, tblk = _quant_blocks(tiny_params, dtype)
    jx, tx = _pair(_np(31, 4 * t, d), dtype)
    args = (tiny_cfg.num_heads, t, tiny_cfg.layernorm_eps, "exact")
    short = TQB.fused_encoder_block_q8(tx, tblk, *args)
    calls = []
    plain = KFA.flash_attention_fwd_plain
    monkeypatch.setattr(KFA, "flash_attention_fwd_plain", lambda *a: calls.append(1) or plain(*a))
    monkeypatch.setattr(JF, "VMEM_ATTENTION_MAX_T", 4)  # T = 5 > 4
    monkeypatch.setattr(TF, "VMEM_ATTENTION_MAX_T", 4)
    got = TQB.fused_encoder_block_q8(tx, tblk, *args)
    assert calls == [1]  # went through K13's twin
    want = JK.fused_encoder_block_q8(jx, jblk, *args, interpret=True)
    _close_q8(got, want, dtype)
    # identical QKV codes (one QKV stage for both blocks); only the
    # attention's accumulation order differs, and the context it feeds LN2's
    # quantizer with: the JAX package's own bar between its blocks
    # (tests/test_quant.py, atol 1e-5) wherever no code moved.  In bf16 the
    # two contexts differ by whole bf16 roundings, not by fp32 noise, so a
    # moved LN2 code is common: there only the step bound holds.
    _close_q8(got, short, dtype, outlier_rows=OUTLIER_ROWS if dtype == "float32" else 1.0)


# -- the slice as a whole --------------------------------------------------------


@pytest.fixture(scope="module")
def images(tiny_cfg):
    return synth_images(6, tiny_cfg, seed=2)


@pytest.fixture(scope="module")
def jax_quant_fp32(tiny_cfg, tree, images):
    qp = JQ.quantize_params(jax.tree.map(jnp.asarray, tree))
    return np.asarray(jvit.forward(qp, jnp.asarray(images), tiny_cfg, jget_ops("quant")))


def _probs(logits):
    e = np.exp(logits - logits.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)


def test_quant_ops_table():
    from vit_tpu_torch.ops import fused
    from vit_tpu_torch.ops.kernels.attention import attention
    from vit_tpu_torch.ops.kernels.layer_norm import layer_norm
    from vit_tpu_torch.ops.kernels.mlp import mlp

    ops = get_ops("quant")
    assert ops is fused.QUANT_OPS and ops.name == "quant"
    assert ops.encoder_block is TQB.fused_encoder_block_q8 and ops.layer_norm is layer_norm
    # the per-op K21/K22, as the JAX quant table has them (phase_report's slots)
    assert ops.attention is attention and ops.mlp is mlp and ops.encoder_block_train is None
    with pytest.raises(ValueError, match="ROADMAP"):
        get_ops("qat")


@pytest.mark.parametrize("long", [False, True], ids=["short", "long_blocks"])
def test_quant_forward_fp32_matches_jax(tiny_cfg, tree, images, jax_quant_fp32, long, monkeypatch):
    if long:
        monkeypatch.setattr(TF, "VMEM_ATTENTION_MAX_T", 4)
    params = TQ.quantize_params(params_from_numpy(tree, "cpu"))
    got = tvit.forward(params, torch.from_numpy(images), tiny_cfg, get_ops("quant"))
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, tiny_cfg.num_classes)
    _close_q8(got, jnp.asarray(jax_quant_fp32), "float32")
    np.testing.assert_array_equal(got.numpy().argmax(-1), jax_quant_fp32.argmax(-1))


@pytest.mark.parametrize("variant", ["exact", "tanh"])
def test_quant_forward_bf16_matches_jax(tiny_cfg, tree, images, jax_quant_fp32, variant):
    jp = JQ.cast_quantized_params(JQ.quantize_params(jax.tree.map(jnp.asarray, tree)),
                                  jnp.bfloat16)
    want = jvit.forward(jp, jnp.asarray(images).astype(jnp.bfloat16), tiny_cfg,
                        jget_ops("quant"), gelu_variant=variant)
    tp = TQ.cast_quantized_params(TQ.quantize_params(params_from_numpy(tree, "cpu")),
                                  torch.bfloat16)
    got = tvit.forward(tp, torch.from_numpy(images), tiny_cfg, get_ops("quant"),
                       gelu_variant=variant)
    _close_q8(got, want, "bfloat16")
    p32 = np.sort(_probs(jax_quant_fp32), -1)
    decisive = (p32[:, -1] - p32[:, -2]) > 0.01
    assert decisive.any()
    assert not ((got.numpy().argmax(-1) != np.asarray(want).argmax(-1)) & decisive).any()


def test_quantized_jax_tree_carried_across(tiny_cfg, tree, images):
    """A tree the JAX package quantized, carried over by params_from_numpy
    (int8 stays int8, the three scales stay fp32 under a bf16 cast), gives
    the logits of quantizing in the port — and comes back unchanged."""
    jq = jax.tree.map(np.asarray, JQ.quantize_params(jax.tree.map(jnp.asarray, tree)))
    carried = params_from_numpy(jq, "cpu", torch.bfloat16)
    ours = TQ.cast_quantized_params(TQ.quantize_params(params_from_numpy(tree, "cpu")),
                                    torch.bfloat16)
    blocks = carried["blocks"]
    assert blocks["w2"].dtype == torch.int8 and blocks["w2_scale"].dtype == torch.float32
    assert blocks["ln2_scale"].dtype == torch.bfloat16
    x = torch.from_numpy(images)
    torch.testing.assert_close(tvit.forward(carried, x, tiny_cfg, get_ops("quant")),
                               tvit.forward(ours, x, tiny_cfg, get_ops("quant")), rtol=0, atol=0)
    back = params_to_numpy(params_from_numpy(jq, "cpu"))
    assert back["blocks"]["wqkv"].dtype == np.int8
    np.testing.assert_array_equal(back["blocks"]["wqkv"], jq["blocks"]["wqkv"])
    np.testing.assert_array_equal(back["blocks"]["w1_scale"], jq["blocks"]["w1_scale"])


@pytest.mark.parametrize("dtype", DTYPES)
def test_engine_quant_labels_match_jax_and_eager(tiny_cfg, tree, images, jax_quant_fp32, dtype):
    from vit_tpu.runtime import InferenceEngine as JaxEngine

    engine = InferenceEngine(tiny_cfg, tree, dtype=dtype, ops="quant", device="cpu",
                             batch_pad=4)  # 6 images pad to 8
    blocks = engine.params["blocks"]
    assert blocks["wqkv"].dtype == torch.int8 and blocks["wqkv_scale"].dtype == torch.float32
    assert blocks["wo"].dtype == engine.compute_dtype == blocks["ln1_scale"].dtype
    labels, top = engine.classify(images)
    jlabels, jtop = JaxEngine(tiny_cfg, tree, dtype=dtype, ops="quant", batch_pad=4).classify(images)
    eager = InferenceEngine(tiny_cfg, tree, dtype="float32", ops="eager", device="cpu")
    np.testing.assert_array_equal(labels, jlabels)
    np.testing.assert_array_equal(labels, eager.classify(images)[0])  # labels preserved
    np.testing.assert_allclose(top, jtop, atol=1e-5 if dtype == "float32" else 0.01, rtol=0)
    if dtype == "float32":
        _close_q8(engine.logits(images), jnp.asarray(jax_quant_fp32), dtype)


def test_engine_quant_swap_params(tiny_cfg, tree, images):
    engine = InferenceEngine(tiny_cfg, tree, dtype="bfloat16", ops="quant", device="cpu")
    other = wio.params_from_tensors(wio.synth_reference_tensors(tiny_cfg, seed=9), tiny_cfg)
    before = engine.logits(images)
    engine.swap_params(other)  # quantized anew from the fp32 tree: same dtypes leaf by leaf
    assert engine.params["blocks"]["w1"].dtype == torch.int8
    assert not torch.equal(before, engine.logits(images))
    fresh = InferenceEngine(tiny_cfg, other, dtype="bfloat16", ops="quant", device="cpu")
    torch.testing.assert_close(engine.logits(images), fresh.logits(images), rtol=0, atol=0)
    bad = dict(other, head={"kernel": np.zeros((tiny_cfg.embed_dim, 3), np.float32),
                            "bias": np.zeros((3,), np.float32)})
    with pytest.raises(ValueError, match="shapes"):
        engine.swap_params(bad)


def test_cli_quant_writes_reference_format(tiny_cfg, tmp_path, capsys, monkeypatch,
                                           jax_quant_fp32):
    from vit_tpu import config
    from vit_tpu.eval import comparator
    from vit_tpu_torch import config as tconfig
    from vit_tpu_torch.cli.main import main

    monkeypatch.setitem(config.CONFIGS, tiny_cfg.name, tiny_cfg)
    monkeypatch.setitem(tconfig.CONFIGS, tiny_cfg.name, tiny_cfg)
    d = tmp_path / "Network"
    wio.save_reference_weights(wio.synth_reference_tensors(tiny_cfg, seed=1), d, tiny_cfg)
    out = tmp_path / "result.txt"
    assert main(["--config", tiny_cfg.name, "--weights", str(d), "--synth", "4", "--device", "cpu",
                 "--dtype", "float32", "--ops", "quant", "--output", str(out), "--json"]) == 0
    lines = comparator.parse_result_file(out)
    assert [l.index for l in lines] == [0, 1, 2, 3]
    # the JAX package's quant path on the same (6-decimal rounded) weights
    qp = JQ.quantize_params(jax.tree.map(jnp.asarray, wio.load_reference_weights(d, tiny_cfg)))
    want = _probs(np.asarray(jvit.forward(qp, jnp.asarray(synth_images(4, tiny_cfg, 0)), tiny_cfg,
                                          jget_ops("quant"))))
    assert [l.label for l in lines] == list(want.argmax(-1))
    np.testing.assert_allclose([l.prob for l in lines], want.max(-1), atol=1e-5, rtol=0)
    stdout = capsys.readouterr().out
    assert "ops: quant" in stdout and '"ops": "quant"' in stdout


# -- wrappers: CPU twin, no fallback, launch counts; the card checks' logic ------


def _cpu_cases():
    k15 = [torch.from_numpy(a) for a in _k15_operands(2, 5, 64, 60)]
    mlp = [torch.from_numpy(a) for a in _mlp_operands(10, 64, 256, 61)]
    head = [torch.from_numpy(a) for a in (_np(62, 10, 64), _np(63, 64, 64, scale=0.125),
                                          _np(64, 64, scale=0.1))]
    return {
        "ln_qkv_attn_q8": (K15, (*k15, 4, 5, 1e-6)),
        "out_ln_mlp_residual_q8": (K16, (head[0], mlp[0], head[1], head[2], *mlp[1:], 1e-6)),
        "ln_mlp_residual_q8": (K17, (*mlp, 1e-6)),
    }


@pytest.mark.parametrize("kernel", ["ln_qkv_attn_q8", "out_ln_mlp_residual_q8",
                                    "ln_mlp_residual_q8"])
def test_cpu_q8_wrappers_run_the_twin_and_count_no_launch(kernel):
    mod, args = _cpu_cases()[kernel]
    fn = getattr(mod, kernel)
    count = fn.launches
    got = fn(*args)
    torch.testing.assert_close(got, getattr(mod, f"{kernel}_plain")(*args), rtol=0, atol=0)
    assert fn.launches == count and K15.ln_qkv_q8.launches == 0
    # the twin's own stages pass the card checks, with no code moved
    st = getattr(mod, f"_{kernel}_stages")(*args)
    report = getattr(quant_stages, f"check_{kernel}")(st, got, *args)
    assert report["hq flipped"] == 0 and report["end to end"] == 0
    if kernel == "ln_qkv_attn_q8":
        torch.testing.assert_close(K15.ln_qkv_q8(*args[:6], 1e-6), st["qkv"], rtol=0, atol=0)
        x_q, s_x = TQ.quantize_activations(args[0])
        torch.testing.assert_close(K15.gemm_q8_dequant(x_q, s_x, args[3], args[4]),
                                   TQ.int8_matmul_reference(x_q, s_x, args[3], args[4]),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("fault", ["code_off_by_two", "too_many_moved_codes", "scale", "mid",
                                   "mq_not_exact", "out"])
def test_stage_checks_catch_a_faulty_kernel(fault):
    mod, args = _cpu_cases()["ln_mlp_residual_q8"]
    st = mod._ln_mlp_residual_q8_stages(*args)
    end = st["out"].clone()
    if fault == "code_off_by_two":
        st["hq"][3, 5] += 2 if st["hq"][3, 5] < 100 else -2
    elif fault == "too_many_moved_codes":
        st["hq"][:, 0] += torch.where(st["hq"][:, 0] < 100, 1, -1).to(torch.int8)  # 1/64 of them
    elif fault == "scale":
        st["hs"][2] *= 1 + 2.0 ** -18
    elif fault == "mid":
        st["mid"][4, 7] += 1e-3
    elif fault == "mq_not_exact":
        st["mq"][1, 9] += 1 if st["mq"][1, 9] < 100 else -1
    else:
        st["out"][0, 0] += 0.01
    with pytest.raises(AssertionError):
        quant_stages.check_ln_mlp_residual_q8(st, end, *args)


@pytest.mark.parametrize("kernel", ["ln_qkv_attn_q8", "ln_qkv_q8", "out_ln_mlp_residual_q8",
                                    "ln_mlp_residual_q8", "gemm_q8_dequant"])
def test_q8_wrappers_refuse_other_devices(kernel):
    # a non-CPU tensor either launches the kernel or raises; never the twin
    m = lambda *s, dtype=torch.float32: torch.empty(*s, device="meta", dtype=dtype)  # noqa: E731
    q = lambda *s: m(*s, dtype=torch.int8)  # noqa: E731
    mlp = (m(64), m(64), q(64, 256), m(256), m(256), q(256, 64), m(64), m(64), 1e-6)
    calls = {
        "ln_qkv_attn_q8": lambda: K15.ln_qkv_attn_q8(m(10, 64), m(64), m(64), q(64, 192), m(192),
                                                     m(192), 4, 5, 1e-6),
        "ln_qkv_q8": lambda: K15.ln_qkv_q8(m(10, 64), m(64), m(64), q(64, 192), m(192), m(192),
                                           1e-6),
        "out_ln_mlp_residual_q8": lambda: K16.out_ln_mlp_residual_q8(
            m(10, 64), m(10, 64), m(64, 64), m(64), *mlp),
        "ln_mlp_residual_q8": lambda: K17.ln_mlp_residual_q8(m(10, 64), *mlp),
        "gemm_q8_dequant": lambda: K15.gemm_q8_dequant(q(10, 64), m(10), q(64, 32), m(32)),
    }
    with pytest.raises(ValueError, match="CUDA or CPU"):
        calls[kernel]()


def test_token_merging_hooks_wait_for_their_slice():
    # the token-merging hooks are ported: a zero log-size bias adds nothing,
    # and the k-mean is the mean key over heads (test_torch_tome.py holds
    # both hooks to the JAX package)
    _, args = _cpu_cases()["ln_qkv_attn_q8"]
    ctx, kmean = K15.ln_qkv_attn_q8(*args, log_size=torch.zeros(2, 5), return_kmean=True)
    assert torch.equal(ctx, K15.ln_qkv_attn_q8(*args))
    assert kmean.shape == (ctx.shape[0], ctx.shape[1] // args[6])


def test_kernel_registry_finds_the_q8_wrappers():
    from vit_tpu_torch.ops.kernels import wrapper

    for name in ("ln_qkv_attn_q8", "ln_qkv_q8", "out_ln_mlp_residual_q8", "ln_mlp_residual_q8"):
        assert wrapper(name).launches == 0 and wrapper(name).__name__ == name
