"""K18a: LN2 -> per-row int8 -> int8 FC1 over this shard's hidden columns ->
dequant + b1 -> GELU into an fp32 ``mid``, CUDA (``csrc/ln_fc1_gelu_q8.cu``).

Replaces ``vit_tpu/ops/pallas/quant_kernels.py:ln_fc1_gelu_q8`` (def :394,
pallas_call at :406; body ``_ln_fc1_gelu_q8_kernel`` :380).

The first half of the tensor-parallel W8A8 MLP (``parallel/tp_forward.py:
_mlp_q8_tp``): W1 arrives as this shard's int8 columns (D, F/tp) with their
fp32 scales and bias.  It is stages 1-2 of the MLP K16 and K17 share cut at
the ``mid`` scratch: the next quantizer's row scale is an absmax over the
whole hidden row, which spans every shard, so the caller takes it across
shards and hands it to K18b (``fc2_q8_partial.py``).

  1. LN2 in fp32 from fp32 statistics, per-row int8 codes hq and scales hs
     (``csrc/quant_rows.cuh``'s row pass, K17's own: its codes bit for
     bit): the input is replicated over the shards, so every shard
     quantizes it alike;
  2. hq @ W1q with exact int32 sums; epilogue GELU((acc * hs) * w1s + b1)
     in fp32, kept fp32 in ``mid``.  ``fast_erf`` picks the erf form; the
     tensor-parallel MLP passes ``use_fast_erf(dtype)``, the unsharded
     kernels' form, because a different erf would move values right before
     the next round().

bf16, the main path, runs stage 2 on the int8 TMA + ``wgmma`` core
(``csrc/gemm_mma_q8.cuh``), which reads both operands K-major: the launch
sequence first copies this shard's W1q transposed into an int8 scratch
``w1t`` (``kmajor_q8.py``'s kernel), which stays in L2 while the codes
stream through TMA.  Its operand rule (``check_tile_operands``): W1q
16-byte aligned with both dimensions multiples of 16 (its copy's and the
code scratch's row pitches).  fp32 keeps the first design, the WMMA int8
core (``csrc/gemm_q8.cuh``), under the same rule.

What bounds it on the H100: at B/16 batch 100 and tp = 2 the fp32 ``mid``
(121 MB) is most of its ~152 MB (0.045 ms at 3.35 TB/s); the GEMM is
46.5 G integer operations (0.024 ms at the int8 peak).
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _gelu, _ln
from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.kmajor_q8 import kmajor_q8_scratch
from vit_tpu_torch.ops.kernels.out_ln_mlp_residual import GELU_VARIANTS
from vit_tpu_torch.ops.quant import int8_matmul_reference, quantize_activations


def ln_fc1_gelu_q8_stages_plain(x2d, ln_scale, ln_bias, w1q, w1s, b1, eps,
                                gelu_variant="exact", fast_erf=False) -> dict:
    """The plain twin's stages: {hq, hs, mid}."""
    hq, hs = quantize_activations(_ln(x2d, ln_scale, ln_bias, eps))
    u = int8_matmul_reference(hq, hs, w1q, w1s.float(), b1.float())
    return {"hq": hq, "hs": hs, "mid": _gelu(u, gelu_variant, fast_erf=fast_erf)}


def ln_fc1_gelu_q8_plain(x2d, ln_scale, ln_bias, w1q, w1s, b1, eps, gelu_variant="exact",
                         fast_erf=False) -> torch.Tensor:
    """Plain twin: fp32 compute with the TPU kernel's quantization grouping."""
    return ln_fc1_gelu_q8_stages_plain(x2d, ln_scale, ln_bias, w1q, w1s, b1, eps, gelu_variant,
                                       fast_erf)["mid"]


def check_tile_operands(x2d, ln_scale, ln_bias, w1q, *_, **__) -> None:
    """What the int8 cores read, and the wrapper checks with the rest of its
    operands: this shard's W1q two-dimensional, 16-byte aligned, both
    dimensions multiples of 16 (its K-major copy's pitch D and the width
    F/tp); the wrapper's arguments, raises ``ValueError`` otherwise."""
    _build.check_q8_matrices("ln_fc1_gelu_q8", w1q)


def _ln_fc1_gelu_q8_stages(x2d, ln_scale, ln_bias, w1q, w1s, b1, eps, gelu_variant="exact",
                           fast_erf=False) -> dict:
    """-> {hq, hs, mid}: the kernel's scratches and output on the card, the
    twin's on the CPU; bf16 on the card adds {w1t}, the K-major copy of W1q
    its int8 GEMM reads."""
    if x2d.device.type == "cpu":
        return ln_fc1_gelu_q8_stages_plain(x2d, ln_scale, ln_bias, w1q, w1s, b1, eps,
                                           gelu_variant, fast_erf)
    name = "ln_fc1_gelu_q8"
    if gelu_variant not in GELU_VARIANTS:
        raise ValueError(f"{name}: gelu_variant {gelu_variant!r} not in {tuple(GELU_VARIANTS)}")
    _build.check_q8_operands(name, x2d, (ln_scale, ln_bias, b1), (w1q,), (w1s,))
    rows, d = x2d.shape
    f = w1q.shape[-1]
    for n, t in (("ln_scale", ln_scale), ("ln_bias", ln_bias)):
        _build.check_shape(name, n, t, (d,))
    _build.check_shape(name, "w1q", w1q, (d, f))
    _build.check_shape(name, "w1s", w1s, (f,))
    _build.check_shape(name, "b1", b1, (f,))
    dev = x2d.device
    st = {"hq": torch.empty(rows, d, dtype=torch.int8, device=dev),
          "hs": torch.empty(rows, dtype=torch.float32, device=dev),
          "mid": torch.empty(rows, f, dtype=torch.float32, device=dev)}
    if x2d.dtype == torch.bfloat16:
        st["w1t"], = kmajor_q8_scratch(w1q)
    _build.check(
        _build.load_library().vt_ln_fc1_gelu_q8(
            x2d.data_ptr(), ln_scale.data_ptr(), ln_bias.data_ptr(), w1q.data_ptr(),
            w1s.data_ptr(), b1.data_ptr(), _build.ptr_or_null(st.get("w1t")),
            *(st[k].data_ptr() for k in ("hq", "hs", "mid")), rows, d, f,
            eps, GELU_VARIANTS[gelu_variant], int(bool(fast_erf)),
            _build.DTYPE_CODES[x2d.dtype], dev.index, _build.stream_of(x2d),
        ),
        name,
    )
    ln_fc1_gelu_q8.launches += 1
    return st


def ln_fc1_gelu_q8(x2d, ln_scale, ln_bias, w1q, w1s, b1, eps, gelu_variant="exact",
                   fast_erf=False) -> torch.Tensor:
    """(B*T, D) -> fp32 ``mid`` (B*T, F/tp) of this shard's hidden columns.
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
    return _ln_fc1_gelu_q8_stages(x2d, ln_scale, ln_bias, w1q, w1s, b1, eps, gelu_variant,
                                  fast_erf)["mid"]


ln_fc1_gelu_q8.launches = 0
