"""K18b: requantize the fp32 ``mid`` with a given per-row scale -> int8 FC2
over this shard's hidden rows -> raw int32 sums, CUDA
(``csrc/fc2_q8_partial.cu``).

Replaces ``vit_tpu/ops/pallas/quant_kernels.py:fc2_q8_partial`` (def :440,
pallas_call at :447; body ``_fc2_q8_partial_kernel`` :431).

The second half of the tensor-parallel W8A8 MLP (``parallel/tp_forward.py:
_mlp_q8_tp``).  ``ms`` (B*T, 1) fp32 is the caller's row scale, max(the
row's largest |mid| over every shard / 127, 1e-12): the unsharded
quantizer's scale over the whole hidden row, so there is no absmax here.
The codes are clip(round(mid / ms), -127, 127) with a true fp32 divide and
round-half-to-even, a warp per row with 16-byte loads; the int32 sums of
``mq @ W2q`` go out undequantized, so the shards' partial sums add exactly
(an int32 all-reduce) before the caller dequantizes in the unsharded
kernel's order.  FC2 runs on the int8 TMA + ``wgmma`` core
(``csrc/gemm_mma_q8.cuh``), which reads both operands K-major: the launch
sequence first copies this shard's W2q transposed into an int8 scratch
``w2t`` (``kmajor_q8.py``'s kernel).  Its operand rule
(``check_tile_operands``): ``mid`` contiguous fp32 on the 16-byte grid,
W2q 16-byte aligned with both dimensions multiples of 16 (the code
scratch's and the copy's row pitches F/tp and D).

What bounds it on the H100: at B/16 batch 100 and tp = 2, reading ``mid``
(121 MB) and writing the int32 sums (60.5 MB): ~183 MB, 0.055 ms at 3.35
TB/s.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.kernels import _build
from vit_tpu_torch.ops.kernels.kmajor_q8 import kmajor_q8_scratch
from vit_tpu_torch.ops.quant import int8_dot


def requantize_plain(mid, ms) -> torch.Tensor:
    """clip(round(mid / ms), -127, 127) as int8, ``ms`` (rows, 1): the
    divide tensor by tensor, as every quantizer of the port."""
    return torch.clamp(torch.round(mid.float() / ms), -127, 127).to(torch.int8)


def fc2_q8_partial_plain(mid, ms, w2q) -> torch.Tensor:
    """Plain twin: the codes' exact integer product, int32."""
    return int8_dot(requantize_plain(mid, ms), w2q).to(torch.int32)


def check_tile_operands(mid, ms, w2q) -> None:
    """What the kernel reads in whole 16 bytes: ``mid`` contiguous fp32 on
    the 16-byte grid (the row pass's float4 loads), W2q two-dimensional,
    16-byte aligned, both dimensions multiples of 16 (its K-major copy, and
    the code scratch's pitch F/tp); the wrapper's arguments, raises
    ``ValueError`` otherwise."""
    name = "fc2_q8_partial"
    if mid.dtype != torch.float32 or mid.dim() != 2 or not mid.is_contiguous():
        raise ValueError(f"{name}: mid must be a contiguous float32 matrix, got {mid.dtype} "
                         f"{tuple(mid.shape)} strides {tuple(mid.stride())}")
    _build.check_aligned(name, mid=mid)
    _build.check_q8_matrices(name, w2q)


def _fc2_q8_partial_stages(mid, ms, w2q) -> dict:
    """-> {mq, out}: the kernel's code scratch and int32 output on the card,
    the twin's on the CPU; on the card also {w2t}, the K-major copy of W2q
    its int8 GEMM reads."""
    if mid.device.type == "cpu":
        mq = requantize_plain(mid, ms)
        return {"mq": mq, "out": int8_dot(mq, w2q).to(torch.int32)}
    name = "fc2_q8_partial"
    check_tile_operands(mid, ms, w2q)
    _build.check_q8_operands(name, mid, (), (w2q,), (ms,))
    rows, f = mid.shape
    _build.check_shape(name, "ms", ms, (rows, 1))
    d = w2q.shape[-1]
    _build.check_shape(name, "w2q", w2q, (f, d))
    st = {"mq": torch.empty(rows, f, dtype=torch.int8, device=mid.device),
          "out": torch.empty(rows, d, dtype=torch.int32, device=mid.device)}
    st["w2t"], = kmajor_q8_scratch(w2q)
    _build.check(
        _build.load_library().vt_fc2_q8_partial(
            mid.data_ptr(), ms.data_ptr(), w2q.data_ptr(), st["w2t"].data_ptr(),
            st["mq"].data_ptr(), st["out"].data_ptr(), rows, f, d, mid.device.index,
            _build.stream_of(mid),
        ),
        name,
    )
    fc2_q8_partial.launches += 1
    return st


def fc2_q8_partial(mid, ms, w2q) -> torch.Tensor:
    """fp32 ``mid`` (B*T, F/tp), its row scales ``ms`` (B*T, 1) and this
    shard's int8 W2 rows (F/tp, D) -> int32 (B*T, D).  CPU tensors take the
    plain twin; CUDA tensors launch the kernel."""
    return _fc2_q8_partial_stages(mid, ms, w2q)["out"]


fc2_q8_partial.launches = 0
