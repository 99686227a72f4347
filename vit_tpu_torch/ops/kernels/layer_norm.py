"""K3: row LayerNorm, CUDA (``csrc/layer_norm.cu``).

Replaces ``vit_tpu/ops/pallas/ln_kernel.py:layer_norm`` (the Pallas
kernel, pallas_call at :57).  On the ``fused`` path it is the final
LayerNorm over all (B, T, D) rows.

On the H100 this is bound by device memory: one read and one write of the
activation (B/16 batch 100: 19,700 x 768, 30 MB each way in bf16) against
a few FLOPs per element.  The design gives one warp to each row: the row
(768 values, 1.5 KB in bf16) is read three times — sum, centred sum of
squares, normalise — and the second and third reads hit L1, so device
memory sees one pass.  Statistics are fp32, two-pass (mean, then centred
variance), eps inside the rsqrt.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _ln
from vit_tpu_torch.ops.kernels import _build


def layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Plain twin: fp32 two-pass statistics, fp32 affine, cast to x's dtype."""
    return _ln(x, scale, bias, eps).to(x.dtype)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis; any leading shape.  CPU tensors take
    the plain twin; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return layer_norm_plain(x, scale, bias, eps)
    name = "layer_norm"
    _build.check_operands(name, x, scale, bias)
    d = x.shape[-1]
    _build.check_shape(name, "scale", scale, (d,))
    _build.check_shape(name, "bias", bias, (d,))
    rows = x.numel() // d
    out = torch.empty_like(x)
    lib = _build.load_library()
    _build.check(
        lib.vt_layer_norm(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), out.data_ptr(),
            rows, d, eps, _build.DTYPE_CODES[x.dtype], x.device.index,
            _build.stream_of(x),
        ),
        name,
    )
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
