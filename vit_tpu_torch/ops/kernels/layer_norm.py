"""K3: row LayerNorm, CUDA (``csrc/layer_norm.cu``).

Replaces ``vit_tpu/ops/pallas/ln_kernel.py:layer_norm`` (the Pallas
kernel, pallas_call at :57).  On the ``fused`` and ``quant`` paths it is
the final LayerNorm over all (B, T, D) rows; on ``per_op`` also LN1 and
LN2, and past 1,024 tokens the long block's LN1.

On the H100 this is bound by device memory: one read and one write of the
activation (B/16 batch 100: 19,700 x 768, 30 MB each way in bf16) against
a few FLOPs per element.  One warp per row; statistics are fp32, two-pass
(mean, then centred variance), eps inside the rsqrt; the affine in fp32,
rounded once.  Two kernels, chosen by shape before the launch
(:func:`register_vecs`):

  - bf16 rows up to ``256 * max(REG_VECS)`` wide whose width is a multiple
    of 8, with every operand on the 16-byte grid (the main path's: B/16's
    768, H/14's 1,280): the register row pass.  Each lane holds its share
    of the row in ``vecs`` 16-byte vectors (768 bf16 = 3 per lane, in the
    instance of 4), so the row is read from device memory once with 16-byte
    loads and written with 16-byte stores; the sums run in another order
    than the other kernel's, so the two agree within the tolerance, not bit
    for bit.
  - everything else (fp32, wider rows, a width that is not a multiple of 8,
    a view off the 16-byte grid): the first design, which reads the row
    three times with element loads — sum, centred sum of squares, normalise
    — the second and third reads hitting L1.
"""

from __future__ import annotations

import torch

from vit_tpu_torch.ops.fused_block import _ln
from vit_tpu_torch.ops.kernels import _build

# the register row pass's instances: 16-byte vectors (8 bf16) per lane, so
# rows of up to 256 x vecs values
REG_VECS = (2, 4, 8)


def layer_norm_plain(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """Plain twin: fp32 two-pass statistics, fp32 affine, cast to x's dtype."""
    return _ln(x, scale, bias, eps).to(x.dtype)


def register_vecs(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> int:
    """The kernel these (contiguous) operands take: the register row pass's
    vectors per lane (one of ``REG_VECS``: the least that holds the row),
    or 0 for the two-read row kernel — fp32, a width that is not a multiple
    of 8 or wider than ``256 * max(REG_VECS)``, or an operand whose address
    is off the 16-byte grid (a view with a storage offset)."""
    d = x.shape[-1]
    if x.dtype != torch.bfloat16 or d % 8 or any(
            t.data_ptr() % 16 for t in (x, scale, bias)):
        return 0
    return next((v for v in REG_VECS if d <= 256 * v), 0)


def layer_norm(
    x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-6
) -> torch.Tensor:
    """LayerNorm over the last axis; any leading shape.  CPU tensors take
    the plain twin; CUDA tensors launch the kernel :func:`register_vecs`
    picks."""
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
            rows, d, eps, register_vecs(x, scale, bias), _build.DTYPE_CODES[x.dtype],
            x.device.index, _build.stream_of(x),
        ),
        name,
    )
    layer_norm.launches += 1
    return out


layer_norm.launches = 0
