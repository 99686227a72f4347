"""The JAX package's params pytree <-> the port's tensors.

Loading is ``vit_tpu_torch.io.load_any`` (reference weight directories,
``.npz``, ``.pth``); this module only moves the resulting nested dict of
arrays onto a torch device (the card unless the caller asks for the CPU)
and back.  The layout is kept
exactly: [in, out] matrices, the encoder layers stacked on a leading L
axis, and the packed QKV in (head, {q,k,v}, head_dim) column order.
Nothing is transposed to ``nn.Linear``'s [out, in] layout: a square
``wo`` in that layout passes every shape check and computes wrong
attention.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from vit_tpu_torch.ops.quant import _QUANT_SCALE_KEYS


def device_or_raise(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises — nothing runs on the CPU instead."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r}: torch.cuda.is_available() is False (no NVIDIA "
            "card or a CPU-only PyTorch); pass device='cpu' to run on the CPU"
        )
    return dev


def params_from_numpy(tree: Mapping[str, Any], device="cuda", dtype=None):
    """Nested dict of numpy arrays -> the same dict of torch tensors on
    ``device``.  Floating leaves are cast to ``dtype`` when given; other
    leaves keep their dtype, and so do a quantized tree's fp32 scales
    (``wqkv_scale``, ``w1_scale``, ``w2_scale``, by name as in
    ``ops/quant.cast_quantized_params``; int8 weights stay int8)."""
    device = device_or_raise(device)
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = params_from_numpy(value, device, dtype)
            continue
        t = torch.from_numpy(np.ascontiguousarray(value))
        if dtype is not None and t.is_floating_point() and key not in _QUANT_SCALE_KEYS:
            t = t.to(dtype)
        out[key] = t.to(device)
    return out


def params_to_numpy(tree: Mapping[str, Any]):
    """Inverse of :func:`params_from_numpy`.  bf16 leaves come back as
    float32 arrays (numpy has no bfloat16; the widening is exact); int8
    leaves as int8."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = params_to_numpy(value)
            continue
        t = value.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        out[key] = t.numpy()
    return out
