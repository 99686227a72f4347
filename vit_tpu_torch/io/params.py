"""The JAX package's params pytree <-> the port's tensors.

Loading is ``vit_tpu_torch.io.checkpoint`` (``.npz``) or the JAX
package's numpy-only ``load_params_any`` (reference weight directories);
this module only moves the resulting nested dict of arrays onto a torch
device and back.  The layout is kept
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


def params_from_numpy(tree: Mapping[str, Any], device="cpu", dtype=None):
    """Nested dict of numpy arrays -> the same dict of torch tensors on
    ``device``.  Floating leaves are cast to ``dtype`` when given; other
    leaves keep their dtype."""
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out[key] = params_from_numpy(value, device, dtype)
            continue
        t = torch.from_numpy(np.ascontiguousarray(value))
        if dtype is not None and t.is_floating_point():
            t = t.to(dtype)
        out[key] = t.to(device)
    return out


def params_to_numpy(tree: Mapping[str, Any]):
    """Inverse of :func:`params_from_numpy`.  bf16 leaves come back as
    float32 arrays (numpy has no bfloat16; the widening is exact)."""
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
