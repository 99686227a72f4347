"""Op dispatch: the eager reference ops or the hand-written CUDA kernels.

Counterpart of ``vit_tpu.ops.dispatch``: one model parameterized by an op
table.  ``eager`` plays the role of ``xla``; ``fused`` is the per-layer
inference kernel path and ``fused_train`` the differentiable one.  The
other tables of the JAX package (``pallas``, ``quant``, ``qat``) wait for
their slices of the port (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from vit_tpu_torch.ops import reference


@dataclasses.dataclass(frozen=True)
class OpsImpl:
    """The pluggable op table consumed by ``vit_tpu_torch.models.vit``.

    ``encoder_block``, when set, replaces the whole per-layer composition
    with a fused implementation of signature
    ``(x2d, blk, num_heads, seq_len, eps, gelu_variant) -> x2d`` on a flat
    (B*T, D) activation; ``attention`` and ``mlp`` are then unused and may
    be None.  The JAX table's ``encoder_block_train`` (the regularized
    block: dropout, drop-path) comes with the slice that ports its kernels.
    """

    name: str
    layer_norm: Callable
    patch_embed: Callable
    attention: Optional[Callable] = None
    mlp: Optional[Callable] = None
    encoder_block: Optional[Callable] = None


EAGER_OPS = OpsImpl(
    name="eager",
    layer_norm=reference.layer_norm,
    patch_embed=reference.patch_embed,
    attention=reference.attention,
    mlp=reference.mlp,
)


def get_ops(impl: str = "eager") -> OpsImpl:
    """Return the op table for ``impl`` in {'eager', 'fused', 'fused_train'}.

    'eager' is the plain PyTorch reference path; 'fused' runs each encoder
    block as two CUDA kernels and the final LayerNorm as a third;
    'fused_train' runs each block as three forward and two backward CUDA
    kernels under autograd.  The kernel modules are imported lazily, so
    eager use never touches them."""
    if impl == "eager":
        return EAGER_OPS
    if impl in ("fused", "fused_train"):
        from vit_tpu_torch.ops import fused

        return fused.FUSED_OPS if impl == "fused" else fused.TRAINABLE_FUSED_OPS
    raise ValueError(
        f"unknown ops impl {impl!r}; expected 'eager', 'fused' or 'fused_train' (the JAX "
        "package's other op tables are still to be ported — see ROADMAP.md)"
    )
