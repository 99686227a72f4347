"""Op dispatch: the eager reference ops or the hand-written CUDA kernels.

Counterpart of ``vit_tpu.ops.dispatch``: one model parameterized by an op
table.  ``eager`` plays the role of ``xla`` and ``per_op`` that of
``pallas`` (one kernel per layer op); ``fused`` is the per-layer
inference kernel path, ``quant`` its W8A8 twin (int8 QKV and MLP GEMMs)
and ``fused_train`` the differentiable one.  The JAX package's ``qat``
table waits for its slice of the port (ROADMAP.md).
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
    (B*T, D) activation; ``attention`` and ``mlp`` are then unused by the
    forward (``InferenceEngine.phase_report`` reads them) and may be None.
    ``encoder_block_train``, on the ``fused_train`` table only,
    is the regularized block (dropout and drop-path in the kernels) of
    signature ``(x2d, blk, num_heads, seq_len, eps, gelu_variant, seed,
    dropout_p, drop_path_rate) -> x2d``.
    """

    name: str
    layer_norm: Callable
    patch_embed: Callable
    attention: Optional[Callable] = None
    mlp: Optional[Callable] = None
    encoder_block: Optional[Callable] = None
    encoder_block_train: Optional[Callable] = None


EAGER_OPS = OpsImpl(
    name="eager",
    layer_norm=reference.layer_norm,
    patch_embed=reference.patch_embed,
    attention=reference.attention,
    mlp=reference.mlp,
)


def get_ops(impl: str = "eager") -> OpsImpl:
    """Return the op table for ``impl`` in {'eager', 'per_op', 'fused',
    'quant', 'fused_train'}.

    'eager' is the plain PyTorch reference path; 'per_op' is the per-op
    kernel tier (the JAX package's 'pallas': K3 LayerNorms, K21 attention,
    K22 MLP — a debugging surface for isolating a kernel regression against
    the fused paths, with no regularizer hooks); 'fused' runs each encoder
    block as two CUDA kernels and the final LayerNorm as a third; 'quant'
    does the same over int8 QKV and MLP weights (params from
    ``ops/quant.quantize_params``); 'fused_train' runs each block as three
    forward and two backward CUDA kernels under autograd.  The kernel
    modules are imported lazily, so eager use never touches them."""
    if impl == "eager":
        return EAGER_OPS
    tables = {"per_op": "PER_OP_OPS", "fused": "FUSED_OPS", "quant": "QUANT_OPS",
              "fused_train": "TRAINABLE_FUSED_OPS"}
    if impl in tables:
        from vit_tpu_torch.ops import fused

        return getattr(fused, tables[impl])
    raise ValueError(
        f"unknown ops impl {impl!r}; expected 'eager', 'per_op', 'fused', 'quant' or "
        "'fused_train' (the JAX package's 'qat' table is still to be ported — see ROADMAP.md)"
    )
