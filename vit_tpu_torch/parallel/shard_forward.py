"""Data-parallel inference: every rank runs the single-card forward on its
slice of the batch — counterpart of ``vit_tpu.parallel.shard_forward``.

The batch (whole on every rank, padded to a multiple of ``dp`` by the
engine) splits over the mesh's ``dp`` axis; the weights are whole over it.
The slices' outputs join on every rank through one all-reduce SUM over a
zero-filled (B, C) buffer into which each rank writes its own rows: a sum
with zeros is exact, and an all-reduce is what gloo runs on CUDA tensors
(it has no ``all_gather`` there).
"""

from __future__ import annotations

from typing import Callable

import torch

from vit_tpu_torch.parallel.mesh import Mesh


def shard_forward_dp(forward: Callable, mesh: Mesh, batch_axis: int = 0) -> Callable:
    """Wrap ``forward(params, images)``, whose output holds the batch on
    ``batch_axis``, to run on this rank's slice of the batch over ``dp`` and
    return the whole batch's output.  A mesh without a ``dp`` axis (or of
    one rank on it) runs ``forward`` on the whole batch."""
    dp = mesh.size("dp")
    if dp == 1:
        return forward

    def fn(params, images):
        n = images.shape[0]
        if n % dp:
            raise ValueError(f"batch {n} does not split over dp={dp}")
        step = n // dp
        lo = mesh.index("dp") * step
        part = forward(params, images[lo:lo + step])
        shape = list(part.shape)
        shape[batch_axis] = n
        out = part.new_zeros(shape)
        out.narrow(batch_axis, lo, step).copy_(part)
        return mesh.all_reduce(out, "dp")

    return fn
