"""The classify CLI's mesh preamble — counterpart of ``vit_tpu.cli.common``'s
``resolve_mesh``.

``--tp``/``--dp`` (and the train CLI's ``--pp``/``--sp``) run the CLI SPMD
under ``torchrun --nproc-per-node N``: one process per rank, each joining
the process group (``runtime/distributed.py``), building its
:class:`~vit_tpu_torch.parallel.mesh.Mesh` and doing its shard of the work.
``--multihost`` (the serve and train CLIs) joins the ranks from explicit
coordinator flags, or from ``torchrun``'s environment, into one dp mesh
over the world (:func:`resolve_multihost`).
"""

from __future__ import annotations

import math
import os
import sys

import torch


class MeshError(ValueError):
    """A mesh the flags ask for cannot be built here (the CLI exits 2)."""


def _train_shape(world: int, dp, tp: int, pp: int, sp: int) -> dict:
    """The train CLI's ``{dp, sp}`` (``{sp}`` at dp 1) or ``{dp, pp[, tp]}``
    mesh, the JAX package's, unset --dp filling the world."""
    if sp > 1:
        dp = dp or max(world // sp, 1)
        return {"dp": dp, "sp": sp} if dp > 1 else {"sp": sp}
    dp = dp or max(world // (pp * tp), 1)
    return {"dp": dp, "pp": pp, **({"tp": tp} if tp > 1 else {})}


def resolve_mesh(dp, tp: int, device: str = "cuda", backend=None, out=None, pp: int = 1,
                 sp: int = 1):
    """--dp/--tp (--pp/--sp) flags -> (this rank's Mesh, its device), or
    (None, device) for the single-device default.

    The ranks come from ``torchrun``'s environment and must be exactly
    dp x tp (unset --dp: the world size over tp), dp x pp x tp or dp x sp;
    otherwise :class:`MeshError`.  On the card each rank takes card LOCAL_RANK
    modulo the cards of its host — its own card under NCCL, or one card
    shared by every rank under gloo.  Rank 0 prints the mesh and the
    backend."""
    if not (tp > 1 or dp or pp > 1 or sp > 1):
        return None, device
    flags = f"--tp {tp}/--dp {dp}" + (f"/--pp {pp}" if pp > 1 else "") + (
        f"/--sp {sp}" if sp > 1 else "")
    if "WORLD_SIZE" not in os.environ or "MASTER_ADDR" not in os.environ:
        raise MeshError(
            f"{flags} need one process per rank: run the CLI under "
            "`torchrun --nproc-per-node N` (no torchrun world found)"
        )
    from vit_tpu_torch.parallel import make_mesh, mesh_shape_for
    from vit_tpu_torch.runtime import distributed

    world = int(os.environ["WORLD_SIZE"])
    try:
        if pp > 1 or sp > 1:
            shape = _train_shape(world, dp, tp, pp, sp)
            need = math.prod(shape.values())
            if need != world:
                raise ValueError(f"mesh {shape} needs {need} ranks, have {world}")
        else:
            shape = mesh_shape_for(world, tp=tp, dp=dp)
    except ValueError as e:
        raise MeshError(f"{flags} over a torchrun world of {world}: {e}") from e
    device = _rank_device(device, distributed.local_rank())
    chosen = distributed.initialize(backend=backend, device_type=torch.device(device).type)
    mesh = make_mesh(shape)
    if mesh.rank == 0:
        print(f"mesh: {shape} over {world} rank(s), backend {chosen}",
              file=out if out is not None else sys.stdout)
    return mesh, device


def _rank_device(device: str, index: int) -> str:
    """On the card: card ``index`` modulo the cards of this host, made the
    current device (its own card under NCCL, one shared under gloo)."""
    if device == "cuda" and torch.cuda.is_available():
        device = f"cuda:{index % torch.cuda.device_count()}"
        torch.cuda.set_device(device)
    return device


def resolve_multihost(coordinator=None, num_processes=None, process_id=None,
                      device: str = "cuda", backend=None):
    """--multihost -> (this rank's Mesh of one 'dp' axis over the world,
    its device): the process group from ``coordinator`` ('host:port'),
    ``num_processes`` and ``process_id``, or from ``torchrun``'s environment
    when they are omitted (one process without either).  On the card each
    process takes card LOCAL_RANK (else its process id) modulo the cards of
    its host."""
    from vit_tpu_torch.parallel import make_mesh
    from vit_tpu_torch.runtime import distributed

    index = (distributed.local_rank() if "LOCAL_RANK" in os.environ or process_id is None
             else process_id)
    device = _rank_device(device, index)
    distributed.initialize(coordinator_address=coordinator, num_processes=num_processes,
                           process_id=process_id, backend=backend,
                           device_type=torch.device(device).type)
    from vit_tpu_torch.parallel.mesh import world

    return make_mesh({"dp": world()[1]}), device
