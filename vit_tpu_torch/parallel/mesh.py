"""A rank mesh with named axes over ``torch.distributed`` — counterpart of
``vit_tpu.parallel.mesh``.

The JAX package's ``Mesh`` lays devices out on named axes for one
controller; here every rank is its own process (SPMD, one per card, as
``torchrun`` starts them), so a :class:`Mesh` is this rank's view: the axis
sizes, its coordinates on them, and one process group per axis holding the
ranks that differ from it along that axis only.  Ranks are laid out in the
axes' order, the last axis fastest (``numpy``'s ``reshape`` of the device
list in the JAX package), so with ``{'dp': 2, 'tp': 2}`` ranks 0-1 form a
tp group and ranks 0 and 2 a dp group.

Collectives here are ``all_reduce`` (SUM, MAX) and ``broadcast`` only:
gloo, the backend of the CPU and of ranks that share one card, runs those
on CUDA tensors but not ``all_gather``.
"""

from __future__ import annotations

import itertools
from typing import Dict, Optional

import torch
import torch.distributed as dist


class Mesh:
    """This rank's place on a mesh of named axes (see the module docstring).

    ``shape`` maps axis name to size; ``coords`` this rank's index on each
    axis; ``groups`` each axis's process group for this rank (None where the
    axis has one rank: nothing to communicate)."""

    def __init__(self, shape: Dict[str, int], rank: int, groups: Dict[str, Optional[object]]):
        self.shape = dict(shape)
        self.rank = rank
        self.axis_names = tuple(shape)
        sizes = [shape[a] for a in self.axis_names]
        idx = list(itertools.product(*(range(n) for n in sizes)))[rank] if sizes else ()
        self.coords = dict(zip(self.axis_names, idx))
        self.groups = dict(groups)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return self.coords.get(axis, 0)

    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over ``axis`` in place (SUM or MAX), returned; a
        no-op where the axis has one rank."""
        group = self.groups.get(axis)
        if group is not None:
            dist.all_reduce(t, op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM,
                            group=group)
        return t


def world() -> tuple:
    """(rank, world size) of this process: (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_mesh(axes: Dict[str, int]) -> Mesh:
    """This rank's :class:`Mesh` with named axes, e.g. ``make_mesh({'dp': 4,
    'tp': 2})``.  Axis order follows dict order; sizes must multiply to the
    world size (the ranks of ``torch.distributed``, or one process without
    a process group).  Every rank must call it, in the same order: the axis
    groups are made collectively."""
    rank, n_ranks = world()
    names = tuple(axes)
    sizes = [axes[a] for a in names]
    n = 1
    for s in sizes:
        n *= s
    if n != n_ranks:
        raise ValueError(f"mesh {dict(axes)} needs {n} ranks, have {n_ranks}")
    groups = {}
    grid = list(itertools.product(*(range(s) for s in sizes)))
    for i, axis in enumerate(names):
        groups[axis] = None
        if sizes[i] == 1:
            continue
        # one group per line along the axis, each made by every rank
        others = sorted({c[:i] + c[i + 1:] for c in grid})
        for rest in others:
            ranks = [grid.index(rest[:i] + (k,) + rest[i:]) for k in range(sizes[i])]
            group = dist.new_group(ranks)
            if rank in ranks:
                groups[axis] = group
    return Mesh(dict(axes), rank, groups)


def mesh_shape_for(
    n_devices: int, tp: int = 1, dp: Optional[int] = None
) -> Dict[str, int]:
    """Pick a {'dp', 'tp'} factorization of ``n_devices``."""
    if n_devices % tp:
        raise ValueError(f"tp={tp} does not divide {n_devices} devices")
    if dp is None:
        dp = n_devices // tp
    if dp < 1 or tp < 1:
        # 0 % tp == 0 and 0*tp == 0, so without this gate tp > n_devices
        # builds an empty {'dp': 0} mesh that fails much later with an
        # inscrutable sharding error
        raise ValueError(
            f"dp={dp}, tp={tp} over {n_devices} device(s): every mesh "
            "axis needs >= 1 (is --tp larger than the device count?)"
        )
    if dp * tp != n_devices:
        raise ValueError(f"dp*tp = {dp * tp} != {n_devices}")
    return {"dp": dp, "tp": tp}
