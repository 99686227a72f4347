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
on CUDA tensors but not ``all_gather``, ``send`` or ``recv`` (and NCCL puts
no two ranks on one card).  So the cyclic shift of the pipeline and of the
sequence ring (``ppermute`` in the JAX package) and the broadcast of one
rank's tensor are each an all-reduce SUM of raw bytes: every rank writes its
tensor's bytes into its slot of a zero-filled buffer, and a sum of bytes
with zeros is the tensor bit for bit (:func:`shift`, :func:`broadcast_from`).
:class:`Shift` is the differentiable shift: its backward shifts the
gradient the other way, the transpose ``shard_map`` gives ``ppermute``.
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


def _sum_bytes(buf: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """All-reduce SUM of ``buf``'s raw bytes over ``axis`` (integer adds: a
    slot that one rank filled and the others left zero comes back bit for
    bit, signed zeros and NaN payloads too)."""
    mesh.all_reduce(buf.view(torch.uint8), axis)
    return buf


def shift(t: torch.Tensor, mesh: Mesh, axis: str, offset: int = 1) -> torch.Tensor:
    """The tensor of the rank ``offset`` places before this one on ``axis``
    (cyclic: rank i's ``t`` lands on rank (i + offset) mod n), bit for bit.
    Every rank of the axis must call it together, with tensors of one shape
    and dtype.  The identity where the axis has one rank."""
    n = mesh.size(axis)
    if n == 1:
        return t
    slots = t.new_zeros((n, *t.shape))
    slots[(mesh.index(axis) + offset) % n] = t
    return _sum_bytes(slots, mesh, axis)[mesh.index(axis)]


def broadcast_from(t: torch.Tensor, mesh: Mesh, axis: str, src: int) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank of ``axis``, bit for bit (the other
    ranks' ``t`` only gives the shape and dtype)."""
    if mesh.size(axis) == 1:
        return t
    buf = t.detach().clone() if mesh.index(axis) == src else torch.zeros_like(t)
    return _sum_bytes(buf.contiguous(), mesh, axis)


class Shift(torch.autograd.Function):
    """:func:`shift` by one place forward; the gradient shifted back by one
    place backward (``ppermute``'s transpose)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return shift(t.contiguous(), mesh, axis, 1)

    @staticmethod
    def backward(ctx, g):
        return shift(g.contiguous(), ctx.mesh, ctx.axis, -1), None, None


class BroadcastFrom(torch.autograd.Function):
    """:func:`broadcast_from` forward; backward, the gradient stays on
    ``src`` alone (zero elsewhere).  Every rank then computes the same
    function of the result, so each rank's gradient of it is already the
    whole one: counted once, on the rank the tensor came from."""

    @staticmethod
    def forward(ctx, t, mesh, axis, src):
        ctx.keep = mesh.index(axis) == src
        return broadcast_from(t, mesh, axis, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.keep else torch.zeros_like(g)), None, None, None
