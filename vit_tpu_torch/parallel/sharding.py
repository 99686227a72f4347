"""Sharding rules for the ViT params tree — counterpart of
``vit_tpu.parallel.sharding`` (``param_pspecs``, ``shard_params``,
``zero1_pspec``, ``fsdp_param_shardings``) and of
``vit_tpu.parallel.pipeline``'s ``pp_param_pspecs``.

Megatron-style over heads and the MLP hidden axis (``tp``):

  * wqkv (L, D, 3D) column-parallel on the packed output axis — the
    loader's (head, {q,k,v}, head_dim) column order makes a contiguous block
    of 3D/tp columns whole heads;
  * wo (L, D, D) row-parallel on its input axis (each shard contributes a
    partial out_proj, summed across shards);
  * w1 (L, D, F) column-parallel, w2 (L, F, D) row-parallel;
  * the int8 tree's per-column scales follow their weight's output axis:
    wqkv_scale and w1_scale split, w2_scale whole;
  * LN params, embeddings, the class and distillation tokens, both heads
    and MAE's decoder whole on every rank.

Pipeline stages (``pp``) split every block leaf on its layer axis, L/pp
layers a stage, composing with the tp rules on the other axes (the
dp x pp x tp placement); the embeddings, the final LayerNorm and the heads
stay whole.  Sequence parallelism (``sp``) splits no leaf: the tokens split.

A rule is a tuple with one entry per axis of the leaf, the mesh axis that
splits it or None (the JAX package's ``PartitionSpec``).  The batch is the
``dp`` axis, split by the forward (``shard_forward.py``); params are whole
over ``dp``, except under ZeRO:

  * ``zero1_pspec`` extends a rule with ``dp`` on the leaf's largest axis
    that the rule leaves free and that ``dp`` divides (none: unchanged), and
    ``fsdp_param_shardings`` applies it to every leaf.  The axis is chosen
    among the free axes only, whose lengths a tp shard shares with the whole
    leaf, so a rank's tp shard gets the whole leaf's rule.
  * :class:`DpShards` moves a tree between those rules: ``slice`` (each
    leaf's dp slice), ``gather`` (the slices joined again, bit for bit:
    byte-sums over zero-filled slots), ``view`` (the differentiable gather
    of a forward: every leaf but the stacked blocks' gathered at once, each
    block's leaves when the block reads them, their gradients
    reduce-scattered) and ``shard``/``unshard`` (with the tp rules too).
    ZeRO-1 (``runtime/trainer.Zero1``) slices the optimizer's leaves;
    FSDP slices the params themselves.

Training over shards (``runtime/trainer.py``): each rank's optimizer
updates its own shards.  A rank holds some gradients in part and
:func:`sum_partial_grads` sums them over the axis that split the work:
``TP_PARTIAL_GRADS`` over ``tp``, the embeddings over ``pp`` (stage 0
alone computes them), every leaf but the heads over ``sp`` (each rank's
tokens).  The global gradient norm sums a split leaf's squares over the
axes that split it and counts a whole leaf's once (``global_grad_norm``),
which ``optax.clip_by_global_norm`` sees on global arrays in the JAX
package; ``unshard_params`` gathers the whole tree.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Iterator

import torch

from vit_tpu_torch.models.vit import LayeredBlocks
from vit_tpu_torch.parallel.mesh import Mesh

# the block leaves whose gradients a tp rank holds in part: LN1 and LN2 sit
# before the column-parallel kernels, whose VJPs (K6, K8, or the long
# block's plain LN1 + QKV) differentiate only this rank's heads or hidden
# columns
TP_PARTIAL_GRADS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")
# the leaves that only pipeline stage 0 differentiates (the embeddings feed
# the first stage alone), and the leaves every sequence shard differentiates
# in whole (the heads read the prefix rows broadcast to every shard)
PP_PARTIAL_GRADS = ("cls_token", "dist_token", "patch_embed", "pos_embed")
SP_WHOLE_GRADS = ("head", "head_dist")


def _pspec(axis_names, *spec) -> tuple:
    # drop axis names the mesh doesn't have (the same rules serve dp-only
    # or tp-only meshes)
    return tuple(s if s in axis_names else None for s in spec)


def param_pspecs(axis_names, params: Any) -> Any:
    """The rule tree matching ``params`` (the fp tree or the quantized one,
    whose int8 weights carry ``*_scale`` companions)."""
    rep1 = _pspec(axis_names)  # whole on every rank

    # the layer axis splits over the pipeline stages where the mesh has them
    block_rules = {
        "ln1_scale": _pspec(axis_names, "pp", None),
        "ln1_bias": _pspec(axis_names, "pp", None),
        "wqkv": _pspec(axis_names, "pp", None, "tp"),   # column-parallel QKV
        "bqkv": _pspec(axis_names, "pp", "tp"),
        "wo": _pspec(axis_names, "pp", "tp", None),     # row-parallel out_proj
        "bo": _pspec(axis_names, "pp", None),
        "ln2_scale": _pspec(axis_names, "pp", None),
        "ln2_bias": _pspec(axis_names, "pp", None),
        "w1": _pspec(axis_names, "pp", None, "tp"),     # column-parallel MLP in
        "b1": _pspec(axis_names, "pp", "tp"),
        "w2": _pspec(axis_names, "pp", "tp", None),     # row-parallel MLP out
        "b2": _pspec(axis_names, "pp", None),
        # quantization scales (present only on the quantized tree)
        "wqkv_scale": _pspec(axis_names, "pp", "tp"),
        "w1_scale": _pspec(axis_names, "pp", "tp"),
        "w2_scale": _pspec(axis_names, "pp", None),
    }
    present = {k: v for k, v in block_rules.items() if k in params.get("blocks", {})}
    out = {
        "cls_token": rep1,
        "patch_embed": {"kernel": rep1, "bias": rep1},
        "pos_embed": rep1,
        "blocks": present,
        "ln_final": {"scale": rep1, "bias": rep1},
    }
    if "head" in params:
        out["head"] = {"kernel": rep1, "bias": rep1}
    if "dist_token" in params:  # DeiT: whole, like CLS and the head
        out["dist_token"] = rep1
        out["head_dist"] = {"kernel": rep1, "bias": rep1}
    if "decoder" in params:  # MAE's decoder: small and pretraining-only, whole
        out["decoder"] = _map_leaves(lambda _: rep1, params["decoder"])
    return out


def _map_leaves(fn, tree):
    return {k: _map_leaves(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


def zero1_pspec(spec: tuple, shape, axis_names, dp_size: int) -> tuple:
    """``spec`` extended with ``'dp'`` on the largest axis of ``shape``
    that it leaves free and that ``dp_size`` divides (the first of equals),
    padded with None to the leaf's rank: the ZeRO-1 rule (Rajbhandari et
    al. 2019 §5.1).  Unchanged without a ``dp`` axis, at ``dp_size`` 1, or
    where no free axis divides."""
    if "dp" not in axis_names or dp_size <= 1:
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    best, best_n = -1, 0
    for i, (s, n) in enumerate(zip(entries, shape)):
        if s is None and n % dp_size == 0 and n > best_n:
            best, best_n = i, n
    if best < 0:
        return spec
    entries[best] = "dp"
    return tuple(entries)


def fsdp_param_shardings(mesh: Mesh, params: Any) -> Any:
    """The rule tree of fully-sharded data parallelism (ZeRO-3): every
    leaf's :func:`param_pspecs` rule extended by :func:`zero1_pspec`, so
    params, gradients and optimizer state all split over ``dp``.  A leaf
    with no free axis that dp divides keeps its base rule.  ``params`` may
    be the whole tree or a rank's tp shard of it (the same rules)."""
    dp = mesh.size("dp")
    specs = param_pspecs(mesh.axis_names, params)

    def rec(tree, spec):
        return {k: rec(v, spec[k]) if isinstance(v, dict)
                else zero1_pspec(spec[k], tuple(v.shape), mesh.axis_names, dp)
                for k, v in tree.items()}

    return rec(params, specs)


def pp_param_pspecs(params: Any, axis_names=("pp",)) -> Any:
    """The rules with the block stack split over ``pp`` on its layer axis,
    composed with the tp rules when ``axis_names`` has ``tp`` (the JAX
    package's signature; :func:`param_pspecs` itself places ``pp``)."""
    return param_pspecs(axis_names, params)


def splits_params(mesh) -> bool:
    """Whether a rank on ``mesh`` holds a part of the tree (tp or pp over
    more than one rank), so that what leaves the step whole is gathered."""
    return mesh is not None and (mesh.size("tp") > 1 or mesh.size("pp") > 1)


def _local(leaf: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is None:
            continue
        n, k = mesh.size(axis), mesh.index(axis)
        if leaf.shape[dim] % n:
            raise ValueError(f"axis {dim} of a {tuple(leaf.shape)} leaf does not split "
                             f"over {axis}={n}")
        step = leaf.shape[dim] // n
        leaf = leaf.narrow(dim, k * step, step)
    return leaf.contiguous()


def shard_params(params: Any, mesh: Mesh) -> Any:
    """This rank's part of ``params``: every leaf cut along the axes of its
    rule at this rank's coordinates (a contiguous copy; a leaf its rule
    keeps whole is the same tensor)."""
    specs = param_pspecs(mesh.axis_names, params)

    def rec(tree, spec):
        return {k: rec(v, spec[k]) if isinstance(v, dict) else _local(v, spec[k], mesh)
                for k, v in tree.items()}

    return rec(params, specs)


def _pairs(tree: Any, spec: Any) -> Iterator[tuple]:
    """(leaf, rule) over a params tree and its rule tree, in the tree's order."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _pairs(v, spec[k])
        else:
            yield v, spec[k]


def _whole(leaf: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is None or mesh.size(axis) == 1:
            continue
        step = leaf.shape[dim]
        shape = list(leaf.shape)
        shape[dim] = step * mesh.size(axis)
        # each rank writes its shard into zeros; the SUM is exact, and an
        # all-reduce is what gloo runs on CUDA tensors (no all_gather)
        out = leaf.new_zeros(shape)
        out.narrow(dim, mesh.index(axis) * step, step).copy_(leaf)
        leaf = mesh.all_reduce(out, axis)
    return leaf


def unshard_params(params: Any, mesh: Mesh) -> Any:
    """The whole tree, on every rank, from each rank's part (the inverse of
    :func:`shard_params`; detached).  Every rank must call it: the split
    leaves meet in all-reduces."""
    specs = param_pspecs(mesh.axis_names, params)

    def rec(tree, spec):
        return {k: rec(v, spec[k]) if isinstance(v, dict) else _whole(v.detach(), spec[k], mesh)
                for k, v in tree.items()}

    return rec(params, specs)


def _sum_grads(leaves, mesh: Mesh, axis: str) -> None:
    """Sum the leaves' gradients over ``axis`` in place, in one all-reduce; a
    leaf this rank did not differentiate adds zeros and takes the sum."""
    for t in leaves:
        if t.grad is None:
            t.grad = torch.zeros_like(t)
    grads = [t.grad for t in leaves]
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), axis)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _subtree_leaves(params: Any, keys) -> list:
    out = []
    for k in keys:
        v = params.get(k)
        out += [] if v is None else list(v.values()) if isinstance(v, dict) else [v]
    return out


def sum_partial_grads(params: Any, mesh: Mesh) -> None:
    """Sum the gradients a rank holds in part over the axis that split the
    work, in place, one all-reduce an axis: ``TP_PARTIAL_GRADS`` over
    ``tp``; ``PP_PARTIAL_GRADS`` over ``pp``; every leaf but
    ``SP_WHOLE_GRADS`` over ``sp``.  A no-op over an axis of one rank."""
    if mesh.size("tp") > 1:
        _sum_grads(_subtree_leaves(params["blocks"], TP_PARTIAL_GRADS), mesh, "tp")
    if mesh.size("pp") > 1:
        _sum_grads(_subtree_leaves(params, PP_PARTIAL_GRADS), mesh, "pp")
    if mesh.size("sp") > 1:
        _sum_grads(_subtree_leaves(params, [k for k in params if k not in SP_WHOLE_GRADS]),
                   mesh, "sp")


def global_grad_norm(params: Any, mesh: Mesh, specs: Any = None) -> torch.Tensor:
    """The L2 norm of the whole gradient tree: a split leaf's squares summed
    over the ranks that hold its parts (over each axis that splits it), a
    whole leaf's counted once (every rank holds the same).  ``specs``: the
    rule tree the leaves follow (default :func:`param_pspecs`')."""
    if specs is None:
        specs = param_pspecs(mesh.axis_names, params)
    by_axes = {}
    for leaf, spec in _pairs(params, specs):
        if leaf.grad is not None:
            axes = tuple(a for a in spec if a is not None and mesh.size(a) > 1)
            by_axes.setdefault(axes, []).append(leaf.grad.float().pow(2).sum().reshape(1))
    total = None
    for axes in sorted(by_axes):
        part = torch.cat(by_axes[axes]).sum().reshape(1)
        for axis in axes:
            part = mesh.all_reduce(part, axis)
        total = part[0] if total is None else total + part[0]
    return torch.sqrt(total)


def _dp_axis(spec: tuple) -> int:
    """The leaf axis a ZeRO rule splits over ``dp``, or -1."""
    return spec.index("dp") if "dp" in spec else -1


def dp_slice(leaf: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """This rank's ``dp`` slice of ``leaf`` under ``spec`` (contiguous; the
    same tensor where the rule has no ``dp``).  The rule's other axes are
    left as they are: ``leaf`` is whole over them, or already this rank's
    tp shard."""
    dim = _dp_axis(spec)
    if dim < 0:
        return leaf
    return _local(leaf, tuple("dp" if i == dim else None for i in range(leaf.dim())), mesh)


def dp_view(leaf: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """:func:`dp_slice` as a view of ``leaf``'s storage (not contiguous
    where the rule's dp axis is not the leading one)."""
    dim = _dp_axis(spec)
    if dim < 0:
        return leaf
    step = leaf.shape[dim] // mesh.size("dp")
    return leaf.narrow(dim, mesh.index("dp") * step, step)


def dp_gather(part: torch.Tensor, spec: tuple, mesh: Mesh) -> torch.Tensor:
    """The inverse of :func:`dp_slice`, bit for bit, on every rank (a
    collective; detached)."""
    from vit_tpu_torch.parallel.mesh import all_gather

    dim = _dp_axis(spec)
    return part.detach() if dim < 0 else all_gather(part.detach(), mesh, "dp", dim)


class DpShards:
    """The ZeRO rules of a params tree on ``mesh`` (``fsdp_param_shardings``
    of ``params``, the whole tree or this rank's tp shard) and the moves
    between them; see the module docstring."""

    def __init__(self, params: Any, mesh: Mesh):
        self.mesh = mesh
        self.specs = fsdp_param_shardings(mesh, params)

    def _map(self, fn, tree, specs=None):
        specs = self.specs if specs is None else specs
        return {k: self._map(fn, v, specs[k]) if isinstance(v, dict) else fn(v, specs[k])
                for k, v in tree.items()}

    def slice(self, tree: Any) -> Any:
        """Each leaf's dp slice (``tree`` in the rules' shape, its leaves
        whole over dp)."""
        return self._map(lambda v, s: dp_slice(v, s, self.mesh), tree)

    def gather(self, tree: Any) -> Any:
        """The dp slices joined again (detached; every rank must call it)."""
        return self._map(lambda v, s: dp_gather(v, s, self.mesh), tree)

    def shard(self, whole: Any) -> Any:
        """This rank's part of a whole tree: its tp shard, then its dp slice."""
        if splits_params(self.mesh):
            whole = shard_params(whole, self.mesh)
        return self.slice(whole)

    def unshard(self, tree: Any) -> Any:
        """The whole tree from every rank's part (the inverse of
        :meth:`shard`; a collective, detached)."""
        tree = self.gather(tree)
        return unshard_params(tree, self.mesh) if splits_params(self.mesh) else tree

    def sliced(self, spec: tuple) -> bool:
        return _dp_axis(spec) >= 0

    def view(self, tree: Any, dtype=None) -> Any:
        """The tree a forward reads, gathered over ``dp`` through
        ``mesh.GatherSlot`` (gradients reduce-scattered back, summed over
        dp): every leaf at once, but a ``blocks`` subtree's a layer at a time
        when the layer reads it (a ``models/vit.LayeredBlocks``, which
        ``models/vit.layers`` asks for its layers).  Floating leaves are
        cast to ``dtype`` after the gather."""
        def rec(sub, specs):
            out = {}
            for k, v in sub.items():
                if k == "blocks":
                    out[k] = _GatheredBlocks(v, specs[k], self.mesh, dtype)
                elif isinstance(v, dict):
                    out[k] = rec(v, specs[k])
                else:
                    out[k] = _cast(_gather_piece(v, specs[k], self.mesh), dtype)
            return out

        return rec(tree, self.specs)


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    return t.to(dtype) if dtype is not None and t.is_floating_point() else t


def _gather_piece(piece: torch.Tensor, spec: tuple, mesh: Mesh, dim: int = None,
                  full: int = None, offset: int = None) -> torch.Tensor:
    """``piece`` gathered over ``dp`` on its rule's dp axis (differentiable);
    ``dim``/``full``/``offset`` override the axis, whole length and this
    rank's offset (a stacked leaf's layer)."""
    from vit_tpu_torch.parallel.mesh import GatherSlot

    if dim is None:
        dim = _dp_axis(spec)
        if dim < 0:
            return piece
        step = piece.shape[dim]
        full, offset = step * mesh.size("dp"), mesh.index("dp") * step
    return GatherSlot.apply(piece, mesh, "dp", dim, full, offset)


class _GatheredBlocks(LayeredBlocks):
    """A stacked ``blocks`` subtree of dp slices that hands out its layers
    (``layers()``), each a mapping that gathers a leaf's layer when the
    block reads it (no cache: what a block gathered is freed with the
    block, or kept by autograd for the backward)."""

    def __init__(self, blocks, specs, mesh: Mesh, dtype):
        self.blocks, self.specs, self.mesh, self.dtype = blocks, specs, mesh, dtype

    def layers(self) -> list:
        dp, k = self.mesh.size("dp"), self.mesh.index("dp")
        pieces = {}
        for key, leaf in self.blocks.items():
            spec = self.specs[key]
            if _dp_axis(spec) == 0:
                # the layer axis split over dp: layer l lives whole on one rank
                per = leaf.shape[0]
                depth = per * dp
                rows = leaf.unbind(0)
                empty = leaf.narrow(0, 0, 0)
                pieces[key] = [(rows[l - k * per].unsqueeze(0) if l // per == k else empty, True)
                               for l in range(depth)]
            else:
                depth = leaf.shape[0]
                pieces[key] = [(row, False) for row in leaf.unbind(0)]
        return [_GatheredLayer(self, {key: p[l] for key, p in pieces.items()})
                for l in range(depth)]


class _GatheredLayer(Mapping):
    """One layer of :class:`_GatheredBlocks`: ``blk[key]`` gathers that
    leaf's layer over ``dp`` (differentiable) each time it is read."""

    def __init__(self, owner: _GatheredBlocks, pieces: dict):
        self.owner, self.pieces = owner, pieces

    def __iter__(self):
        return iter(self.pieces)

    def __len__(self):
        return len(self.pieces)

    def __getitem__(self, key):
        piece, one_rank = self.pieces[key]
        own = self.owner
        if one_rank:  # the layer axis split over dp: its one rank's piece, or nothing
            out = _gather_piece(piece, None, own.mesh, 0, 1, 0)[0]
        else:  # the stacked leaf's rule without its layer axis
            out = _gather_piece(piece, own.specs[key][1:], own.mesh)
        return _cast(out, own.dtype)
