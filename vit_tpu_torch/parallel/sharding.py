"""Sharding rules for the ViT params tree — counterpart of
``vit_tpu.parallel.sharding``'s ``param_pspecs`` and ``shard_params``, and
of ``vit_tpu.parallel.pipeline``'s ``pp_param_pspecs``.

Megatron-style over heads and the MLP hidden axis (``tp``):

  * wqkv (L, D, 3D) column-parallel on the packed output axis — the
    loader's (head, {q,k,v}, head_dim) column order makes a contiguous block
    of 3D/tp columns whole heads;
  * wo (L, D, D) row-parallel on its input axis (each shard contributes a
    partial out_proj, summed across shards);
  * w1 (L, D, F) column-parallel, w2 (L, F, D) row-parallel;
  * the int8 tree's per-column scales follow their weight's output axis:
    wqkv_scale and w1_scale split, w2_scale whole;
  * LN params, embeddings, the class and distillation tokens and both heads
    whole on every rank.

Pipeline stages (``pp``) split every block leaf on its layer axis, L/pp
layers a stage, composing with the tp rules on the other axes (the
dp x pp x tp placement); the embeddings, the final LayerNorm and the heads
stay whole.  Sequence parallelism (``sp``) splits no leaf: the tokens split.

A rule is a tuple with one entry per axis of the leaf, the mesh axis that
splits it or None (the JAX package's ``PartitionSpec``).  The batch is the
``dp`` axis, split by the forward (``shard_forward.py``); params are whole
over ``dp``.  ZeRO-1 and FSDP (``zero1_pspec``, ``fsdp_param_shardings``)
are still to come (ROADMAP.md item 14).

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

from typing import Any, Iterator

import torch

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
    return out


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


def global_grad_norm(params: Any, mesh: Mesh) -> torch.Tensor:
    """The L2 norm of the whole gradient tree: a split leaf's squares summed
    over the ranks that hold its parts (over each axis that splits it), a
    whole leaf's counted once (every rank holds the same)."""
    by_axes = {}
    for leaf, spec in _pairs(params, param_pspecs(mesh.axis_names, params)):
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
