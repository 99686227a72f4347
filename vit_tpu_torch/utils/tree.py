"""Nested-dict tree helpers — counterpart of ``vit_tpu.utils.tree``.

``flatten_tree`` walks dict keys in sorted order, the order ``jax.tree``
gives a dict's leaves: every file name and every optimizer leaf index the
port writes takes its order from here, never from a dict's insertion order
(``runtime/trainer.leaves``)."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def flatten_tree(tree: Any, prefix: str = "", sep: str = "/") -> Dict[str, Any]:
    """Nested dicts -> {'a/b/c': leaf}, keys sorted; leaves pass through
    unchanged."""
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in sorted(tree.items()):
            out.update(flatten_tree(v, f"{prefix}{k}{sep}", sep))
    else:
        out[prefix[: -len(sep)]] = tree
    return out


def unflatten_tree(flat: Dict[str, Any], sep: str = "/") -> Any:
    """Inverse of :func:`flatten_tree`."""
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def cast_tree(tree: Any, dtype) -> Any:
    """Cast every leaf of a nested-dict tree to ``dtype``: a torch dtype
    for tensors, a numpy one for arrays; a torch dtype makes an array a CPU
    tensor."""
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype)
    if isinstance(dtype, torch.dtype):
        return torch.from_numpy(np.asarray(tree)).to(dtype)
    return np.asarray(tree).astype(dtype)

