"""Params checkpoints — counterpart of ``vit_tpu.io.checkpoint``'s ``.npz``
routes: one ``.npz`` whose keys are the tree paths joined by ``/``
(``blocks/wqkv``), so either package reads the other's files.  Train-state
archives (``--save-state``: params under ``params.<path>`` beside the
optimizer and ``__step__``) are read for their params only."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np


def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            out.update(_flatten(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten(flat: Dict[str, Any]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def save_npz(tree: Dict[str, Any], path) -> None:
    """Save a nested dict of numpy arrays to exactly ``path`` (np.savez
    given a name would append '.npz' to a suffixless one)."""
    with open(path, "wb") as fh:
        np.savez(fh, **{k: np.asarray(v) for k, v in _flatten(tree).items()})


def load_npz(path) -> Dict[str, Any]:
    with np.load(path) as z:
        return _unflatten({k: z[k] for k in z.files})


def is_train_state(path) -> bool:
    with np.load(path) as z:
        return "__step__" in z.files


def load_params_from_state(path) -> Dict[str, Any]:
    with np.load(path) as z:
        return _unflatten({k[len("params."):]: z[k] for k in z.files if k.startswith("params.")})
