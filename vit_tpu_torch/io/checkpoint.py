"""Params and train-state checkpoints — counterpart of
``vit_tpu.io.checkpoint``'s ``.npz`` routes.  Either package reads the
other's files:

- a params ``.npz``: one key per leaf, the tree path joined by ``/``
  (``blocks/wqkv``);
- a train-state archive (``--save-state``): ``__step__`` (int64), the
  params under ``params.<path>``, and the optimizer state as ``opt.<i>``,
  its leaves in optax's order (``runtime/trainer.opt_state_leaves`` lays a
  torch optimizer out so).

Paths are sorted (``utils/tree.flatten_tree``), as ``jax.tree`` orders a
dict's leaves."""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from vit_tpu_torch.utils import flatten_tree, unflatten_tree


def _savez_exact(path, **arrays) -> None:
    """np.savez to exactly ``path`` (given a name, np.savez appends '.npz'
    to a suffixless one: '--save-state ckpt' would write 'ckpt.npz')."""
    with open(path, "wb") as fh:
        np.savez(fh, **arrays)


def save_npz(tree: Dict[str, Any], path) -> None:
    """Save a nested dict of numpy arrays to exactly ``path``."""
    _savez_exact(path, **{k: np.asarray(v) for k, v in flatten_tree(tree).items()})


def load_npz(path) -> Dict[str, Any]:
    with np.load(path) as z:
        return unflatten_tree({k: z[k] for k in z.files})


def save_train_state(params: Dict[str, Any], opt_leaves: Sequence[np.ndarray], step: int,
                     path) -> None:
    """Checkpoint a training state to one ``.npz``: ``params`` (a nested
    dict of numpy arrays), ``opt_leaves`` (the optimizer state's leaves in
    optax's order, with their dtypes) and ``step``."""
    flat_p = {f"params.{k}": np.asarray(v) for k, v in flatten_tree(params).items()}
    flat_o = {f"opt.{i}": np.asarray(x) for i, x in enumerate(opt_leaves)}
    _savez_exact(path, __step__=np.int64(step), **flat_p, **flat_o)


def is_train_state(path) -> bool:
    """True when ``path`` is a train-state archive rather than a bare params
    ``.npz``."""
    with np.load(path) as z:
        return "__step__" in z.files


def load_params_from_state(path) -> Dict[str, Any]:
    """The params tree of a train-state archive."""
    with np.load(path) as z:
        return unflatten_tree({k[len("params."):]: z[k] for k in z.files
                               if k.startswith("params.")})


def peek_step(path) -> int:
    """The step counter of a train-state archive, without loading its
    tensors (a resumed run's schedule horizon needs it first)."""
    with np.load(path) as z:
        if "__step__" not in z.files:
            raise ValueError(
                f"{path}: not a train-state archive (no __step__); "
                "was this saved with --save-state?"
            )
        return int(z["__step__"])


def load_train_state(path, opt_state_like: Sequence[Any]) -> Tuple[Dict[str, Any], List[np.ndarray],
                                                                    int]:
    """-> (params, optimizer leaves, step).  ``opt_state_like`` is the
    optimizer's leaves in optax's order (arrays, or their shapes as
    tuples): an archive of another leaf count or another leaf shape is
    refused in the JAX package's words."""
    with np.load(path) as z:
        step = int(z["__step__"])
        params = unflatten_tree({k[len("params."):]: z[k] for k in z.files
                                 if k.startswith("params.")})
        n_ckpt = sum(1 for k in z.files if k.startswith("opt."))
        if n_ckpt != len(opt_state_like):
            # a count mismatch must not restore a shape-coincident prefix
            raise ValueError(
                f"checkpoint has {n_ckpt} optimizer leaves, template has "
                f"{len(opt_state_like)} (optimizer mismatch?)"
            )
        leaves = [z[f"opt.{i}"] for i in range(n_ckpt)]
    for i, (got, want) in enumerate(zip(leaves, opt_state_like)):
        want = tuple(want) if isinstance(want, tuple) else tuple(np.shape(want))
        if tuple(got.shape) != want:
            raise ValueError(
                f"opt leaf {i}: checkpoint shape {got.shape} != "
                f"template {want} (optimizer mismatch?)"
            )
    return params, leaves, step
