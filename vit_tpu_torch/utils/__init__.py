"""Shared utilities (nested-dict tree helpers)."""

from vit_tpu_torch.utils.tree import cast_tree, flatten_tree, unflatten_tree

__all__ = ["cast_tree", "flatten_tree", "unflatten_tree"]
