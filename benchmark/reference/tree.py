"""Minimal tree mapping over the port's containers.

The containers are NamedTuples (possibly nested) whose leaves are tensors,
numpy arrays or `None` (an optional field that is absent). `tree_map`
applies a function leaf by leaf and rebuilds the same containers; `None`
stays `None`.
"""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """Apply `fn(leaf, *other_leaves)` to every leaf of `tree`.

    NamedTuples, tuples, lists and dicts are containers; `None` is kept;
    everything else is a leaf. `rest` trees must have the same structure.
    """
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x, *(r[i] for r in rest))
                            for i, x in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x, *(r[i] for r in rest))
                          for i, x in enumerate(tree))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_to(tree, device):
    """Every tensor leaf moved to `device` (raises if it is not there)."""
    return tree_map(lambda x: x.to(device), tree)
