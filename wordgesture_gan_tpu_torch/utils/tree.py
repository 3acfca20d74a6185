"""Nested dicts and lists of tensors: the port's parameter trees (the JAX
package uses ``jax.tree`` for the same)."""

from __future__ import annotations

from typing import Callable, List


def tree_leaves(tree) -> List:
    """The leaves in a fixed order: dicts by insertion, lists by index."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the matching leaves of ``rest``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *[r[k] for r in rest]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *[r[i] for r in rest]) for i, v in enumerate(tree))
    return fn(tree, *rest)
