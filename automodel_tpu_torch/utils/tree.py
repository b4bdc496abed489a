"""Nested dicts of tensors, the port's parameter trees: map and flatten in
insertion order (the counterparts of `jax.tree.map` / `jax.tree.leaves` on
the JAX package's dict trees)."""

from __future__ import annotations


def tree_map(fn, tree, *rest):
    """`fn(leaf, *leaves at the same path in rest)` over every leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    return [tree]
