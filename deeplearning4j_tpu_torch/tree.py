"""Parameter trees: nested dicts and lists of tensors (or arrays).

The port's counterpart of the parts of ``jax.tree_util`` it needs.  Dicts
and lists are containers, in insertion and index order; everything else,
tuples included, is a leaf (`param_shapes` keeps shape tuples as leaves).
Keypaths are the JAX package's ``//``-joined keys (``layers//0//attn//wq``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List

KEYPATH_SEP = "//"


def map_tree(fn: Callable, tree, *rest):
    """``fn(leaf, *matching leaves of rest)`` over trees of one structure."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def flatten_tree(tree, prefix: str = "") -> Dict[str, Any]:
    """``{keypath: leaf}`` in tree order."""
    if isinstance(tree, dict):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, list):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}{KEYPATH_SEP}{k}" if prefix
                                else k))
    return out


def tree_leaves(tree) -> List[Any]:
    """The leaves in tree order."""
    return list(flatten_tree(tree).values())


__all__ = ["KEYPATH_SEP", "flatten_tree", "map_tree", "tree_leaves"]
