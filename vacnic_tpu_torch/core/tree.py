"""Parameter trees: nested dicts, tuples and lists with tensors (or other
values) at the leaves, the port's stand-in for jax.tree_util."""

from __future__ import annotations

from typing import Any, Callable


def leaves_with_path(tree: Any, path: tuple = ()) -> list[tuple[tuple, Any]]:
    """[(path, leaf)] in the tree's own order (dict insertion order); a path
    is the tuple of keys and indices that reaches the leaf."""
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in leaves_with_path(v, path + (k,))]
    if isinstance(tree, (tuple, list)):
        return [x for i, v in enumerate(tree) for x in leaves_with_path(v, path + (i,))]
    return [(path, tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any, path: tuple = ()) -> Any:
    """fn(path, leaf, *other_leaves) at every leaf of `tree`, the other trees
    walked alongside; the result has `tree`'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), path=path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest), path=path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree, *rest)
