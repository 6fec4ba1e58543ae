"""Tree helpers over nested dicts / lists / tuples of tensors — the
port's stand-in for ``jax.tree`` on parameter and cache trees."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leafwise over one or more trees of equal structure;
    dicts keep their keys, lists and tuples their type."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in the order ``tree_map`` visits them."""
    out: list = []
    tree_map(out.append, tree)
    return out
