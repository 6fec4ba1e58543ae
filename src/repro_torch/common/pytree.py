"""Tree helpers over nested dicts / lists / tuples of tensors — the
port's stand-in for ``jax.tree`` on parameter and cache trees."""

from __future__ import annotations

from typing import Any, Callable

import torch


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


def tree_map_with_path(fn: Callable, tree: Any, path: tuple = ()) -> Any:
    """``tree_map`` whose ``fn(path, leaf)`` also gets the leaf's path:
    the dict keys and list/tuple indices from the root down."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, (*path, k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [tree_map_with_path(fn, v, (*path, i))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(path, tree)


def global_norm(tree):
    """sqrt of the sum of squares of every leaf, in float32."""
    return torch.sqrt(torch.stack(
        [x.float().square().sum() for x in tree_leaves(tree)]).sum())


def tree_unflatten(like: Any, leaves: list) -> Any:
    """A tree of ``like``'s structure whose leaves are ``leaves``, in
    ``tree_leaves`` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)
