"""Tree helpers over nested dicts / lists / tuples of tensors — the
port's stand-in for ``jax.tree`` on parameter and cache trees — and the
reference's counting, casting and comparison helpers over them (a
DTensor leaf counts at its global shape)."""

from __future__ import annotations

import math
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


def param_count(tree) -> int:
    """Elements over every leaf."""
    return sum(math.prod(x.shape) for x in tree_leaves(tree))


def param_bytes(tree) -> int:
    """Bytes over every leaf, each at its own dtype."""
    return sum(math.prod(x.shape) * x.dtype.itemsize
               for x in tree_leaves(tree))


def cast_tree(tree, dtype):
    """Floating leaves cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def tree_paths(tree) -> dict[str, Any]:
    """``{"a/b/0": leaf}``: each leaf under its dict keys and list
    indices joined by "/"."""
    out: dict[str, Any] = {}
    tree_map_with_path(
        lambda path, x: out.__setitem__("/".join(map(str, path)), x), tree)
    return out


def tree_allclose(a, b, rtol=1e-5, atol=1e-5) -> bool:
    """Two trees of as many leaves, each pair equal within the
    tolerances (compared on the host in float64, whatever their dtypes,
    as numpy compares the reference's)."""
    la, lb = tree_leaves(a), tree_leaves(b)
    if len(la) != len(lb):
        return False

    def host(x):
        return torch.as_tensor(x).detach().cpu().double()

    return all(torch.allclose(host(x), host(y), rtol=rtol, atol=atol)
               for x, y in zip(la, lb))
