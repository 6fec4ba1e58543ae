"""Declarative weight specs.

A layer declares its weights once as a tree of ``WSpec``; the same tree
drives initialization (``init_tree``), abstract evaluation
(``abstract_tree``: meta tensors for the dry run) and the parameter
count and bytes.  The
port keeps the JAX package's shapes and nesting, so a tree built here
and one bridged from the reference (``common.bridge``) are
interchangeable.  ``init_tree`` draws from a seeded ``torch.Generator``:
its values do not match JAX's, only its shapes and scales do.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from repro_torch.common.pytree import tree_leaves, tree_map


@dataclass(frozen=True)
class WSpec:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]            # logical axis names (or None), len == ndim
    init: str = "normal"             # normal | zeros | ones | embed | small
    scale: float | None = None       # stddev override for "normal"
    dtype: Any = None                # None -> param dtype at init time

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"WSpec shape {self.shape} vs axes {self.axes}")


def _std(ws: WSpec) -> float:
    if ws.scale is not None:
        return ws.scale
    if ws.init == "embed":
        return 1.0
    if ws.init == "small":
        return 0.02
    # fan-in normal
    fan_in = int(np.prod(ws.shape[:-1])) or 1
    return 1.0 / float(np.sqrt(fan_in))


def _map_specs(fn, spec_tree):
    return tree_map(lambda ws: fn(ws) if isinstance(ws, WSpec) else ws,
                    spec_tree)


def init_leaf(ws: WSpec, generator: torch.Generator, dtype,
              device) -> torch.Tensor:
    dt = ws.dtype or dtype
    if ws.init == "zeros":
        return torch.zeros(ws.shape, dtype=dt, device=device)
    if ws.init == "ones":
        return torch.ones(ws.shape, dtype=dt, device=device)
    if generator is None:
        raise ValueError(f"init_leaf: {ws.init!r} leaf needs a generator")
    x = torch.randn(ws.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    # scaled in place: no second leaf-sized tensor (deepseek-v3's expert
    # leaves are 15 GB each), the same values as ``x * std``
    return x.mul_(_std(ws)).to(device=device, dtype=dt)


def init_tree(spec_tree, generator: torch.Generator | None = None,
              dtype=torch.float32, device="cpu"):
    """Tensors of the spec tree's shapes on ``device``; normal leaves are
    drawn in tree order from ``generator`` (whose own device is where
    the draws happen), zeros/ones leaves need none."""
    return _map_specs(lambda ws: init_leaf(ws, generator, dtype, device),
                      spec_tree)


def stack_specs(spec_tree, n: int):
    """Prepend a stacked-layers dimension (logical axis "layers")."""
    return _map_specs(
        lambda ws: replace(ws, shape=(n, *ws.shape), axes=("layers", *ws.axes)),
        spec_tree)


def spec_param_count(spec_tree) -> int:
    return sum(int(np.prod(ws.shape)) for ws in tree_leaves(spec_tree)
               if isinstance(ws, WSpec))


def spec_param_bytes(spec_tree, param_dtype=torch.bfloat16) -> int:
    """Bytes of the spec tree's leaves, each in its own dtype or
    ``param_dtype``."""
    return sum(int(np.prod(ws.shape)) * (ws.dtype or param_dtype).itemsize
               for ws in tree_leaves(spec_tree) if isinstance(ws, WSpec))


def _local_shape(shape, mesh, placements) -> tuple[int, ...]:
    """This rank's shape of a tensor of ``shape`` placed by
    ``placements``: torch's chunking of each sharded dim (a dim sharded
    over several mesh dims is chunked by each in mesh order)."""
    local = list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p.is_shard():
            n, d = mesh.size(i), p.dim % len(shape)
            chunk = -(-local[d] // n)
            local[d] = max(0, min(chunk, local[d] - coord[i] * chunk))
    return tuple(local)


def abstract_tree(spec_tree, param_dtype=torch.float32, placements=None,
                  mesh=None):
    """The spec tree as tensors on the ``meta`` device, which hold no
    memory: each leaf in its own dtype or ``param_dtype``.  With
    ``placements`` (a tree of DTensor placements, as
    ``common.sharding.tree_placements`` gives) and ``mesh``, each leaf is
    a DTensor of the spec's global shape whose local tensor has the shape
    ``shard_tree`` would give this rank.  The dry run's counterpart of
    the reference's ``ShapeDtypeStruct`` trees."""
    def one(ws, pl=None):
        dt = ws.dtype or param_dtype
        if pl is None:
            return torch.empty(ws.shape, dtype=dt, device="meta")
        from torch.distributed.tensor import DTensor

        loc = torch.empty(_local_shape(ws.shape, mesh, pl), dtype=dt,
                          device="meta")
        return DTensor.from_local(loc, mesh, pl, run_check=False,
                                  shape=torch.Size(ws.shape),
                                  stride=torch.empty(ws.shape,
                                                     device="meta").stride())

    if placements is None:
        return _map_specs(one, spec_tree)
    return tree_map(one, spec_tree, placements)
