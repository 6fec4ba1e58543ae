"""Logical-axis sharding rules, resolved onto ``torch.distributed``'s
``DeviceMesh`` and ``DTensor``.

Every weight / activation dimension carries a *logical* axis name
("embed", "mlp", "heads", "batch", ...).  A rule table maps logical names
to mesh axis names.  ``spec_for`` resolves a logical-axis tuple into a
spec (one entry per tensor dimension: None, a mesh axis name, or a tuple
of names), demoting any mesh axis whose size does not divide the
dimension (demotion = replication: always correct, possibly wasteful).
The entries are the JAX package's ``PartitionSpec`` entries for the same
rules and mesh axis sizes.

``placements_for`` turns a spec into one DTensor placement per mesh dim:
``Shard(d)`` where the mesh dim names an axis of tensor dim ``d``'s
entry, else ``Replicate()``.  A tuple entry such as ``("pod", "data")``
shards one tensor dim over two mesh dims; DTensor splits it over the mesh
dims in mesh order (the first the major one), which is the JAX order of
the entry's axes only when the entry lists them in mesh order, so an
entry against that order raises.  A mesh dim of size 1 is always
``Replicate()``: one shard is the whole tensor, and no collective runs
over it.

``shard_map`` is the port's counterpart of the reference's
``shard_map_compat``: each argument is redistributed to its spec's
placements, the function runs on the local tensors, and each result is
wrapped back with its output spec.  The collectives it may call
(``all_reduce``, ``all_gather``) run over the process groups of named
mesh axes, are autograd-aware, and are skipped over a group of one
rank.  Gradients inside the function are *unreduced*: a rank's local
cotangent is its share of the logical one.  So an output replicated
over mesh dims of n ranks in all receives 1/n of its cotangent on each
rank, the transpose of ``all_reduce`` is ``all_reduce`` and that of
``all_gather`` a reduce-scatter, and an input replicated over a mesh
dim hands its local gradient back as a ``Partial`` sum over that dim.
This gives the gradient of the logical function whatever mixes
replicated and rank-varying values inside (the expert-parallel MoE
routes replicated tokens through each rank's own experts).

Meshes are resolved from their axis sizes alone: ``spec_for`` takes a
``DeviceMesh`` or a ``{axis: size}`` mapping, so specs resolve with no
process group (as the reference's tests resolve them on a
repeated-device mesh).
"""

from __future__ import annotations

import contextlib
import math
from typing import Mapping, Sequence

import torch

# Mesh axes in this codebase: ("pod", "data", "model") multi-pod,
# ("data", "model") single pod.
MeshAxes = tuple[str, ...] | str | None

# Default rules: FSDP over (pod, data) for the embed dim, tensor
# parallelism over "model" for heads / mlp / vocab / experts, batch data-
# parallel over (pod, data), decode KV cache sequence-sharded over "model".
DEFAULT_RULES: dict[str, MeshAxes] = {
    # activations
    "batch": ("pod", "data"),
    "seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "vocab_out": "model",
    # weights
    "embed": ("pod", "data"),     # FSDP axis
    "mlp": "model",
    "heads": "model",
    "qkv_features": "model",
    "kv_heads": "model",
    "vocab": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,
    "norm": None,
    "mla_rank": None,
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "slstm_rec": None,
    # kv cache
    "cache_batch": ("pod", "data"),
    "cache_seq": "model",
    "cache_heads": None,
    "cache_feat": None,
    # optimizer
    "replicated": None,
}


def merge_rules(*overrides: Mapping[str, MeshAxes] | None) -> dict[str, MeshAxes]:
    rules = dict(DEFAULT_RULES)
    for ov in overrides:
        if ov:
            rules.update(ov)
    return rules


def mesh_shape(mesh) -> dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` (its dim names) or of a
    mapping that already is one."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _axes_present(entry: MeshAxes, shape: Mapping[str, int]) -> tuple[str, ...]:
    if entry is None:
        return ()
    if isinstance(entry, str):
        entry = (entry,)
    return tuple(a for a in entry if a in shape)


def spec_for(shape: Sequence[int], logical_axes: Sequence[str | None],
             rules: Mapping[str, MeshAxes], mesh) -> tuple:
    """Resolve logical axes into a spec valid for ``shape`` on ``mesh``.

    Per dimension, mesh axes are kept only while the running product
    still divides the dimension size (prefix demotion), and an axis is
    never used twice in one spec.
    """
    assert len(shape) == len(logical_axes), (shape, logical_axes)
    sizes = mesh_shape(mesh)
    used: set[str] = set()
    out: list = []
    for dim, name in zip(shape, logical_axes):
        if name is None:
            out.append(None)
            continue
        kept: list[str] = []
        prod = 1
        for a in _axes_present(rules.get(name, None), sizes):
            if a in used:
                continue
            if dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        used.update(kept)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    return tuple(out)


def placements_for(spec: Sequence, mesh) -> tuple:
    """One DTensor placement per mesh dim for ``spec`` (see the module
    docstring for the order of a tuple entry's axes)."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} lists its axes against the mesh's "
                f"order {names}: DTensor shards one tensor dim over mesh "
                "dims in mesh order")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return tuple(out)


def tree_pspecs(spec_tree, rules, mesh):
    """Map a WSpec tree (see ``layers.initializers``) to specs."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.layers.initializers import WSpec

    def one(ws):
        if isinstance(ws, WSpec):
            return spec_for(ws.shape, ws.axes, rules, mesh)
        raise TypeError(f"expected WSpec, got {type(ws)}")

    return tree_map(one, spec_tree)


def tree_placements(spec_tree, rules, mesh):
    """Map a WSpec tree to each leaf's DTensor placements on ``mesh``."""
    from repro_torch.common.pytree import tree_map

    # mapped over the WSpec tree: a spec is itself a tuple
    return tree_map(lambda ws: placements_for(
        spec_for(ws.shape, ws.axes, rules, mesh), mesh), spec_tree)


def shard_leaf(x: torch.Tensor, mesh, placements):
    """``x`` as a DTensor whose local tensor is this rank's slice of it.
    Every rank holds the same full ``x`` and keeps its slice (no scatter:
    ``src_data_rank=None``); the slice is copied out when it is a view,
    so the full tensor can be freed."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    dt = distribute_tensor(x, mesh, placements, src_data_rank=None)
    loc = dt.to_local()
    if loc.untyped_storage().nbytes() > loc.numel() * loc.element_size():
        dt = DTensor.from_local(loc.clone(), mesh, placements,
                                run_check=False)
    return dt


def shard_tree(params, spec_tree, rules, mesh):
    """Each leaf of ``params`` (a full tensor on every rank: from the same
    seeded generator, or from the bridge) as a DTensor placed by its
    WSpec's logical axes under ``rules``."""
    from repro_torch.common.pytree import tree_map

    return tree_map(lambda x, pl: shard_leaf(x, mesh, pl), params,
                    tree_placements(spec_tree, rules, mesh))


def local_mesh(shape: tuple[int, ...] = (1, 1),
               axes: tuple[str, ...] = ("data", "model"), device=None):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the ranks of the
    process group that is up: on CUDA unless ``device="cpu"`` is asked
    for (CUDA needs a card, but over a fake group).  Raises if no
    process group of ``prod(shape)`` ranks is up."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = math.prod(shape)
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            f"local_mesh{tuple(shape)}: no process group is up; start "
            f"{n} ranks (torch.distributed.run, or init_process_group with "
            f"world_size={n}) first")
    if dist.get_world_size() != n:
        raise RuntimeError(
            f"local_mesh{tuple(shape)} needs {n} ranks, the process group "
            f"has {dist.get_world_size()}")
    kind = torch.device(device).type if device is not None else "cuda"
    # a fake group (the dry run's) runs no collective: a CUDA mesh over
    # it, which picks the collectives the card's would, needs no card
    if kind == "cuda" and not torch.cuda.is_available() and \
            dist.get_backend() != "fake":
        raise RuntimeError("local_mesh: no CUDA device is available; pass "
                           "device='cpu' to build the mesh on the CPU")
    return init_device_mesh(kind, tuple(shape), mesh_dim_names=tuple(axes))


# --------------------------------------------------------------------------
# DTensor helpers and the shard_map counterpart
# --------------------------------------------------------------------------

def mesh_scope(mesh):
    """The context a sharded model's step runs in: plain tensors that
    meet DTensors (positions, lengths, masks) count as replicated (what
    ``implicit_replication`` switches on); no mesh, no context.  Scopes
    nest: leaving one restores the setting it found (torch's own context
    switches it off, also inside an outer one)."""
    if mesh is None:
        return contextlib.nullcontext()
    return _implicit_replication()


@contextlib.contextmanager
def _implicit_replication():
    from torch.distributed.tensor import DTensor

    dispatcher = DTensor._op_dispatcher
    before = dispatcher._allow_implicit_replication
    dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        dispatcher._allow_implicit_replication = before


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def to_placements(x, mesh, placements):
    """``x`` (a DTensor, or a plain tensor every rank holds whole) as a
    DTensor with ``placements``: a plain tensor enters as replicated, and
    a replicated dim becomes sharded by keeping the local slice (no
    collective); sharded to replicated gathers."""
    from torch.distributed.tensor import DTensor, Replicate

    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def local_as(x, mesh, placements):
    """This rank's local tensor of ``x`` (a DTensor, or a plain tensor
    every rank holds whole) at ``placements``: ``to_placements(...)
    .to_local()``, except in the one case two gloo ranks sharing one card
    need.  Where ``x`` lies on a CUDA device and the only change, over
    mesh dims of more than one rank, is one such dim of a gloo group
    going from Shard to Replicate (evenly, the tensor dim split over no
    other), the gather goes through the c10d all-gather
    (``all_gather``): there DTensor's own all-gather, a functional
    collective, kills the process (torch 2.11), and NCCL refuses two
    ranks on one device.  To be removed, leaving ``to_placements``, once
    ``chip_smoke.py``'s phases 12 to 14 run over NCCL on two cards."""
    import torch.distributed as dist

    if is_dtensor(x) and x.device.type == "cuda":
        moved = [i for i, (a, b) in enumerate(zip(x.placements, placements))
                 if a != b and mesh.shape[i] > 1]
        if len(moved) == 1:
            i = moved[0]
            a, b = x.placements[i], placements[i]
            alone = not any(p.is_shard(a.dim) for j, p in
                            enumerate(x.placements)
                            if j != i and mesh.shape[j] > 1)
            if (a.is_shard() and b.is_replicate() and alone
                    and x.shape[a.dim] % mesh.shape[i] == 0
                    and dist.get_backend(mesh.get_group(i)) == "gloo"):
                return all_gather(x.to_local(), mesh,
                                  mesh.mesh_dim_names[i], a.dim)
    return to_placements(x, mesh, placements).to_local()


def constrain(x, logical_axes, rules, mesh):
    """The reference's ``with_sharding_constraint`` at the spec of
    ``logical_axes``: ``x`` redistributed to those placements."""
    spec = spec_for(x.shape, logical_axes, rules, mesh)
    return to_placements(x, mesh, placements_for(spec, mesh))


def _axis_tuple(axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def axis_index(mesh, axes) -> int:
    """This rank's row-major index over the mesh ``axes`` (the first the
    major one), as the reference folds ``axis_index`` over a tuple."""
    idx = 0
    for a in _axis_tuple(axes):
        idx = idx * mesh_shape(mesh)[a] + mesh.get_local_rank(a)
    return idx


def axis_size(mesh, axes) -> int:
    sizes = mesh_shape(mesh)
    return math.prod(sizes[a] for a in _axis_tuple(axes))


class _AllReduce(torch.autograd.Function):
    """An out-of-place ``all_reduce`` whose backward all-reduces the
    gradient (the transpose of ``psum`` on unreduced cotangents is
    ``psum``); MAX has no backward."""

    @staticmethod
    def forward(ctx, x, group, op):
        import torch.distributed as dist

        ctx.group, ctx.op = group, op
        y = x.clone()
        dist.all_reduce(y, op=op, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        if ctx.op != dist.ReduceOp.SUM:
            raise RuntimeError("all_reduce: only SUM has a backward")
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None, None


class _AllGather(torch.autograd.Function):
    """A tiled ``all_gather`` along ``dim`` (``all_gather_into_tensor``
    on dim 0 moved into place); its backward takes this rank's slice of
    the all-reduced gradient (the reference's ``psum_scatter``)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        import torch.distributed as dist

        ctx.group, ctx.dim = group, dim
        n = dist.get_world_size(group)
        src = x.movedim(dim, 0).contiguous()
        out = torch.empty((n * src.shape[0], *src.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        n = dist.get_world_size(ctx.group)
        me = dist.get_rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[me], None, None


def all_reduce(x: torch.Tensor, mesh, axes, op: str = "sum"):
    """``psum`` / ``pmax`` / ``pmean`` over the mesh ``axes``: one
    ``all_reduce`` per axis of more than one rank (a reduction over a
    tuple of axes is the reduction over each in turn), autograd-aware."""
    import torch.distributed as dist

    red = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
           "max": dist.ReduceOp.MAX}[op]
    for a in _axis_tuple(axes):
        if mesh_shape(mesh)[a] > 1:
            x = _AllReduce.apply(x, mesh.get_group(a), red)
    if op == "mean":
        x = x / axis_size(mesh, axes)
    return x


def all_gather(x: torch.Tensor, mesh, axes, dim: int):
    """The reference's tiled ``all_gather`` over the mesh ``axes`` along
    ``dim`` (row-major over the axes: the last axis gathered first, so
    the first ends up the major one); autograd-aware."""
    for a in reversed(_axis_tuple(axes)):
        if mesh_shape(mesh)[a] > 1:
            x = _AllGather.apply(x, mesh.get_group(a), dim)
    return x


class Split:
    """One rank's share of a dim split over the mesh ``axes`` (None, or
    no mesh: the dim is whole), inside ``shard_map``: ``sum`` is the psum
    over those axes, ``gather`` their tiled all_gather, ``offset`` where
    this rank's share of ``n`` starts.  ``WHOLE`` is the split of no
    axes, whose collectives are the identity."""

    def __init__(self, mesh=None, axes=None):
        self.mesh = mesh
        self.axes = axes if mesh is not None else None

    def __bool__(self) -> bool:
        return bool(_axis_tuple(self.axes))

    def sum(self, x):
        return all_reduce(x, self.mesh, self.axes) if self else x

    def gather(self, x, dim: int):
        return all_gather(x, self.mesh, self.axes, dim) if self else x

    def offset(self, n: int) -> int:
        return axis_index(self.mesh, self.axes) * n if self else 0

    @property
    def size(self) -> int:
        return axis_size(self.mesh, self.axes) if self else 1


WHOLE = Split()


def settle(x):
    """A DTensor's pending partial sums reduced (``Partial`` placements
    redistributed to ``Replicate``); anything else as it is."""
    from torch.distributed.tensor import Replicate

    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def spec_of(x) -> tuple:
    """The spec of a DTensor's placements: per tensor dim, None, the
    mesh axis that shards it, or a tuple of axes in mesh order (the
    inverse of ``placements_for``).  Raises on a pending partial sum
    (``settle`` it first)."""
    names = tuple(x.device_mesh.mesh_dim_names)
    per: list[list[str]] = [[] for _ in range(x.ndim)]
    for name, p in zip(names, x.placements):
        if p.is_partial():
            raise ValueError("spec_of: a Partial placement has no spec")
        if p.is_shard():
            per[p.dim % x.ndim].append(name)
    return tuple(None if not a else a[0] if len(a) == 1 else tuple(a)
                 for a in per)


def lead_spec(x):
    """(``x`` with its partial sums reduced, the spec of every dim of it
    but the last): how an activation's rows are laid out, which a
    per-rank product keeps (all None for a plain tensor)."""
    x = settle(x)
    if not is_dtensor(x):
        return x, (None,) * (x.ndim - 1)
    return x, spec_of(x)[:-1]


def unless_used(entry, lead):
    """A weight dim's spec ``entry``, or None where one of its axes
    already lays out ``lead`` (a mesh axis shards one dim of a tensor)."""
    used = {a for e in lead for a in _axis_tuple(e)}
    return None if used & set(_axis_tuple(entry)) else entry


class _ScaleGrad(torch.autograd.Function):
    """The identity, whose backward scales the gradient by ``c``."""

    @staticmethod
    def forward(ctx, x, c):
        ctx.c = c
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.c, None


def _replicated_ranks(placements, mesh) -> int:
    """The ranks over which ``placements`` replicate a tensor."""
    return math.prod(mesh.shape[i] for i, p in enumerate(placements)
                     if not p.is_shard())


def _unreduced(placements, mesh) -> tuple:
    """A local input's gradient placements: ``Partial`` on each mesh dim
    of more than one rank that replicates it (its ranks' local
    gradients are shares of one sum), else its own placement."""
    from torch.distributed.tensor import Partial

    return tuple(Partial() if not p.is_shard() and mesh.shape[i] > 1 else p
                 for i, p in enumerate(placements))


def shard_map(f, mesh, in_specs, out_specs):
    """Run ``f`` on each rank's local tensors: every argument whose spec
    is not None is redistributed to that spec's placements and handed in
    as its local tensor (other arguments pass through); each output is
    wrapped back as a DTensor with its out spec.  ``out_specs`` is one
    spec, or a list of specs for a tuple of outputs.  Gradients follow
    the unreduced convention of the module docstring."""
    from torch.distributed.tensor import DTensor

    def run(*args):
        locs = []
        for x, spec in zip(args, in_specs, strict=True):
            if spec is None:
                locs.append(x)
            else:
                pl = placements_for(spec, mesh)
                locs.append(to_placements(x, mesh, pl).to_local(
                    grad_placements=_unreduced(pl, mesh)))
        out = f(*locs)
        single = not isinstance(out_specs, list)
        outs = (out,) if single else out
        specs = (out_specs,) if single else out_specs
        wrapped = []
        for o, s in zip(outs, specs, strict=True):
            pl = placements_for(s, mesh)
            n = _replicated_ranks(pl, mesh)
            if n > 1 and o.requires_grad and torch.is_grad_enabled():
                o = _ScaleGrad.apply(o, 1.0 / n)
            wrapped.append(DTensor.from_local(o, mesh, pl, run_check=False))
        return wrapped[0] if single else tuple(wrapped)

    return run
