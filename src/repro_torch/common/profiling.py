"""Counting one call of a step function: the port's counterpart of the
reference's ``common/profiling.py`` and ``common/hlo_cost.py``.

The reference reads its roofline inputs from a compiled XLA program
(``cost_analysis``, ``memory_analysis`` and the optimized HLO text).
The port has no compiled program: ``measure(fn, *args)`` runs the call
under a ``TorchDispatchMode`` that sees every aten and c10d op this rank
executes, on real tensors or on ``meta`` tensors over a fake process
group (``launch.dryrun``), and counts, per rank:

* ``flops``: dot FLOPs, from ``torch.utils.flop_counter``'s formulas
  (matmuls, batched matmuls, convolutions, attention) applied to the
  ops on this rank's *local* tensors.  The mode lets DTensor dispatch
  first (it returns ``NotImplemented`` for a DTensor argument) and
  counts the local ops it issues; ``FlopCounterMode`` itself counts a
  DTensor op once at its global shape.  The ops DTensor runs on fake
  tensors to derive output shapes are not counted.  A kernel wrapper's
  launch is opaque to dispatch, so each reports its own FLOPs, bytes and
  peak through ``kernels.ops.WORK_HOOKS`` (the reference's einsum form:
  the full S x T score product), on the card and on meta tensors; on
  the CPU the plain versions' ops are counted instead.  ``dots_by_shape``
  breaks the products down by (output elements, contracted elements),
  as the reference's HLO dots can be (``tools/dryrun_parity.py``).
* ``bytes``: operand plus output bytes of each op that computes (views
  and uninitialised allocations move nothing).  This is a pre-fusion
  model: every intermediate goes to memory and back, where the
  reference's counts fused HLO instructions, whose insides stay on
  chip, so the port's figure is the larger.
* collectives: the output bytes and the count of each collective by the
  reference's kind ("all-reduce", "all-gather", "reduce-scatter",
  "all-to-all", "collective-permute", plus "broadcast"), both DTensor's
  functional collectives (``_c10d_functional.*``) and the in-place
  ``c10d`` ops ``sharding.all_reduce``/``all_gather`` issue; of them,
  ``inter_node_bytes``: the bytes of collectives whose group spans more
  than one node, rank r on node r // 8 (``common.hw``'s
  ``gpus_per_node``, as ``torch.distributed.run`` places eight ranks a
  node), which the roofline charges at the NIC's rate.
* memory: ``argument_size_in_bytes`` (the distinct storages of the
  arguments: this rank's state, batch and cache), ``output_size_in_
  bytes``, ``alias_size_in_bytes`` (outputs that are argument storages:
  caches updated in place), ``temp_size_in_bytes`` (the peak over the
  call of the bytes of storages it allocated that are still alive,
  outputs included) and ``total_bytes`` (arguments plus temp: the
  predicted peak).  Storages are tracked as the ops create them and let
  go through ``weakref.finalize``, so the count needs no allocator and
  works on meta tensors.  A meta kernel wrapper allocates only its
  outputs, no workspace; its hook adds the workspace the card's launch
  holds to the peak at that instant.  On the card the caching allocator
  rounds each block up to 512 bytes, which this model does not.
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

#: c10d / functional collective op name -> the reference's kind
_COLLECTIVE_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
    "broadcast_": "broadcast", "broadcast": "broadcast",
}
_COLLECTIVE_NS = ("c10d", "_c10d_functional")
_NO_BYTES = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "wait_tensor"}


@dataclass
class CostReport:
    """One rank's counts of one call (the reference's
    ``hlo_cost.CostReport`` keys, with its memory analysis)."""
    flops: float = 0.0
    bytes: float = 0.0
    collective_bytes: float = 0.0
    inter_node_bytes: float = 0.0
    bytes_by_op: dict = field(default_factory=dict)
    count_by_op: dict = field(default_factory=dict)
    kernel_flops: dict = field(default_factory=dict)
    dots_by_shape: dict = field(default_factory=dict)
    memory: dict = field(default_factory=dict)


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _storage(x):
    """(key, storage) of a plain tensor's storage."""
    st = x.untyped_storage()
    return st._cdata, st


def _nbytes(tensors) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


def _group_ranks(ns, args, kwargs) -> list[int]:
    """The global ranks of a collective's process group: a functional
    collective names it in its last argument, an in-place ``c10d`` op
    passes it boxed."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    if ns == "_c10d_functional":
        pg = _resolve_process_group(kwargs.get("group_name", args[-1]))
        return dist.get_process_group_ranks(pg)
    for a in args:
        if (isinstance(a, torch.ScriptObject) and a._type().qualified_name()
                .endswith("c10d.ProcessGroup")):
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(a))
    raise ValueError("a c10d collective without a process group")


def _spans_nodes(ranks) -> bool:
    from repro_torch.common.hw import H100_SXM

    return len({r // H100_SXM.gpus_per_node for r in ranks}) > 1


def _fake_active() -> bool:
    """A fake-tensor computation is under way: DTensor deriving an
    output's global shape (the fake mode is up, or it is running a meta
    kernel or a decomposition for a fake op)."""
    return (torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE)
            is not None or torch._C._meta_in_tls_dispatch_include())


class _Counter(TorchDispatchMode):
    """The dispatch mode ``measure`` runs a call under."""

    def __init__(self, known: set):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._formulas = flop_registry
        self._lock = threading.Lock()
        self._known = known            # storages that existed before
        self._live: dict[int, int] = {}
        self.live = 0
        self.peak = 0
        self.report = CostReport()

    # -- memory ----------------------------------------------------------
    def _track(self, outs):
        for x in outs:
            key, st = _storage(x)
            if key in self._known:
                continue
            with self._lock:
                if key in self._live:
                    continue
                n = st.nbytes()
                self._live[key] = n
                self.live += n
                self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, key)

    def _free(self, key):
        with self._lock:
            self.live -= self._live.pop(key, 0)

    def kernel_work(self, name, flops, moved, peak_bytes):
        """``kernels.ops.WORK_HOOKS`` entry: a launch's FLOPs and bytes,
        and its outputs and workspace held at once."""
        rep = self.report
        with self._lock:
            rep.flops += flops
            rep.bytes += moved
            rep.kernel_flops[name] = rep.kernel_flops.get(name, 0.0) + flops
            self.peak = max(self.peak, self.live + peak_bytes)

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _fake_active():
            return func(*args, **kwargs)      # not this rank's work
        if any(t is not torch.Tensor for t in types):
            # a DTensor (or a collective's async wrapper): let it dispatch,
            # and count the ops it issues on local tensors
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        self._count(func, args, kwargs, out, outs)
        self._track(outs)
        return out

    def _count(self, func, args, kwargs, out, outs):
        rep = self.report
        ns = func.namespace
        name = func._overloadpacket.__name__
        if ns in _COLLECTIVE_NS:
            kind = _COLLECTIVE_KIND.get(name)
            if kind is None:
                return
            # c10d's in-place ops write their first argument; the
            # functional ones return their output
            target = _tensors(args[:1]) if ns == "c10d" else outs
            n = _nbytes(target)
            inter = _spans_nodes(_group_ranks(ns, args, kwargs))
            with self._lock:
                rep.bytes_by_op[kind] = rep.bytes_by_op.get(kind, 0) + n
                rep.count_by_op[kind] = rep.count_by_op.get(kind, 0) + 1
                rep.collective_bytes += n
                rep.inter_node_bytes += n if inter else 0
            return
        formula = self._formulas.get(func._overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        moved = 0
        if not func.is_view and name not in _NO_BYTES:
            moved = _nbytes(_tensors((args, kwargs))) + _nbytes(outs)
        with self._lock:
            rep.flops += flops
            rep.bytes += moved
            if flops and outs:
                n_out = outs[0].numel()
                key = (n_out, int(flops // (2 * n_out)))
                rep.dots_by_shape[key] = rep.dots_by_shape.get(key, 0) + 1


def measure(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` run once under the counting mode; returns
    (its result, this rank's ``CostReport``)."""
    from repro_torch.kernels import ops

    arg_st = {}
    for x in _tensors((args, kwargs)):
        key, st = _storage(_local(x))
        arg_st[key] = st.nbytes()
    counter = _Counter(set(arg_st))
    ops.WORK_HOOKS.append(counter.kernel_work)
    try:
        with counter:
            out = fn(*args, **kwargs)
    finally:
        ops.WORK_HOOKS.remove(counter.kernel_work)
    out_st = {}
    for x in _tensors(out):
        key, st = _storage(_local(x))
        out_st[key] = st.nbytes()
    argument = sum(arg_st.values())
    counter.report.memory = {
        "argument_size_in_bytes": argument,
        "output_size_in_bytes": sum(out_st.values()),
        "alias_size_in_bytes": sum(n for k, n in out_st.items()
                                   if k in arg_st),
        "temp_size_in_bytes": counter.peak,
        "total_bytes": argument + counter.peak,
    }
    return out, counter.report


def memory_summary(report: CostReport) -> dict:
    return dict(report.memory)


def collective_stats(report: CostReport) -> dict:
    return {"bytes_by_op": dict(report.bytes_by_op),
            "count_by_op": dict(report.count_by_op),
            "total_bytes": report.collective_bytes,
            "inter_node_bytes": report.inter_node_bytes}


def cost_summary(report: CostReport) -> dict:
    """The FLOPs, bytes and each kernel's FLOPs; ``dots_by_shape`` as
    [output elements, contracted elements, times run] rows."""
    return {"flops": report.flops, "bytes": report.bytes,
            "kernel_flops": dict(report.kernel_flops),
            "dots_by_shape": sorted([a, b, n] for (a, b), n in
                                    report.dots_by_shape.items())}
