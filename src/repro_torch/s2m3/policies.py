"""Named placement strategies and routing policies.

Both halves of the paper's planner become *registries* of callables with
a common signature, so ``s2m3.Deployment`` (and any future scheduler)
selects them by name instead of threading string-typed kwargs through
every layer:

* placement strategies — ``fn(models, cluster, *, workload=None,
  **opts) -> Placement``.  Built-ins: ``greedy`` (Algorithm 1),
  ``no_share`` (dedicated copies, the paper's sharing ablation),
  ``centralized`` (Cloud/Local baselines), ``optimal`` (brute-force
  Upper — needs ``workload``).
* routing policies — ``fn(RouteQuery) -> device name``.  Built-ins:
  ``paper`` (Eq. 7: min measured compute time) and ``queue_aware``
  (beyond-paper: min predicted completion including queueing).

The same routing policy object serves the event-driven simulator (full
queue state in the ``RouteQuery``) and the live engine, which is what
makes simulated and real module→device assignments comparable.  The
engine routes with an empty queue at deploy time; once a serving
scheduler is attached (``serving.scheduler.ServeScheduler`` sets
``engine.queue_probe``), ``RouteQuery.device_free`` carries the
scheduler's *live* per-host occupancy — a ``core.routing.QueueSnapshot``
— so ``queue_aware`` ranks replica hosts by real load.

Register your own with the ``@register_placement`` /
``@register_routing`` decorators.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.module import ModuleSpec
from repro_torch.core.placement import (
    Placement, centralized_place, greedy_place, optimal_place,
)

# --------------------------------------------------------------------------
# routing
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class RouteQuery:
    """Everything a routing policy may consult when choosing among the
    devices hosting a module replica.  ``request`` / queue state are
    optional: the live engine routes with an empty queue at deploy time
    and with the serving scheduler's live occupancy under load."""

    module: ModuleSpec
    hosts: tuple[str, ...]
    cluster: ClusterSpec
    source: str | None = None
    request: Any = None                    # core.routing.Request or None
    ready_time: float = 0.0
    device_free: Mapping[str, float] = field(default_factory=dict)

    def work_mult(self, device) -> float:
        if self.request is None:
            return 1.0            # deploy-time routing: no request workload
        from repro_torch.core.routing import work_multiplier

        return work_multiplier(self.request, self.module.modality, device)

    def t_comm_in(self, dname: str) -> float:
        if self.source is None:
            return 0.0
        return self.cluster.t_comm(self.source, dname, self.module.input_bytes)


RoutingPolicy = Callable[[RouteQuery], str]
PlacementStrategy = Callable[..., Placement]

_ROUTINGS: dict[str, RoutingPolicy] = {}
_PLACEMENTS: dict[str, PlacementStrategy] = {}


def register_routing(name: str) -> Callable[[RoutingPolicy], RoutingPolicy]:
    def deco(fn: RoutingPolicy) -> RoutingPolicy:
        _ROUTINGS[name] = fn
        return fn
    return deco


def get_routing(name: str) -> RoutingPolicy:
    try:
        return _ROUTINGS[name]
    except KeyError:
        raise KeyError(
            f"unknown routing policy {name!r}; "
            f"available: {available_routings()}") from None


def available_routings() -> tuple[str, ...]:
    return tuple(sorted(_ROUTINGS))


@register_routing("paper")
def route_paper(q: RouteQuery) -> str:
    """Eq. (7): hosting device with minimal measured compute time for
    this request's workload."""
    def key(dname: str) -> float:
        dev = q.cluster.device(dname)
        return q.cluster.t_comp(q.module, dev) * q.work_mult(dev)
    return min(q.hosts, key=key)


@register_routing("queue_aware")
def route_queue_aware(q: RouteQuery) -> str:
    """Beyond-paper: minimal predicted completion, counting the input
    transfer and the device's outstanding queue."""
    def key(dname: str) -> float:
        dev = q.cluster.device(dname)
        arrive = q.ready_time + q.t_comm_in(dname)
        return max(arrive, q.device_free.get(dname, 0.0)) \
            + q.cluster.t_comp(q.module, dev) * q.work_mult(dev)
    return min(q.hosts, key=key)


# --------------------------------------------------------------------------
# placement
# --------------------------------------------------------------------------


def register_placement(name: str) -> Callable[[PlacementStrategy],
                                              PlacementStrategy]:
    def deco(fn: PlacementStrategy) -> PlacementStrategy:
        _PLACEMENTS[name] = fn
        return fn
    return deco


def get_placement(name: str) -> PlacementStrategy:
    try:
        return _PLACEMENTS[name]
    except KeyError:
        raise KeyError(
            f"unknown placement strategy {name!r}; "
            f"available: {available_placements()}") from None


def available_placements() -> tuple[str, ...]:
    return tuple(sorted(_PLACEMENTS))


def strategy_options(fn: PlacementStrategy) -> tuple[str, ...] | None:
    """Keyword options a placement strategy accepts, for static typo
    checking of ``plan(**opts)``.  Returns ``None`` when the strategy
    declares a real ``**kwargs`` (anything goes — not checkable); the
    built-ins use the ``**_`` convention for "ignore options meant for
    other strategies", which *is* checkable."""
    import inspect

    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    names = []
    for p in sig.parameters.values():
        if p.kind == inspect.Parameter.VAR_KEYWORD:
            if p.name != "_":
                return None
        elif p.kind in (inspect.Parameter.KEYWORD_ONLY,
                        inspect.Parameter.POSITIONAL_OR_KEYWORD):
            names.append(p.name)
    return tuple(names)


@register_placement("greedy")
def place_greedy(models, cluster, *, workload=None, replicate=False,
                 **_) -> Placement:
    """Algorithm 1: shared modules, completion-time-greedy first fit."""
    return greedy_place(models, cluster, share=True, replicate=replicate)


@register_placement("no_share")
def place_no_share(models, cluster, *, workload=None, replicate=False,
                   **_) -> Placement:
    """Sharing ablation (Table X): a dedicated module copy per model."""
    return greedy_place(models, cluster, share=False, replicate=replicate)


@register_placement("centralized")
def place_centralized(models, cluster, *, workload=None, device=None,
                      **_) -> Placement:
    """Everything on one device (Cloud/Local baselines).  ``device``
    defaults to the largest-memory device in the pool."""
    if device is None:
        device = max(cluster.devices, key=lambda d: d.mem_capacity).name
    return centralized_place(models, cluster, device)


@register_placement("optimal")
def place_optimal(models, cluster, *, workload=None, max_nodes=8,
                  **_) -> Placement:
    """Brute-force Upper baseline; requires the workload it optimizes."""
    if not workload:
        raise ValueError(
            "placement strategy 'optimal' needs workload=[Request, ...]")
    pl, _ = optimal_place(models, cluster, workload, max_nodes=max_nodes)
    return pl
