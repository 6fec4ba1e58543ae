"""S2M3 public API: the ``Deployment`` facade and its policy registries.

This package is the stable entry point for split-and-share multi-task
inference — everything from model admission to placement, routing,
latency prediction, and live serving goes through ``Deployment``:

    from repro_torch.s2m3 import Deployment, Request

    dep = (Deployment(cluster)
           .add_model(spec, builders)
           .plan(placement="greedy", routing="queue_aware", replicate=True)
           .materialize())              # cuda, or device="cpu"
    report = dep.simulate(workload)     # predicted PlanReport
    result = dep.submit(workload[0])    # real compute, same Request
    results = dep.serve(workload)       # continuous-batching scheduler:
                                        # cross-task batches at shared
                                        # encoders, real queue-aware routing

Extension points: ``@register_placement`` / ``@register_routing`` add
named strategies without touching core.
"""

from repro_torch.core.routing import QueueSnapshot, Request, SimResult  # noqa: F401
from repro_torch.s2m3.deployment import Deployment, PlanReport  # noqa: F401
from repro_torch.s2m3.policies import (  # noqa: F401
    RouteQuery,
    available_placements,
    available_routings,
    get_placement,
    get_routing,
    register_placement,
    register_routing,
)

__all__ = [
    "Deployment", "PlanReport", "Request", "SimResult", "QueueSnapshot",
    "RouteQuery",
    "available_placements", "available_routings",
    "get_placement", "get_routing",
    "register_placement", "register_routing",
]
