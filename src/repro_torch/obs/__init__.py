"""``repro_torch.obs`` — tracing and metrics for the serving stack.

* **Tracing** (``obs.trace``): ``Span``/``Tracer`` with an injectable
  monotonic clock; the engine, scheduler and decode streams emit one
  span tree per request, exportable as Chrome-trace JSON.
* **Metrics** (``obs.metrics``): a lock-safe counter/gauge/histogram
  registry; ``stats_dict()`` is a compatibility view over it.
"""

from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.trace import Span, Trace, Tracer

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "Span", "Trace", "Tracer",
]
