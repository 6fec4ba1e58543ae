"""``repro_torch.obs`` — observability for the serving stack.

* **Tracing** (``obs.trace``): ``Span``/``Tracer`` with an injectable
  monotonic clock; the engine, scheduler and decode streams emit one
  span tree per request, exportable as Chrome-trace JSON.  The device
  calls' spans (``encode``, ``head``, ``prefill``, ``decode_tick``)
  carry ``dispatch_s`` and ``syncs``.  ``Tracer.scope`` times the
  serving loop's host phases (``s2m3.<part>.<phase>``) and, while a
  ``torch.profiler`` records, names them in its timeline; a tracer built
  with ``gc=True`` (the scheduler's) records each garbage collection as
  a ``gc`` span.
* **Metrics** (``obs.metrics``): a lock-safe counter/gauge/histogram
  registry; ``stats_dict()`` is a compatibility view over it.
  ``obs.summary.slo_summary`` renders per-task p50/p99 and SLO-deadline
  attainment from the histograms.
* **Drift** (``obs.drift``): ``Deployment.compare(workload)`` runs
  ``simulate()`` and ``serve()`` on the same ``Request`` objects and
  reports route divergences, per-module measured/predicted latency
  ratios and queue-model error.  On the card the measured spans end
  after a device sync, so they time the device work, not its enqueue.
"""

from repro_torch.obs.drift import DriftReport, compare_deployment
from repro_torch.obs.metrics import Counter, Gauge, Histogram, MetricsRegistry
from repro_torch.obs.summary import format_slo_summary, slo_summary
from repro_torch.obs.trace import Scope, Span, Trace, Tracer

__all__ = [
    "Counter", "DriftReport", "Gauge", "Histogram", "MetricsRegistry",
    "Scope", "Span", "Trace", "Tracer", "compare_deployment",
    "format_slo_summary", "slo_summary",
]
