"""Per-task latency and SLO-attainment summaries over the metrics
registry.

The serving scheduler observes every finished request into
``request.latency_s{model=...}`` histograms and counts
``slo.hit``/``slo.miss`` per model for requests that carried a
``slo_deadline``.  ``slo_summary`` renders those instruments as one row
per task — count, p50/p99 ms, and deadline hit-rate — without touching
scheduler internals, so it works on any ``MetricsRegistry`` that
follows the same naming.
"""

from __future__ import annotations

from typing import Any

from repro_torch.obs.metrics import MetricsRegistry


def slo_summary(source) -> list[dict[str, Any]]:
    """One row per served task: request count, p50/p99 latency (ms),
    and SLO-deadline attainment.  ``source`` is a ``MetricsRegistry``
    or anything with a ``.metrics`` registry (a ``ServeScheduler``)."""
    reg = source if isinstance(source, MetricsRegistry) \
        else getattr(source, "metrics")
    rows = []
    for model in reg.label_values("request.latency_s", "model"):
        hist = reg.histogram("request.latency_s", model=model)
        hits = reg.value("slo.hit", model=model)
        misses = reg.value("slo.miss", model=model)
        with_slo = hits + misses
        rows.append({
            "model": model,
            "requests": hist.count,
            "p50_ms": round(hist.percentile(50) * 1e3, 3),
            "p99_ms": round(hist.percentile(99) * 1e3, 3),
            "mean_ms": round(hist.mean * 1e3, 3),
            "slo_requests": with_slo,
            "slo_attainment": (round(hits / with_slo, 4)
                               if with_slo else None),
        })
    return rows


def format_slo_summary(rows: list[dict[str, Any]]) -> str:
    if not rows:
        return "no served requests recorded"
    lines = [f"{'task':16s} {'n':>5s} {'p50_ms':>9s} {'p99_ms':>9s} "
             f"{'SLO':>7s}"]
    for r in rows:
        att = ("-" if r["slo_attainment"] is None
               else f"{r['slo_attainment']:.0%}")
        lines.append(f"{r['model']:16s} {r['requests']:5d} "
                     f"{r['p50_ms']:9.3f} {r['p99_ms']:9.3f} {att:>7s}")
    return "\n".join(lines)
