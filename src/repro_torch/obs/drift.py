"""Predicted-vs-actual drift analysis: does ``serve()`` do what
``simulate()`` promised?

``compare_deployment(dep, workload)`` drives the SAME ``Request``
objects through the event simulator and the live continuous-batching
scheduler, then lines the two up:

* **routes** — ``PlanReport.routes[rid]`` vs ``InferenceResult.devices``
  per module (the ROADMAP's "sim routes == real devices" invariant);
* **per-module latency** — mean predicted compute interval (sim
  ``comp``/``head_comp`` events) vs mean measured span duration, as a
  measured/predicted ratio;
* **per-request latency and queue-model error** — how far the
  simulator's end-to-end latencies sit from the scheduler's wall-clock
  measurements, in aggregate.

The latency *ratios* are the honest output: the simulator's absolute
scale comes from ``ClusterSpec`` FLOP rates, not from this machine, so
a stable ratio means the queue model ranks and proportions correctly
even when the absolute clock differs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: timeline phases that represent module compute, comparable with the
#: simulator's comp/head_comp events
_MEASURED_PHASES = ("encode", "head", "prefill", "decode")


@dataclass(frozen=True)
class RouteDivergence:
    rid: int
    module: str
    predicted: str
    actual: str


@dataclass
class ModuleDrift:
    module: str
    predicted_s: float           # mean simulated compute interval
    measured_s: float            # mean measured span duration
    n: int                       # measured samples

    @property
    def ratio(self) -> float:
        return (self.measured_s / self.predicted_s
                if self.predicted_s > 0 else float("inf"))


@dataclass
class DriftReport:
    """One simulate()-vs-serve() comparison over a shared workload."""

    n_requests: int
    route_divergences: list[RouteDivergence] = field(default_factory=list)
    routes_checked: int = 0
    modules: dict[str, ModuleDrift] = field(default_factory=dict)
    # rid -> (predicted_s, measured_s)
    request_latency: dict[int, tuple[float, float]] = field(
        default_factory=dict)

    @property
    def n_route_divergences(self) -> int:
        return len(self.route_divergences)

    @property
    def predicted_mean_latency(self) -> float:
        xs = [p for p, _ in self.request_latency.values()]
        return sum(xs) / len(xs) if xs else 0.0

    @property
    def measured_mean_latency(self) -> float:
        xs = [m for _, m in self.request_latency.values()]
        return sum(xs) / len(xs) if xs else 0.0

    @property
    def queue_model_error(self) -> float:
        """Relative error of the simulator's mean end-to-end latency
        against the measured mean (0 = perfect queue model)."""
        p, m = self.predicted_mean_latency, self.measured_mean_latency
        if p <= 0:
            return float("inf") if m > 0 else 0.0
        return abs(m - p) / p

    def summary(self) -> str:
        lines = [f"drift report over {self.n_requests} request(s):"]
        lines.append(
            f"  routes: {self.routes_checked} module-route(s) checked, "
            f"{self.n_route_divergences} divergence(s)")
        for d in self.route_divergences:
            lines.append(f"    rid {d.rid} {d.module}: predicted "
                         f"{d.predicted} but ran on {d.actual}")
        for name in sorted(self.modules):
            md = self.modules[name]
            lines.append(
                f"  {name:24s} predicted {md.predicted_s * 1e3:8.3f} ms  "
                f"measured {md.measured_s * 1e3:8.3f} ms  "
                f"ratio {md.ratio:8.2f}x  (n={md.n})")
        lines.append(
            f"  e2e latency: predicted mean "
            f"{self.predicted_mean_latency * 1e3:.3f} ms vs measured mean "
            f"{self.measured_mean_latency * 1e3:.3f} ms "
            f"(queue-model error {self.queue_model_error:.1%})")
        return "\n".join(lines)


def compare_deployment(dep, workload, **serve_kwargs) -> DriftReport:
    """Run ``dep.simulate(workload)`` and ``dep.serve(workload)`` and
    reconcile them.  ``serve_kwargs`` flow to ``Deployment.serve``."""
    predicted = dep.simulate(workload)
    results = dep.serve(workload, **serve_kwargs)

    report = DriftReport(n_requests=len(workload))

    # predicted per-module compute intervals from the sim event trace
    pred_durs: dict[str, list[float]] = {}
    if predicted.sim is not None:
        for e in predicted.sim.events:
            if e.kind in ("comp", "head_comp"):
                pred_durs.setdefault(e.module, []).append(e.end - e.start)

    meas_durs: dict[str, list[float]] = {}
    for req, res in zip(workload, results):
        routes = predicted.routes.get(req.rid, {})
        for module, actual in sorted(res.devices.items()):
            want = routes.get(module)
            if want is None:
                continue                 # sim emitted no event (0-flop head)
            report.routes_checked += 1
            if want != actual:
                report.route_divergences.append(
                    RouteDivergence(req.rid, module, want, actual))
        for span in res.timeline:
            name, phase, t0, t1 = span
            if phase in _MEASURED_PHASES and t1 is not None:
                meas_durs.setdefault(name, []).append(t1 - t0)
        pred_lat = (predicted.sim.latencies.get(req.rid, 0.0)
                    if predicted.sim is not None else 0.0)
        report.request_latency[req.rid] = (pred_lat, res.latency_s)

    for module in sorted(set(pred_durs) & set(meas_durs)):
        ps, ms = pred_durs[module], meas_durs[module]
        report.modules[module] = ModuleDrift(
            module, sum(ps) / len(ps), sum(ms) / len(ms), len(ms))
    return report
