"""``s2m3.Deployment`` — one lifecycle API from model specs to placed,
routed, servable multi-task inference.

    dep = (Deployment(cluster)
           .add_model(spec, builders)
           .plan(placement="greedy", routing="queue_aware", replicate=True)
           .materialize())                 # every host -> cuda

    report = dep.simulate(workload)      # predicted PlanReport
    result = dep.submit(request)         # real compute (same Request!)
    results = dep.serve(workload)        # continuous-batching scheduler
    dep.evict("retrieval")               # refcounted hot-remove
    dep.replan(cluster.without("dev3"))  # migrate live weights

One ``ModuleRegistry`` backs both planning and the live engine, so the
memory ledger, sharing savings, and eviction refcounts are consistent
between ``simulate()`` and ``submit()``.  Placement strategies and
routing policies are looked up by name in ``s2m3.policies``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.module import ModelSpec
from repro_torch.core.placement import Placement
from repro_torch.core.placement import replan as core_replan
from repro_torch.core.registry import ModuleRegistry
from repro_torch.core.routing import Request, SimResult, coalesce_batches, simulate
from repro_torch.s2m3.policies import get_placement, get_routing

_MB = 1024**2


@dataclass
class PlanReport:
    """What a plan (or replan) means: module→device assignments, the
    per-device memory ledger, sharing savings, and — when a workload was
    simulated — predicted latencies and per-request routes."""

    placement: Placement
    routing: str
    feasible: bool
    assignments: dict[str, list[str]]
    memory: dict[str, dict[str, int]]      # device -> used/capacity/free
    shared_bytes: int
    dedicated_bytes: int
    sharing_savings: float
    sim: SimResult | None = None
    routes: dict[int, dict[str, str]] = field(default_factory=dict)
    migrations: list[tuple[str, str]] = field(default_factory=list)

    @property
    def total_latency(self) -> float:
        return self.sim.total_latency if self.sim else float("nan")

    @property
    def mean_latency(self) -> float:
        return self.sim.mean_latency if self.sim else float("nan")

    @property
    def max_latency(self) -> float:
        return self.sim.max_latency if self.sim else float("nan")

    def devices_for(self, module_name: str) -> list[str]:
        return self.assignments.get(module_name, [])

    def summary(self) -> str:
        lines = [f"plan: routing={self.routing} "
                 f"{'feasible' if self.feasible else 'INFEASIBLE'}"]
        for mod, hosts in sorted(self.assignments.items()):
            lines.append(f"  {mod:24s} -> {', '.join(hosts)}")
        for dev, row in self.memory.items():
            if row["used"]:
                lines.append(
                    f"  mem {dev:12s} {row['used'] / _MB:8.1f} / "
                    f"{row['capacity'] / _MB:.1f} MB")
        lines.append(f"  sharing: {self.shared_bytes / _MB:.1f} MB deployed "
                     f"vs {self.dedicated_bytes / _MB:.1f} MB dedicated "
                     f"({self.sharing_savings:.1%} saved)")
        if self.sim is not None:
            lines.append(f"  predicted latency: mean {self.mean_latency:.3f} s"
                         f"  max {self.max_latency:.3f} s"
                         f"  over {len(self.sim.latencies)} request(s)")
        if self.migrations:
            lines.append(f"  migrations: {self.migrations}")
        return "\n".join(lines)


class Deployment:
    """Facade over registry → placement → routing → execution."""

    def __init__(self, cluster: ClusterSpec, *,
                 registry: ModuleRegistry | None = None):
        self.cluster = cluster
        self.registry = registry or ModuleRegistry()
        self.placement: Placement | None = None
        self.engine = None                     # serving.engine.S2M3Engine
        self.scheduler = None                  # serving.scheduler.ServeScheduler
        self._builders: dict[str, Callable] = {}
        self._placement_name = "greedy"
        self._routing_name = "queue_aware"
        self._plan_opts: dict[str, Any] = {}
        self._workload: list[Request] | None = None
        self._device = None                    # default torch.device of hosts

    @property
    def models(self) -> list[ModelSpec]:
        return list(self.registry.models.values())

    @property
    def materialized(self) -> bool:
        return self.engine is not None

    # -- admission ------------------------------------------------------
    def add_model(self, spec: ModelSpec,
                  builders: dict[str, Callable] | None = None) -> "Deployment":
        """Admit a model.  Before ``materialize()`` this only registers
        it (plan is marked stale); on a live deployment it replans,
        migrates, and hot-loads the new modules immediately."""
        if builders:
            self._builders.update(builders)
        self.registry.add_model(spec)
        if self.engine is None:
            self.placement = None              # stale: next plan() covers it
        else:
            self.replan(self.cluster)
            self.engine.deploy_model(spec, self._builders, self.placement)
        return self

    def evict(self, model_name: str) -> list[str]:
        """Refcounted removal: returns module names actually freed
        (shared modules survive while any referencing model remains).
        Raises ``PlanError`` while the model has requests in flight on
        the serving scheduler — evicting mid-serve would deregister a
        model whose sequences still hold decode rows and KV pages
        (invariant ``registry/refcount-consistent``); drain first."""
        if self.scheduler is not None and \
                model_name in self.scheduler.inflight_models():
            from repro_torch.analysis.diagnostics import (Diagnostic, PlanError,
                                                    Severity)
            d = Diagnostic(
                Severity.ERROR, "invariant/registry/refcount-consistent",
                f"evict({model_name!r}): model has requests in flight on "
                "the serving scheduler; drain before evicting",
                entity=model_name,
                hint="call scheduler.drain() (or let serve() return) "
                     "before evict()")
            raise PlanError(d.message, diagnostics=[d])
        if self.engine is not None:
            freed = self.engine.evict_model(model_name)
        else:
            freed = [m.name for m in self.registry.remove_model(model_name)]
        if self.placement is not None:
            for key in list(self.placement.assignment):
                if key in freed or key.endswith(f"::{model_name}"):
                    self.placement.assignment.pop(key, None)
                    self.placement.module_bytes.pop(key, None)
        return freed

    # -- planning -------------------------------------------------------
    def plan(self, placement: str = "greedy",
             routing: str = "queue_aware", *,
             workload: list[Request] | None = None,
             **opts: Any) -> "Deployment":
        """Run a named placement strategy and pin the routing policy.
        Extra kwargs (``replicate=True``, ``device=...``, ``max_nodes``)
        flow to the strategy."""
        get_routing(routing)                   # fail fast on a bad name
        fn = get_placement(placement)
        if placement == "no_share" and self.engine is not None:
            raise NotImplementedError(
                "cannot re-plan a live deployment with 'no_share': it is a "
                "simulation-only baseline (see materialize())")
        self._placement_name, self._routing_name = placement, routing
        self._plan_opts, self._workload = dict(opts), workload
        self.placement = fn(self.models, self.cluster,
                            workload=workload, **opts)
        if self.engine is not None:
            self._sync_engine()
        return self

    def _ensure_plan(self) -> Placement:
        if self.placement is None:
            fn = get_placement(self._placement_name)
            self.placement = fn(self.models, self.cluster,
                                workload=self._workload, **self._plan_opts)
        return self.placement

    def _module_bytes(self, key: str) -> int:
        pl = self.placement
        if pl is not None and key in pl.module_bytes:
            return pl.module_bytes[key]
        mod = self.registry.modules.get(key)
        return mod.mem_bytes if mod else 0

    def report(self, *, sim: SimResult | None = None,
               migrations: list[tuple[str, str]] | None = None) -> PlanReport:
        """PlanReport for the current plan (memory ledger + sharing
        savings; latency/routes when a SimResult is attached)."""
        pl = self._ensure_plan()
        memory = pl.ledger(
            self.cluster.devices,
            {m: self._module_bytes(m) for m in pl.assignment})
        routes: dict[int, dict[str, str]] = {}
        if sim is not None:
            for e in sim.events:
                if e.kind in ("comp", "head_comp"):
                    routes.setdefault(e.rid, {})[e.module] = e.device
        return PlanReport(
            placement=pl, routing=self._routing_name,
            feasible=pl.feasible and (sim.feasible if sim else True),
            assignments={m: list(h) for m, h in pl.assignment.items()},
            memory=memory,
            shared_bytes=self.registry.shared_bytes(),
            dedicated_bytes=self.registry.dedicated_bytes(),
            sharing_savings=self.registry.sharing_savings(),
            sim=sim, routes=routes, migrations=migrations or [])

    # -- verification ---------------------------------------------------
    def verify(self, *, kernels: bool = False,
               decode_pages: int | None = None,
               page_size: int | None = None,
               model_check: bool = False,
               mc_budget: float = 10.0) -> list:
        """Static pre-flight: run the ``repro_torch.analysis`` plan
        verifier against the current plan (memory ledgers, mapping
        completeness, acyclicity, reachability, refcounts, sharing
        legality, and — when decode knobs are given — generative heads'
        paged-KV page budgets) and, with ``kernels=True``, the Hopper
        launch-plan checker over the zoo's served shapes.
        ``model_check=True`` additionally explores a bounded
        schedule-space model of this deployment's serving state machine
        (``repro_torch.analysis.modelcheck``) under an
        ``mc_budget``-second wall-clock cap, reporting any invariant
        counterexample as an ERROR with its transition script.  Returns
        the ``Diagnostic`` list and raises nothing;
        ``materialize()``/``serve()`` call it and raise ``PlanError``
        when it reports ERRORs."""
        from repro_torch.analysis import verify_deployment

        return verify_deployment(self, kernels=kernels,
                                 decode_pages=decode_pages,
                                 page_size=page_size,
                                 model_check=model_check,
                                 mc_budget=mc_budget)

    def _preflight(self, stage: str, **verify_kwargs) -> None:
        """Gate a device-touching stage on the static verifier: ERROR
        findings raise ``PlanError`` (with the full diagnostic list
        attached), WARNINGs are logged and execution proceeds."""
        import logging

        from repro_torch.analysis.diagnostics import PlanError, errors, warnings

        diags = self.verify(**verify_kwargs)
        log = logging.getLogger("repro_torch.s2m3")
        for d in warnings(diags):
            log.warning("%s pre-flight: %s", stage, d.format())
        errs = errors(diags)
        if errs:
            raise PlanError(
                f"{stage} pre-flight: plan verification failed with "
                f"{len(errs)} error(s):\n"
                + "\n".join(d.format() for d in errs),
                diagnostics=diags)

    # -- prediction -----------------------------------------------------
    def simulate(self, workload: list[Request], *,
                 policy: str | None = None, pipeline: bool = True,
                 coalesce_window: float | None = None,
                 straggler_threshold: float = 0.0) -> PlanReport:
        """Event-driven latency prediction of ``workload`` under the
        current plan; same Request objects that ``submit()`` executes."""
        self._ensure_plan()
        reqs = (coalesce_batches(workload, coalesce_window)
                if coalesce_window is not None else workload)
        sim = simulate(reqs, self.placement, self.cluster, self.models,
                       policy=policy or self._routing_name,
                       pipeline=pipeline,
                       straggler_threshold=straggler_threshold)
        return self.report(sim=sim)

    # -- execution ------------------------------------------------------
    def materialize(self, device_map: dict[str, Any] | None = None, *,
                    device=None) -> "Deployment":
        """Bring the plan to life.  ``device_map`` (placement device name
        -> torch.device) defaults to mapping every placement host onto
        one device: CUDA, unless the caller passes ``device`` (the CPU
        tests pass ``"cpu"``).  Without a CUDA device and without an
        explicit ``device`` this raises.  Hosts a later replan adds are
        backed by the first mapped device.  Routes stay keyed by placement
        name, so ``simulate()`` routes compare with
        ``InferenceResult.devices`` however many hosts share a card."""
        from repro_torch.serving.engine import S2M3Engine, resolve_device

        if self._placement_name == "no_share":
            raise NotImplementedError(
                "placement strategy 'no_share' is a simulation-only "
                "baseline: its model-suffixed assignment keys cannot back "
                "the engine's one-runtime-per-signature store")
        if device_map is None:
            self._device = resolve_device(device)
            device_map = {d.name: self._device for d in self.cluster.devices}
        else:
            self._device = next(iter(device_map.values()))
        self._ensure_plan()
        self._preflight("materialize")
        self.engine = S2M3Engine(device_map, registry=self.registry,
                                 cluster=self.cluster,
                                 routing=self._routing_name)
        self.engine.placement = self.placement
        for model in self.models:
            missing = [m.name for m in model.modules
                       if m.name not in self._builders]
            if missing:
                raise KeyError(
                    f"materialize: no builders for modules {missing} of "
                    f"model {model.name!r}; pass builders to add_model()")
            self.engine.deploy_model(model, self._builders, self.placement)
        return self

    def _require_engine(self):
        if self.engine is None:
            raise RuntimeError(
                "deployment not materialized — call .materialize() first "
                "(simulate() works without it)")
        return self.engine

    def submit(self, request: Request):
        """Execute a Request for real: the engine runs the same model the
        simulator predicted, consuming ``request.inputs``.  Generative
        models (head is ``ModuleSpec.generative``) run the solo
        prefill+decode loop and return their token ids as ``output``."""
        model = self.registry.models[request.model]
        if model.head.generative:
            return self._require_engine().generate(request)
        if request.inputs is None:
            raise ValueError(
                f"request {request.rid} has no inputs payload; submit() "
                "needs Request(inputs={modality: array})")
        return self._require_engine().infer(
            request.model, request.inputs,
            head_extra=request.head_extra, rid=request.rid)

    def infer(self, model_name: str, inputs: dict[str, Any],
              head_extra: dict | None = None):
        return self._require_engine().infer(model_name, inputs, head_extra)

    def serve(self, workload: list[Request], *,
              max_batch: int = 8, max_queue_depth: int = 32,
              admission: str = "block", decode_rows: int = 4,
              decode_pages: int = 64, page_size: int = 16,
              max_seq_len: int = 256, on_finish: Callable | None = None,
              config: Any = None):
        """Drain ``workload`` through the continuous-batching scheduler:
        per-module queues, admission control, and cross-task batch
        coalescing at shared encoders (one encoder launch can serve
        requests from several tasks).  Generative requests (models whose
        head is ``ModuleSpec.generative``) stream through the paged-KV
        decode substrate: admission against a page pool of
        ``decode_pages`` pages of ``page_size`` tokens, up to
        ``decode_rows`` sequences decoding per batched launch;
        ``on_finish`` (if given) is called with each ``InferenceResult``
        as its sequence finishes, i.e. out of admission order.  Returns
        one ``InferenceResult`` per request, in workload order;
        ``self.scheduler`` keeps the queue/batch-occupancy and
        page-occupancy stats of the run (``stats_dict()``), directly
        comparable with ``simulate(coalesce_window=...)``."""
        from repro_torch.serving.scheduler import SchedulerConfig, ServeScheduler

        eng = self._require_engine()
        cfg = config or SchedulerConfig(
            max_batch=max_batch, max_queue_depth=max_queue_depth,
            admission=admission, decode_rows=decode_rows,
            decode_pages=decode_pages, page_size=page_size,
            max_seq_len=max_seq_len)
        self._preflight("serve", decode_pages=cfg.decode_pages,
                        page_size=cfg.page_size)
        self.scheduler = ServeScheduler(eng, config=cfg, on_finish=on_finish)
        return self.scheduler.serve(workload)

    # -- observability --------------------------------------------------
    def trace(self):
        """The ``obs.trace.Trace`` of the last ``serve()`` run (falling
        back to the engine's solo-path tracer): per-request span trees,
        exportable via ``Trace.save()`` as Chrome-trace JSON."""
        if self.scheduler is not None:
            return self.scheduler.tracer.trace
        return self._require_engine().tracer.trace

    def compare(self, workload: list[Request], **serve_kwargs):
        """Drift check: run ``simulate()`` and ``serve()`` on the *same*
        requests and reconcile them — route divergences (simulated
        device != measured device, the plan-level invariant), per-module
        predicted-vs-measured latency ratios, and queue-model error.
        Returns an ``obs.drift.DriftReport``."""
        from repro_torch.obs.drift import compare_deployment

        return compare_deployment(self, workload, **serve_kwargs)

    # -- elasticity -----------------------------------------------------
    def replan(self, new_cluster: ClusterSpec | None = None) -> PlanReport:
        """Re-run the pinned strategy on a changed device pool (paper
        §VI-C).  Live module weights migrate to their new hosts; the
        report lists the migration set (= switching cost)."""
        new_cluster = new_cluster if new_cluster is not None else self.cluster
        fn = get_placement(self._placement_name)

        def place(models, cluster):
            return fn(models, cluster, workload=self._workload,
                      **self._plan_opts)

        old = self.placement if self.placement is not None else Placement()
        new_pl, migrations = core_replan(
            self.models, self.cluster, new_cluster, old, place=place)
        self.cluster, self.placement = new_cluster, new_pl
        if self.engine is not None:
            self.engine.cluster = new_cluster
            self._extend_device_map()
            self._sync_engine()
        return self.report(migrations=migrations)

    def _extend_device_map(self) -> None:
        """A grown cluster brings placement device names the engine has
        never seen; back them with the deployment's device so migrations
        to them actually execute instead of silently no-opping."""
        dm = self.engine.device_map
        for d in self.cluster.devices:
            dm.setdefault(d.name, self._device)

    def _sync_engine(self) -> list[tuple[str, str]]:
        """Align live runtimes with the current placement: re-route every
        module and move the weights that moved."""
        eng = self.engine
        eng.placement = self.placement
        eng.routing = self._routing_name
        moves = []
        for name, rt in eng.runtimes.items():
            host = eng._host_for(name)
            if host and host != rt.host and host in eng.device_map:
                eng.migrate(name, host)
                moves.append((name, host))
        return moves
