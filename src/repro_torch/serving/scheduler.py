"""Continuous-batching serving scheduler: shared *compute*, not just
shared weights.

The paper's §IV-B sharing argument is about deployment cost — one CLIP
text encoder serves VQA, retrieval, and captioning.  This scheduler
extends the argument to execution: requests from *different tasks* that
route through the same module are coalesced into one batched device
call, so a single text-encoder launch serves a VQA request, a retrieval
request, and a captioning request simultaneously.

Architecture
============

* **Per-module request queues.**  ``submit()`` decomposes a
  ``Request`` into one stage per encoder module (head-only models get a
  head stage directly).  Each stage lands in its module's FIFO queue.
* **Admission control / backpressure.**  A queue deeper than
  ``max_queue_depth`` refuses new work: ``admission="block"`` drains
  scheduler steps until the queue recedes (the submitting producer is
  slowed down); ``admission="reject"`` raises ``QueueFull`` so an
  upstream load-balancer can shed.
* **Batch formation.**  Each ``step()`` services the deepest queue —
  the one with the most coalescing opportunity — popping up to
  ``max_batch`` stages whose payloads are stack-compatible (same dtype
  and trailing dims; the leading axis is the batch axis).  The stacked
  call runs once on the routed host and the output is split back
  per-request, so every request's result is the same as its solo
  ``submit()`` (per-example math is independent; only the kernels'
  summation order may differ with the batch size, hence allclose
  rather than bit-equal).
* **Real queue-aware routing.**  The scheduler keeps a per-host
  ``device_free`` occupancy map in *predicted* seconds: after
  dispatching a k-batch of module m to host h it advances h's
  busy-until by ``t_comp(m, h) * batch_factor(k)``.  That map — a
  ``core.routing.QueueSnapshot`` — feeds ``RouteQuery.device_free``,
  so the ``queue_aware`` policy ranks replica hosts by live load
  instead of the engine's always-empty deploy-time queue, and the
  engine's own ``queue_probe`` hook lets deploy/replan-time routing see
  the same state.
* **Heads run per-request** (their inputs are modality-keyed dicts plus
  request-specific ``head_extra`` kwargs — stacking them would change
  semantics), but they still flow through module queues so the stats
  cover the whole pipeline.
* **Generative heads stream through the paged-KV decode substrate.**
  Models whose head is ``ModuleSpec.generative`` don't get a head
  stage: once their encoder stages finish, the request enters the
  head's ``DecodeStream`` (serving.decode) — admission against the page
  pool, batch-1 prefill, then continuous batched decoding where every
  live sequence (across tasks) shares one ``paged_decode_attention``
  launch per step.  The stream's depth participates in the same
  backpressure and deepest-queue servicing as encoder queues, and its
  launches charge the decoder host's occupancy map so ``queue_aware``
  routing sees decode traffic too.

Batching model vs. the paper's footnote-4 fit
=============================================

The paper models a batched module call as
``t(k) = t(1) * (0.684 + 0.316 k)`` — the linear fit of its footnote-4
measurements (1.28 s / 4.90 s / 9.16 s at batch 1/10/20): a fixed
launch cost amortized over k requests, with per-request marginal cost
~0.316 t(1).  This scheduler *realizes* that regime — one launch per
formed batch — and reuses the same ``batch_factor(k)`` fit for its
occupancy predictions, so the simulator's batched-latency predictions
and the scheduler's routing estimates speak one language and the
emitted queue/batch-occupancy stats are directly checkable against
``simulate(coalesce_window=...)`` runs.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.core.routing import QueueSnapshot, Request, batch_factor
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serving.decode import DecodeStream
from repro_torch.serving.engine import InferenceResult, S2M3Engine, sync


class QueueFull(RuntimeError):
    """Admission refused: a module queue is at ``max_queue_depth`` and
    the scheduler was configured with ``admission="reject"``."""


@dataclass(frozen=True)
class SchedulerConfig:
    max_batch: int = 8            # stages per formed module batch
    max_queue_depth: int = 32     # per-module admission limit
    admission: str = "block"      # "block" (drain) | "reject" (QueueFull)
    # paged-KV decode substrate (per generative head module)
    decode_rows: int = 4          # concurrent sequences per decode batch
    decode_pages: int = 64        # KV page pool size (incl. 1 dummy page)
    page_size: int = 16           # tokens per KV page
    max_seq_len: int = 256        # prefix + prompt + max_new_tokens cap
    # evaluate the runtime subset of repro_torch.analysis.invariants after
    # every scheduler step while draining (PlanError on violation);
    # cheap at serving scale, disable for microbenchmarks
    debug_invariants: bool = True

    def __post_init__(self):
        if self.max_batch < 1 or self.max_queue_depth < 1:
            raise ValueError("max_batch and max_queue_depth must be >= 1")
        if self.admission not in ("block", "reject"):
            raise ValueError(f"unknown admission mode {self.admission!r}")
        if self.decode_rows < 1 or self.page_size < 1 or self.max_seq_len < 1:
            raise ValueError(
                "decode_rows, page_size and max_seq_len must be >= 1")
        n_max = -(-self.max_seq_len // self.page_size)
        if self.decode_pages < n_max + 1:
            raise ValueError(
                f"decode_pages={self.decode_pages} cannot hold one "
                f"max_seq_len={self.max_seq_len} sequence ({n_max} pages) "
                "plus the dummy page")


#: legacy per-module stats_dict() keys, now a compatibility view over
#: the serve.* instruments in ``ServeScheduler.metrics``
STAT_KEYS = ("module", "calls", "stages", "mean_occupancy", "max_batch",
             "cross_task_batches", "max_depth")


@dataclass
class _Stage:
    rid: int
    module: str
    request: Request
    x: Any = None                         # encoder payload (None for heads)
    wait_sid: int = -1                    # queue-wait span (admission)


@dataclass
class _Picked:
    """A step's module call, formed in ``s2m3.sched.pick``: the batch
    popped at ``t_pop``, the host it is routed to and, for a head call,
    its request's in-flight record (taken out of ``inflight``)."""

    batch: list
    t_pop: float
    host: str | None
    fl: Any = None


@dataclass
class _InFlight:
    request: Request
    t_admit: float
    pending: set[str]                     # encoder module names outstanding
    root_sid: int = -1                    # the request's root trace span
    enc_outputs: dict[str, Any] = field(default_factory=dict)
    devices: dict[str, str] = field(default_factory=dict)
    timeline: list = field(default_factory=list)


class ServeScheduler:
    """Continuous-batching core over a live ``S2M3Engine``."""

    def __init__(self, engine: S2M3Engine, *,
                 config: SchedulerConfig | None = None, on_finish=None,
                 tracer: Tracer | None = None):
        self.engine = engine
        self.cfg = config or SchedulerConfig()
        # streaming hook: called with each InferenceResult as its
        # sequence finishes (generative requests finish out of admission
        # order — shorter decodes stream back first)
        self.on_finish = on_finish
        self.queues: dict[str, deque[_Stage]] = {}
        self.decode: dict[str, DecodeStream] = {}
        self.inflight: dict[int, _InFlight] = {}
        self.results: dict[int, InferenceResult] = {}
        self._free_at: dict[str, float] = {}   # host -> predicted busy-until
        self._epoch = time.perf_counter()
        # fresh per-scheduler registry: stats_dict() stays zeroed until
        # this scheduler actually serves (dep.serve() builds one per call)
        self.metrics = MetricsRegistry()
        # its own tracer also records the collector's pauses (gc spans)
        self.tracer = tracer or Tracer(clock=self._now, gc=True)
        # guards queues/inflight/results/_free_at; RLock so a
        # blocked submit() may re-enter through step().  Discipline
        # (enforced by repro_torch.analysis.concurrency_lint): mutate shared
        # state only under the lock; never dispatch device work while
        # holding it.
        self._lock = threading.RLock()
        # the engine's routing now sees real queues, not empty ones
        engine.queue_probe = self.snapshot

    # -- introspection --------------------------------------------------
    def _now(self) -> float:
        return time.perf_counter() - self._epoch

    def snapshot(self) -> QueueSnapshot:
        with self._lock:
            return QueueSnapshot(
                t=self._now(),
                device_free=tuple(sorted(self._free_at.items())),
                depths=tuple(sorted((m, len(q))
                                    for m, q in self.queues.items())))

    def queue_depths(self) -> dict[str, int]:
        with self._lock:
            depths = {m: len(q) for m, q in self.queues.items() if q}
            streams = dict(self.decode)
        for m, stream in streams.items():
            d = stream.depth()
            if d:
                depths[m] = depths.get(m, 0) + d
        return depths

    def _module_row(self, module: str) -> dict[str, Any]:
        mt = self.metrics
        occ = mt.get("serve.batch_occupancy", module=module)
        return {
            "module": module,
            "calls": int(mt.value("serve.calls", module=module)),
            "stages": int(mt.value("serve.stages", module=module)),
            "mean_occupancy": round(occ.mean, 3) if occ is not None else 0.0,
            "max_batch": int(occ.max) if occ is not None else 0,
            "cross_task_batches": int(
                mt.value("serve.cross_task_batches", module=module)),
            "max_depth": int(mt.value("serve.max_depth", module=module)),
        }

    def stats_dict(self) -> dict[str, dict[str, Any]]:
        """Stable-schema stats: one row per deployed module (plus any
        queue that ever formed), all counter keys present and zeroed
        even before the first ``serve()``/``step()``.  A compatibility
        view over the ``serve.*`` instruments in ``self.metrics``.
        Generative head rows additionally carry the decode-substrate
        counters and page-occupancy keys from their ``DecodeStream``."""
        names = set(self.engine.registry.modules)
        names.update(self.metrics.label_values("serve.max_depth", "module"))
        names.update(self.metrics.label_values("serve.calls", "module"))
        with self._lock:
            streams = dict(self.decode)
        rows = {m: self._module_row(m) for m in sorted(names)}
        for m, stream in streams.items():
            rows.setdefault(m, self._module_row(m))
            rows[m].update(stream.stats_dict())
        return rows

    @property
    def cross_task_batches(self) -> int:
        return int(self.metrics.total("serve.cross_task_batches"))

    @property
    def cross_task_decode_batches(self) -> int:
        """Batched decode steps whose live rows spanned >= 2 models —
        the generative analogue of ``cross_task_batches``."""
        with self._lock:
            streams = dict(self.decode)
        return sum(s.cross_task_decode_batches for s in streams.values())

    # -- runtime invariants ---------------------------------------------
    def inflight_models(self) -> set[str]:
        """Model names with requests currently in flight (queued,
        encoding, or decoding) — what ``Deployment.evict()`` consults
        before deregistering a model out from under its requests."""
        with self._lock:
            return {fl.request.model for fl in self.inflight.values()}

    def check_invariants(self, *, raise_on_violation: bool = True):
        """Evaluate the runtime subset of the shared invariant catalog
        (``repro_torch.analysis.invariants``) against live serving state:
        every decode stream's page/row/reservation accounting plus
        registry refcount consistency against the in-flight set.  The
        same predicates the model checker exhausts over the schedule
        space — one catalog, three enforcement layers."""
        from repro_torch.analysis.diagnostics import Diagnostic, PlanError, Severity
        from repro_torch.analysis.invariants import StateView, check_state

        violations: list[tuple[str, str]] = []
        with self._lock:
            streams = dict(self.decode)
        for module, stream in streams.items():
            for name, msg in check_state(stream.state_view(),
                                         where="runtime"):
                violations.append((name, f"decode[{module}]: {msg}"))
        registry = self.engine.registry
        models = registry.models
        module_models = {
            mod: tuple(sorted(mdl.name for mdl in models.values()
                              if mod in {m.name for m in mdl.modules}))
            for mod in registry.modules}
        view = StateView(
            refcounts={mod: registry.refcount(mod)
                       for mod in registry.modules},
            module_models=module_models,
            inflight_models=tuple(sorted(self.inflight_models())),
            registered_models=tuple(sorted(models)))
        violations += [(n, f"registry: {m}")
                       for n, m in check_state(view, where="runtime")]
        if violations and raise_on_violation:
            diags = [Diagnostic(Severity.ERROR, f"invariant/{name}", msg,
                                entity="ServeScheduler")
                     for name, msg in violations]
            raise PlanError(
                "runtime invariant violation while serving:\n"
                + "\n".join(d.format() for d in diags), diagnostics=diags)
        return violations

    # -- admission ------------------------------------------------------
    def submit(self, request: Request) -> None:
        """Admit one request: split into per-module stages and enqueue,
        applying backpressure when a target queue is at depth.
        Generative models skip the head queue — after their encoders
        finish they enter the head's paged decode stream instead."""
        with self.tracer.scope("s2m3.sched.submit"):
            model = self.engine.registry.models[request.model]
            if model.encoders and request.inputs is None:
                raise ValueError(
                    f"request {request.rid} has no inputs payload; serving "
                    "needs Request(inputs={modality: array})")
            stream = None
            if model.head.generative:
                stream = self._ensure_stream(model.head.name)
                stream.validate(request)  # fail fast, before encoder admit
            root = self.tracer.begin("request", "request", rid=request.rid,
                                     model=request.model)
            targets = [m.name for m in model.encoders] + [model.head.name]
            blocked = any(self._at_depth(t) for t in targets)
        if blocked:
            # outside the scope: the steps that drain have their own
            try:
                self._backpressure(targets)
            except QueueFull:
                self.tracer.end(root, rejected=True)
                raise
        with self.tracer.scope("s2m3.sched.submit"):
            fl = _InFlight(request, self._now(),
                           pending={m.name for m in model.encoders},
                           root_sid=root)
            with self._lock:
                self.inflight[request.rid] = fl
            if model.encoders:
                for enc in model.encoders:
                    self._enqueue(_Stage(request.rid, enc.name, request,
                                         x=request.inputs[enc.modality]))
            elif stream is not None:
                # head-only generative: any inputs payload carries
                # precomputed modality features (e.g. VLM image embeds)
                stream.submit(request.rid, request,
                              dict(request.inputs or {}), parent=root)
            else:
                self._enqueue(_Stage(request.rid, model.head.name, request))

    def _backpressure(self, targets: list[str]) -> None:
        """Drain steps while a target queue is at depth (``block``), or
        refuse the request (``reject``)."""
        for t in targets:
            while self._at_depth(t):
                if self.cfg.admission == "reject":
                    raise QueueFull(
                        f"module queue {t!r} at max_queue_depth="
                        f"{self.cfg.max_queue_depth}")
                if not self.step():
                    break             # nothing serviceable: admit anyway

    def _ensure_stream(self, module: str) -> DecodeStream:
        with self._lock:
            stream = self.decode.get(module)
        if stream is None:
            # paged-cache allocation is device work: build outside the lock
            stream = DecodeStream(
                self.engine, module, rows=self.cfg.decode_rows,
                n_pages=self.cfg.decode_pages, page_size=self.cfg.page_size,
                max_seq_len=self.cfg.max_seq_len, now=self._now,
                tracer=self.tracer, metrics=self.metrics)
            with self._lock:
                stream = self.decode.setdefault(module, stream)
        return stream

    def _at_depth(self, module: str) -> bool:
        with self._lock:
            depth = len(self.queues.get(module, ()))
            stream = self.decode.get(module)
        if stream is not None:
            depth += stream.depth()
        return depth >= self.cfg.max_queue_depth

    def _enqueue(self, stage: _Stage) -> None:
        with self._lock:
            q = self.queues.setdefault(stage.module, deque())
            q.append(stage)
            depth = len(q)
            root = self.inflight[stage.rid].root_sid
        stage.wait_sid = self.tracer.begin(stage.module, "admission",
                                           rid=stage.rid, parent=root)
        self.metrics.gauge("serve.max_depth",
                           module=stage.module).track_max(depth)

    # -- scheduling -----------------------------------------------------
    def step(self) -> bool:
        """Service the deepest non-empty queue (most coalescing
        opportunity); decode streams compete on waiting + live depth.
        Returns False when there is nothing to do.

        Each phase of a step is a host scope of the tracer
        (``s2m3.<part>.<phase>``): ``sched.pick`` (the depth scan, the
        batch and its host), then the call's own ``dispatch``, ``wait``
        or ``read``, and ``retire`` scopes.  They follow one another and
        never nest, so a profile names each gap by its phase."""
        with self.tracer.scope("s2m3.sched.pick"):
            with self._lock:
                depths = {m: len(q) for m, q in self.queues.items() if q}
                streams = dict(self.decode)
            for m, stream in streams.items():
                d = stream.depth()
                if d:
                    depths[m] = depths.get(m, 0) + d
            module = max(depths, key=lambda m: depths[m], default=None)
            if module is None:
                return False
            picked = self._pick(module)
        if isinstance(picked, DecodeStream):
            self._service_decode(module, picked)
        elif picked is not None and picked.fl is None:
            self._run_encoder_batch(module, picked)
        elif picked is not None:
            self._run_head(module, picked)
        return True

    def drain(self) -> dict[int, InferenceResult]:
        """Run until no queue has work; returns a consistent snapshot of
        the results (the live dict keeps changing under concurrent
        submitters).  With ``cfg.debug_invariants`` every step is
        followed by a runtime evaluation of the shared invariant
        catalog (page conservation, reservation soundness, refcounts) —
        the same predicates the model checker exhausts offline."""
        while self.step():
            if self.cfg.debug_invariants:
                self.check_invariants()
        if self.cfg.debug_invariants:
            self.check_invariants()
        with self._lock:
            return dict(self.results)

    def serve(self, workload: list[Request]) -> list[InferenceResult]:
        """Drain a whole workload: admit in arrival order (backpressure
        included), run to completion, return results in workload order."""
        for q in sorted(workload, key=lambda r: (r.arrival, r.rid)):
            self.submit(q)
        results = self.drain()
        return [results[q.rid] for q in workload]

    # -- execution ------------------------------------------------------
    def _pick(self, module: str) -> DecodeStream | _Picked | None:
        """The module's work for this step: its decode stream, or its
        batch popped from the queue, the admission spans ended."""
        with self._lock:
            stream = self.decode.get(module)
        if stream is not None:
            return stream
        spec = self.engine.registry.modules.get(module)
        is_encoder = spec is not None and spec.kind == "encoder"
        # form the batch under the lock; dispatch outside it
        with self._lock:
            q = self.queues.get(module)
            if not q:
                return None
            head = q.popleft()
            batch = [head]
            if is_encoder:
                skipped = []
                sig = self._shape_sig(head.x)
                while q and len(batch) < self.cfg.max_batch:
                    s = q.popleft()
                    if sig is not None and self._shape_sig(s.x) == sig:
                        batch.append(s)
                    else:
                        skipped.append(s)  # incompatible payload: stays FIFO
                q.extendleft(reversed(skipped))
        t_pop = self._now()
        for s in batch:
            if s.wait_sid >= 0:
                self.tracer.end(s.wait_sid, t1=t_pop)
        if is_encoder:
            return _Picked(batch, t_pop, self._route(module, head))
        with self._lock:
            fl = self.inflight.pop(head.rid)
        return _Picked(batch, t_pop, self._route(module, head), fl)

    @staticmethod
    def _shape_sig(x) -> tuple | None:
        """Stack-compatibility signature: leading axis is the batch
        axis, everything else must match."""
        if not hasattr(x, "shape") or not hasattr(x, "dtype"):
            return None
        if len(x.shape) < 1:
            return None
        return (x.shape[1:], str(x.dtype))

    def _route(self, module: str, stage: _Stage) -> str | None:
        # _charge() writes _free_at under the lock from concurrent
        # drains; route against a consistent snapshot, not the live map
        with self._lock:
            device_free = dict(self._free_at)
        return self.engine.route_module(
            module, device_free=device_free, ready_time=self._now(),
            source=stage.request.source, request=stage.request)

    def _charge(self, module: str, host: str | None, k: int,
                t_dispatch: float) -> None:
        """Advance the host's predicted busy-until by the footnote-4
        batched-call estimate — the scheduler-side mirror of the
        simulator's device_free bookkeeping."""
        eng = self.engine
        spec = eng.registry.modules.get(module)
        if host is None or eng.cluster is None or spec is None:
            return
        try:
            dev = eng.cluster.device(host)
        except KeyError:
            return
        t_est = eng.cluster.t_comp(spec, dev) * batch_factor(k)
        with self._lock:
            self._free_at[host] = max(self._free_at.get(host, 0.0),
                                      t_dispatch) + t_est

    def _bookkeep(self, module: str, batch: list[_Stage]) -> None:
        mt = self.metrics
        mt.counter("serve.calls", module=module).inc()
        mt.counter("serve.stages", module=module).inc(len(batch))
        mt.histogram("serve.batch_occupancy", module=module).observe(
            len(batch))
        if len({s.request.model for s in batch}) >= 2:
            mt.counter("serve.cross_task_batches", module=module).inc()

    def _finish_metrics(self, result: InferenceResult,
                        request: Request) -> None:
        """Per-task latency histogram + SLO hit/miss — what powers
        ``obs.summary.slo_summary``."""
        mt = self.metrics
        mt.histogram("request.latency_s", model=result.model).observe(
            result.latency_s)
        if request.slo_deadline is not None:
            met = result.latency_s <= request.slo_deadline
            mt.counter("slo.hit" if met else "slo.miss",
                       model=result.model).inc()

    def _run_encoder_batch(self, module: str, picked: _Picked) -> None:
        batch, t_pop, host = picked.batch, picked.t_pop, picked.host
        scope = self.tracer.scope
        with scope("s2m3.encode.dispatch") as disp:
            if len(batch) == 1:
                out, used = self.engine.apply_module(module, batch[0].x,
                                                     host=host)
                outs = [out]
            else:
                xs = [torch.as_tensor(s.x) for s in batch]
                out, used = self.engine.apply_module(
                    module, torch.cat(xs, dim=0), host=host)
                # views of one launch's output: no copy
                outs = torch.split(out, [x.shape[0] for x in xs], dim=0)
            self._charge(module, used, len(batch), disp.t0)
            self._bookkeep(module, batch)
        # the encode span ends when the device has run the batch, not
        # when it was enqueued (CUDA launches return at once)
        with scope("s2m3.encode.wait") as wait:
            sync(out.device)
        with scope("s2m3.encode.retire"):
            t0, t1 = disp.t0, wait.t1
            modality = self.engine.registry.modules[module].modality
            models = sorted({s.request.model for s in batch})
            # per-request bookkeeping under the lock: two encoder batches
            # finishing concurrently for the same request must not both
            # see an empty pending set and double-enqueue the head.  Ready
            # heads are collected and submitted after release (stream
            # construction and head enqueue do their own locking).
            ready: list[tuple[_Stage, dict[str, Any], int]] = []
            for s, o in zip(batch, outs):
                if len(batch) > 1 and self.engine.registry.models[
                        s.request.model].head.generative:
                    # a generative request holds its output until it
                    # finishes: as a view it would hold its batch's whole
                    # output (dots.vlm1's merger: 29 MB a request, 235 MB
                    # a batch of 8) as long as the batch's longest answer
                    o = o.clone()
                with self._lock:
                    fl = self.inflight[s.rid]
                    root = fl.root_sid
                self.tracer.record(module, "batch", t_pop, t0, rid=s.rid,
                                   parent=root, batch=len(batch),
                                   models=models)
                span = self.tracer.record(
                    module, "encode", t0, t1, rid=s.rid, parent=root,
                    host=used, batch=len(batch), models=models,
                    cross_task=len(models) >= 2, dispatch_s=disp.dur,
                    syncs=1)
                with self._lock:
                    fl.enc_outputs[modality] = o
                    if used:
                        fl.devices[module] = used
                    fl.timeline.append(span)
                    fl.pending.discard(module)
                    if not fl.pending:
                        ready.append((s, dict(fl.enc_outputs), root))
            for s, enc_outputs, root in ready:
                head = self.engine.registry.models[s.request.model].head
                if head.generative:
                    stream = self._ensure_stream(head.name)
                    stream.submit(s.rid, s.request, enc_outputs,
                                  parent=root)
                else:
                    self._enqueue(_Stage(s.rid, head.name, s.request))

    def _service_decode(self, module: str, stream: DecodeStream) -> None:
        """One decode-stream service round: admissions + one batched
        decode step, then results for the sequences that finished."""
        report = stream.tick()
        with self.tracer.scope("s2m3.decode.retire"):
            host = self.engine.decoder_runtime(module).host
            if report.decode_batch:
                self._charge(module, host, report.decode_batch, self._now())
            for seq in report.finished:
                with self._lock:
                    fl = self.inflight.pop(seq.rid)
                fl.timeline.extend(seq.timeline)
                if host:
                    fl.devices[module] = host
                enc = dict(fl.enc_outputs)
                t_end = self._now()
                result = InferenceResult(
                    model=seq.request.model,
                    output=np.asarray(seq.tokens, np.int32),
                    encoder_outputs=enc, timeline=fl.timeline,
                    latency_s=t_end - fl.t_admit, devices=fl.devices,
                    rid=seq.rid)
                self.tracer.end(fl.root_sid, t1=t_end,
                                n_tokens=len(seq.tokens))
                self._finish_metrics(result, seq.request)
                with self._lock:
                    self.results[seq.rid] = result
                if self.on_finish is not None:
                    self.on_finish(result)

    def _run_head(self, module: str, picked: _Picked) -> None:
        stage, fl, t_pop = picked.batch[0], picked.fl, picked.t_pop
        scope = self.tracer.scope
        with scope("s2m3.head.dispatch") as disp:
            out, used = self.engine.apply_head(
                module, fl.enc_outputs, stage.request.head_extra,
                host=picked.host)
            self._charge(module, used, 1, disp.t0)
            self._bookkeep(module, [stage])
        with scope("s2m3.head.wait") as wait:
            sync(out.device)
        with scope("s2m3.head.retire"):
            t0, t1 = disp.t0, wait.t1
            self.tracer.record(module, "batch", t_pop, t0, rid=stage.rid,
                               parent=fl.root_sid, batch=1)
            span = self.tracer.record(module, "head", t0, t1,
                                      rid=stage.rid, parent=fl.root_sid,
                                      host=used, dispatch_s=disp.dur,
                                      syncs=1)
            if used:
                fl.devices[module] = used
            fl.timeline.append(span)
            result = InferenceResult(
                model=stage.request.model, output=out,
                encoder_outputs=fl.enc_outputs, timeline=fl.timeline,
                latency_s=t1 - fl.t_admit, devices=fl.devices,
                rid=stage.rid)
            self.tracer.end(fl.root_sid, t1=t1)
            self._finish_metrics(result, stage.request)
            with self._lock:
                self.results[stage.rid] = result
            if self.on_finish is not None:
                self.on_finish(result)


def lm_scheduler(bundle, params, *, device=None,
                 config: SchedulerConfig | None = None,
                 on_finish=None) -> ServeScheduler:
    """Single-bundle convenience: wrap one LM ``ModelBundle`` as a
    head-only generative model ("lm") on a bare engine and return a
    ``ServeScheduler`` serving it through the paged decode substrate.
    ``device`` defaults to CUDA (see ``engine.resolve_device``).
    Submit ``Request(model="lm", prompt=..., ...)``; precomputed
    modality features (VLM image embeds) go in ``inputs``."""
    from repro_torch.core.module import ModelSpec, ModuleSpec
    from repro_torch.serving.engine import resolve_device

    name = getattr(bundle.cfg, "name", "lm-head")
    head = ModuleSpec(name, "head", "task", bundle.param_count(),
                      generative=True)
    model = ModelSpec("lm", "generation", (), head)
    engine = S2M3Engine({"dev0": resolve_device(device)})
    engine.deploy_model(model, {name: (lambda: (bundle, params))})
    return ServeScheduler(engine, config=config, on_finish=on_finish)
