"""Per-request parallel routing + event-driven latency simulator (§V).

Faithful to Eq. (1)–(3): a request's encoders run in parallel on their
chosen devices; encoder latency is the max over modalities of
(input comm + compute + output comm to the head device); the head runs
after all encoder outputs arrive.  Routing follows Eq. (7): each module
goes to the *hosting* device with minimal compute time ("paper" policy).
The "queue-aware" policy (beyond-paper) picks the device minimizing
predicted completion including queueing — used as an optimized variant
in benchmarks.

Modeling choices that mirror the testbed:
* devices execute one module call at a time (capacity a_{m,n} = serial);
* input sends serialize on the requester's uplink, and the paper's
  longest-encoder-first dispatch order is applied;
* pipelining: the next request may start as soon as modules free up;
* optional module-level batching (§VI-C): requests for the same module
  merge into one call with t(k) = t(1) * (0.684 + 0.316 k), the linear
  fit of the paper's footnote-4 measurements (1.28s/4.90s/9.16s for
  batch 1/10/20).
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any

from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.module import ModelSpec
from repro_torch.core.placement import Placement

BATCH_A, BATCH_B = 0.684, 0.316


def batch_factor(k: int) -> float:
    return BATCH_A + BATCH_B * k if k > 1 else 1.0


@dataclass(frozen=True)
class Request:
    """Unified request: drives both the latency simulator and the live
    engine (s2m3.Deployment.simulate / .submit).  The sim reads the
    scheduling fields; the engine additionally consumes ``inputs`` /
    ``head_extra`` payloads, which are excluded from equality."""

    rid: int
    model: str
    source: str
    arrival: float = 0.0
    batch: int = 1
    # per-modality work multiplicity, e.g. {"text": 100} for a retrieval
    # request carrying 100 candidate prompts (see core.profiles)
    work: tuple[tuple[str, float], ...] = ()
    # live-execution payloads: modality -> array, and head kwargs
    inputs: Any = field(default=None, compare=False, repr=False)
    head_extra: Any = field(default=None, compare=False, repr=False)
    # generative requests (models whose head is ModuleSpec.generative):
    # prompt token ids plus decode controls.  The scheduler streams such
    # requests through the paged-KV decode substrate.
    prompt: tuple[int, ...] | None = None
    max_new_tokens: int = 16
    temperature: float = 0.0      # <= 0: greedy (deterministic)
    eos_id: int = -1              # -1: never stop early
    slo_deadline: float | None = None   # seconds from admit; orders admission

    def work_of(self, modality: str) -> float:
        for k, v in self.work:
            if k == modality:
                return v
        return 1.0


def work_multiplier(req: "Request", modality: str, device) -> float:
    """1 + (work-1)*rho: device-dependent marginal cost of extra queries."""
    w = req.work_of(modality)
    rho = getattr(device, "extra_work_factor", 1.0)
    return 1.0 + (w - 1.0) * rho


@dataclass(frozen=True)
class QueueSnapshot:
    """Live queue state, shared language between the serving scheduler
    and the routing policies.  ``device_free`` is the same device ->
    predicted-busy-until mapping the event simulator threads through
    ``RouteQuery.device_free`` — but observed from a *real* scheduler,
    so ``queue_aware`` routing ranks replica hosts by actual load
    instead of the engine's always-empty deploy-time queue.  ``depths``
    adds per-module queued-stage counts for stats/backpressure
    introspection."""

    t: float                                  # observation time (s, scheduler epoch)
    device_free: tuple[tuple[str, float], ...] = ()
    depths: tuple[tuple[str, int], ...] = ()

    def free_map(self) -> dict[str, float]:
        return dict(self.device_free)

    def depth_of(self, module: str) -> int:
        return dict(self.depths).get(module, 0)


@dataclass(frozen=True)
class Event:
    rid: int
    module: str
    device: str
    kind: str       # comm_in | comp | comm_out | head_comp
    start: float
    end: float


@dataclass
class SimResult:
    latencies: dict[int, float] = field(default_factory=dict)
    events: list[Event] = field(default_factory=list)
    feasible: bool = True

    @property
    def total_latency(self) -> float:
        if not self.feasible:
            return float("inf")
        return sum(self.latencies.values())

    @property
    def mean_latency(self) -> float:
        if not self.feasible or not self.latencies:
            return float("inf")
        return self.total_latency / len(self.latencies)

    @property
    def max_latency(self) -> float:
        if not self.feasible:
            return float("inf")
        # a feasible empty workload has no latency, not an infinite one
        return max(self.latencies.values(), default=0.0)


def _pick_device(module, hosts, cluster, device_free, ready_time,
                 policy: str, source: str, req: "Request"):
    if not hosts:
        return None
    # routing policies are named, registered callables (s2m3.policies);
    # imported lazily so core stays importable on its own
    from repro_torch.s2m3.policies import RouteQuery, get_routing

    return get_routing(policy)(RouteQuery(
        module=module, hosts=tuple(hosts), cluster=cluster, source=source,
        request=req, ready_time=ready_time, device_free=device_free))


def simulate(
    requests: list[Request],
    placement: Placement,
    cluster: ClusterSpec,
    models: list[ModelSpec],
    *,
    policy: str = "paper",
    pipeline: bool = True,
    straggler_threshold: float = 0.0,   # >0: skip devices with EWMA > k*median
) -> SimResult:
    by_name = {m.name: m for m in models}
    device_free: dict[str, float] = {}
    uplink_free: dict[str, float] = {}
    res = SimResult()
    serial_clock = 0.0   # without pipelining, requests strictly serialize

    for q in sorted(requests, key=lambda r: (r.arrival, r.rid)):
        mdl = by_name[q.model]
        start0 = q.arrival if pipeline else max(q.arrival, serial_clock)

        # --- choose devices (Eq. 7) ---
        chosen: dict[str, str] = {}
        for m in mdl.modules:
            hosts = list(placement.devices_for(m.name))
            if straggler_threshold > 0 and len(hosts) > 1:
                import statistics

                med = statistics.median(device_free.get(h, 0.0) for h in hosts)
                hosts = [h for h in hosts
                         if device_free.get(h, 0.0) <= straggler_threshold * med
                         or device_free.get(h, 0.0) == 0.0] or hosts
            dev = _pick_device(m, hosts, cluster, device_free, start0,
                               policy, q.source, q)
            if dev is None:
                res.feasible = False
                return res
            chosen[m.name] = dev

        head_dev = chosen[mdl.head.name]

        # --- encoders in parallel; source uplink serializes sends,
        #     longest-encoding modality dispatched first ---
        enc_order = sorted(
            mdl.encoders,
            key=lambda m: -cluster.t_comp(m, cluster.device(chosen[m.name]))
            * work_multiplier(q, m.modality, cluster.device(chosen[m.name])),
        )
        enc_out_arrival = []
        up_free = max(uplink_free.get(q.source, 0.0), start0)
        for m in enc_order:
            dname = chosen[m.name]
            dev = cluster.device(dname)
            t_in = cluster.t_comm(q.source, dname, m.input_bytes * q.batch)
            send_start = up_free
            send_end = send_start + t_in
            up_free = send_end if dname != q.source else send_start
            comp_start = max(send_end, device_free.get(dname, 0.0))
            t_comp = cluster.t_comp(m, dev) * batch_factor(q.batch) \
                * work_multiplier(q, m.modality, dev)
            comp_end = comp_start + t_comp
            device_free[dname] = comp_end
            t_out = cluster.t_comm(dname, head_dev, m.output_bytes * q.batch)
            enc_out_arrival.append(comp_end + t_out)
            res.events += [
                Event(q.rid, m.name, dname, "comm_in", send_start, send_end),
                Event(q.rid, m.name, dname, "comp", comp_start, comp_end),
                Event(q.rid, m.name, head_dev, "comm_out", comp_end,
                      comp_end + t_out),
            ]
        uplink_free[q.source] = up_free

        # head-only models: the source ships the raw input to the head;
        # the send contends on the same uplink the encoder sends use
        if not mdl.encoders:
            t_in = cluster.t_comm(q.source, head_dev,
                                  mdl.head.input_bytes * q.batch)
            send_start = up_free
            send_end = send_start + t_in
            up_free = send_end if head_dev != q.source else send_start
            uplink_free[q.source] = up_free
            enc_out_arrival.append(send_end)
            res.events.append(
                Event(q.rid, mdl.head.name, head_dev, "comm_in",
                      send_start, send_end))

        # --- task head (Eq. 3) ---
        ready = max(enc_out_arrival) if enc_out_arrival else start0
        h_start = max(ready, device_free.get(head_dev, 0.0))
        t_head = cluster.t_comp(mdl.head, cluster.device(head_dev)) \
            * batch_factor(q.batch)
        h_end = h_start + t_head
        device_free[head_dev] = h_end
        res.events.append(
            Event(q.rid, mdl.head.name, head_dev, "head_comp", h_start, h_end))

        res.latencies[q.rid] = h_end - start0
        serial_clock = h_end
    return res


def _merge_work(a: tuple[tuple[str, float], ...],
                b: tuple[tuple[str, float], ...]) -> tuple[tuple[str, float], ...]:
    """Merged request keeps the worst-case per-modality multiplicity: the
    batched module call must still run every candidate prompt."""
    acc = dict(a)
    for k, v in b:
        acc[k] = max(acc.get(k, 1.0), v)
    return tuple(sorted(acc.items()))


def coalesce_batches(requests: list[Request], window: float = 0.0
                     ) -> list[Request]:
    """Module-level batching (§VI-C): merge same-model requests whose
    arrivals fall within `window` into one batched request.

    Requests carrying live-execution payloads (``inputs`` /
    ``head_extra``) are never merged: a merged Request keeps only one
    payload, so coalescing them would silently drop the others' data
    when the result is fed to ``submit()``.  Payload batching is the
    serving scheduler's job (serving.scheduler), which stacks the
    arrays instead of discarding them.
    """
    out: list[Request] = []
    pend: dict[str, Request] = {}
    for q in sorted(requests, key=lambda r: r.arrival):
        if q.inputs is not None or q.head_extra is not None:
            out.append(q)                     # payload-carrying: never merge
            continue
        cur = pend.get(q.model)
        if cur is not None and q.arrival - cur.arrival <= window:
            pend[q.model] = replace(cur, batch=cur.batch + q.batch,
                                    work=_merge_work(cur.work, q.work))
        else:
            if cur is not None:
                out.append(cur)
            pend[q.model] = q
    out.extend(pend.values())
    return sorted(out, key=lambda r: (r.arrival, r.rid))


def timeline_ascii(result: SimResult, width: int = 72) -> str:
    """Fig.-3-style ASCII timeline of the event trace."""
    if not result.events:
        return "(no events)"
    t1 = max(e.end for e in result.events) or 1.0
    rows = []
    for e in result.events:
        a = int(e.start / t1 * width)
        b = max(a + 1, int(e.end / t1 * width))
        bar = " " * a + {"comm_in": "~", "comp": "#", "comm_out": ">",
                         "head_comp": "H"}[e.kind] * (b - a)
        rows.append(f"r{e.rid:<3}{e.module[:18]:<19}{e.device[:8]:<9}|{bar}")
    return "\n".join(rows)
