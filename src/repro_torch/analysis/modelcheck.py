"""Explicit-state model checker for the serving stack's schedule space.

``tests/`` can only witness the interleavings a real run happens to
take; this module *enumerates* them.  It extracts an abstract state
machine from the real serving objects — the page pool free-list and
block tables, the decode-row slot pool, and registry refcounts are
**live instances** of ``PagePool`` / ``SlotPool`` / ``ModuleRegistry``,
so their guards (double-free, signature collisions, ``PagesExhausted``)
fire inside the model exactly as they would in production — and
explores every bounded interleaving of the serving transitions

    admit / form_batch / prefill / decode_tick / finish /
    reject / evict / replan

via BFS with state-fingerprint deduplication.  Every reached state is
checked against the declarative invariant catalog
(``repro_torch.analysis.invariants``); the first violation is returned as a
:class:`Counterexample` holding the exact transition script that
reaches it.  Scripts are replayable (``replay()`` re-drives a fresh
model and must reproduce the violation) and exportable as Chrome
traces through ``repro_torch.obs`` for timeline inspection.

The ``mutate=`` hook injects one of a fixed set of serving bugs
(dropped ``free()``, double free, skipped reservation, refcount skew,
unsafe evict, FIFO admission, sticky rows, mid-stream decoder moves) so
``self_test()`` can prove the checker actually catches each class of
bug while the unmutated machine verifies clean.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field, replace

from repro_torch.analysis.diagnostics import Diagnostic, Severity
from repro_torch.analysis.invariants import (DUMMY_SEQ, SeqView, StateView,
                                       WaitView, check_state)
from repro_torch.core.module import ModelSpec, ModuleSpec
from repro_torch.core.registry import ModuleRegistry
from repro_torch.serving.kvcache import PagePool, PagesExhausted, SlotPool

#: mutation name -> invariant names that must flag it (any one suffices)
MUTATIONS: dict[str, tuple[str, ...]] = {
    # a dropped free first erodes the free list until admission math goes
    # unsound, then shows as a leak at drain — either attribution is the
    # same bug
    "drop-free": ("pages/no-leak", "admission/reservation-sound"),
    "double-free": ("pages/no-double-free",),
    "skip-reservation": ("admission/reservation-sound",),
    "refcount-skew": ("registry/refcount-consistent",),
    "unsafe-evict": ("registry/refcount-consistent",),
    "fifo-admission": ("slo/bounded-inversion",),
    "sticky-row": ("rows/slot-consistent", "sched/deadlock-free"),
    "move-decoder": ("registry/decoder-pinned",),
}


@dataclass(frozen=True)
class MCRequest:
    """One generative request in the bounded scenario."""

    rid: int
    model: str
    prompt_len: int = 2
    max_new: int = 2
    deadline: float = float("inf")


@dataclass(frozen=True)
class MCModel:
    """One registered model: encoder signatures + its decoder module."""

    name: str
    decoder: str
    encoders: tuple[str, ...] = ()


@dataclass(frozen=True)
class MCConfig:
    """A bounded serving scenario for the checker to exhaust."""

    requests: tuple[MCRequest, ...]
    models: tuple[MCModel, ...]
    rows: int = 2
    pages: int = 5
    page_size: int = 2
    n_prefix: int = 0
    max_queue_depth: int = 8          # reject enabled past this depth
    evictable: tuple[str, ...] = ()   # model names evict() may target
    replannable: tuple[str, ...] = ()  # decoder modules replan() may move
    hosts: tuple[str, ...] = ("edge0", "edge1")
    inversion_bound: int = 0
    max_states: int = 200_000
    max_depth: int = 400
    mutate: str | None = None         # a key of MUTATIONS, or None

    def __post_init__(self):
        if self.mutate is not None and self.mutate not in MUTATIONS:
            raise ValueError(f"unknown mutation {self.mutate!r}; "
                             f"known: {sorted(MUTATIONS)}")
        names = {m.name for m in self.models}
        for r in self.requests:
            if r.model not in names:
                raise ValueError(f"request {r.rid} targets unregistered "
                                 f"model {r.model!r}")

    def model(self, name: str) -> MCModel:
        return next(m for m in self.models if m.name == name)

    def model_specs(self) -> list[ModelSpec]:
        """Materialize real ModelSpecs so the model state can run a real
        ModuleRegistry (shared signatures and all)."""
        mods: dict[str, ModuleSpec] = {}

        def spec(name: str, kind: str, generative: bool = False):
            if name not in mods:
                mods[name] = ModuleSpec(name, kind, "text", n_params=1,
                                        generative=generative)
            return mods[name]

        return [ModelSpec(m.name, task=m.name,
                          encoders=tuple(spec(e, "encoder")
                                         for e in m.encoders),
                          head=spec(m.decoder, "head", True))
                for m in self.models]


@dataclass
class _Live:
    """A live (admitted) sequence in the model state."""

    rid: int
    row: int
    worst: int            # worst-case pages reserved at admission
    length: int           # tokens in the paged cache
    generated: int        # -1 = prefill pending, else tokens emitted
    host_at_admit: str


@dataclass
class _State:
    """One explored global state.  The pool / rows / registry members
    are real serving allocator instances, cloned per expansion."""

    pool: PagePool
    rows: SlotPool
    registry: ModuleRegistry
    arrived: tuple[int, ...]              # submitted, not batch-formed
    waiting: tuple[int, ...]              # decode queue, priority order
    live: dict[int, _Live] = field(default_factory=dict)
    finishable: tuple[int, ...] = ()      # fully decoded, free pending
    done: frozenset = frozenset()
    rejected: frozenset = frozenset()
    registered: tuple[str, ...] = ()      # ground-truth model names
    decoder_host: dict[str, str] = field(default_factory=dict)
    reserved: int = 0
    inversions: int = 0
    double_frees: tuple = ()
    depth: int = 0


def _clone_pool(p: PagePool) -> PagePool:
    q = PagePool(p.n_pages, p.page_size)
    q._free = list(p._free)
    q.tables = {k: list(v) for k, v in p.tables.items()}
    q.used_tokens = dict(p.used_tokens)
    q.pages_peak = p.pages_peak
    return q


def _clone_rows(r: SlotPool) -> SlotPool:
    s = SlotPool(r.max_slots)
    s._free = list(r._free)
    s.lengths = list(r.lengths)
    s.live = list(r.live)
    return s


def _clone_registry(r: ModuleRegistry) -> ModuleRegistry:
    s = ModuleRegistry()
    s._models = dict(r._models)
    for name, e in r._entries.items():
        s._entries[name] = type(e)(e.module, set(e.refs))
    return s


def _clone(st: _State) -> _State:
    return _State(
        pool=_clone_pool(st.pool), rows=_clone_rows(st.rows),
        registry=_clone_registry(st.registry),
        arrived=st.arrived, waiting=st.waiting,
        live={k: replace(v) for k, v in st.live.items()},
        finishable=st.finishable, done=st.done, rejected=st.rejected,
        registered=st.registered, decoder_host=dict(st.decoder_host),
        reserved=st.reserved, inversions=st.inversions,
        double_frees=st.double_frees, depth=st.depth)


def _fingerprint(st: _State) -> tuple:
    """Canonical state key.  Page *identity* is abstracted away (only
    per-sequence held counts and the free count matter), so LIFO
    recycling order does not blow up the state space."""
    return (
        st.arrived, st.waiting,
        tuple(sorted((l.rid, l.row, l.length, l.generated, l.worst)
                     for l in st.live.values())),
        tuple(sorted(st.finishable)),
        tuple(sorted(st.done)), tuple(sorted(st.rejected)),
        st.pool.n_free,
        tuple(sorted((str(s), len(t)) for s, t in st.pool.tables.items())),
        st.rows.n_live, st.registered,
        tuple(sorted(st.registry._models)),
        tuple(sorted((m, st.registry.refcount(m))
                     for m in st.registry.modules)),
        tuple(sorted(st.decoder_host.items())),
        st.reserved, st.inversions, len(st.double_frees),
    )


class SchedulingModel:
    """The abstract serving machine: initial state + enabled/apply."""

    def __init__(self, cfg: MCConfig):
        self.cfg = cfg
        self.req = {r.rid: r for r in cfg.requests}
        self.specs = {s.name: s for s in cfg.model_specs()}
        self.decoder_of = {m.name: m.decoder for m in cfg.models}

    # -- sizing, mirroring DecodeStream ---------------------------------
    def _prefix_len(self, r: MCRequest) -> int:
        return self.cfg.n_prefix + r.prompt_len

    def _worst_pages(self, r: MCRequest, pool: PagePool) -> int:
        return pool.pages_for(self._prefix_len(r) + max(r.max_new, 1))

    def initial(self) -> _State:
        pool = PagePool(self.cfg.pages, self.cfg.page_size)
        pool.alloc(DUMMY_SEQ, 1)        # dead rows scatter here
        registry = ModuleRegistry()
        for s in self.specs.values():
            registry.add_model(s)
        hosts = {m.decoder: self.cfg.hosts[0] for m in self.cfg.models}
        return _State(pool=pool, rows=SlotPool(self.cfg.rows),
                      registry=registry,
                      arrived=tuple(r.rid for r in self.cfg.requests),
                      waiting=(), registered=tuple(sorted(self.specs)),
                      decoder_host=hosts)

    # -- transition enumeration ------------------------------------------
    def enabled(self, st: _State) -> list[tuple[str, object]]:
        cfg, out = self.cfg, []
        mut = cfg.mutate
        if st.arrived:
            out.append(("form_batch", None))
            if len(st.waiting) + len(st.live) >= cfg.max_queue_depth:
                out.append(("reject", st.arrived[-1]))
        if st.waiting and self._admittable(st) is not None:
            out.append(("admit", self._admittable(st)))
        out += [("prefill", l.rid) for l in st.live.values()
                if l.generated < 0]
        if any(l.generated >= 1 and l.rid not in st.finishable
               for l in st.live.values()):
            out.append(("decode_tick", None))
        out += [("finish", rid) for rid in st.finishable]
        inflight = self._inflight(st)
        for name in cfg.evictable:
            if name not in st.registered:
                continue
            if mut != "unsafe-evict" and name in inflight:
                continue
            out.append(("evict", name))
        for mod in cfg.replannable:
            pinned = any(self.decoder_of[self.req[l.rid].model] == mod
                         for l in st.live.values())
            if mut != "move-decoder" and pinned:
                continue
            cur = st.decoder_host.get(mod)
            nxt = next((h for h in cfg.hosts if h != cur), None)
            if nxt is not None:
                out.append(("replan", mod))
        return out

    def _inflight(self, st: _State) -> set:
        rids = (set(st.arrived) | set(st.waiting) | set(st.live)
                | set(st.finishable))
        return {self.req[r].model for r in rids}

    def _admittable(self, st: _State) -> int | None:
        """rid the admission policy would admit next, or None.  Mirrors
        ``DecodeStream._pop_admittable``: head-of-heap only, row + full
        worst-case reservation must fit."""
        if not st.waiting:
            return None
        head = (st.waiting[0] if self.cfg.mutate != "fifo-admission"
                else min(st.waiting))       # FIFO bug: arrival order
        r = self.req[head]
        if st.rows.n_live >= st.rows.max_slots:
            return None
        worst = self._worst_pages(r, st.pool)
        if self.cfg.mutate == "skip-reservation":
            # bug: only checks the immediate prefill allocation, not the
            # outstanding worst-case demand of everything already live
            need = max(st.pool.pages_for(self._prefix_len(r)), 1)
            return head if need <= st.pool.n_free else None
        held = st.pool.n_live_pages - 1          # minus the dummy page
        if st.pool.n_free - (st.reserved - held) < worst:
            return None
        return head

    # -- transition application -------------------------------------------
    def apply(self, st: _State, name: str, arg) -> _State:
        st = _clone(st)
        st.depth += 1
        getattr(self, f"_t_{name}")(st, arg)
        return st

    def _t_form_batch(self, st: _State, _):
        """ServeScheduler batch formation: arrived requests enter the
        decode queue, which orders by (deadline, arrival)."""
        merged = list(st.waiting) + list(st.arrived)
        merged.sort(key=lambda rid: (self.req[rid].deadline, rid))
        st.waiting, st.arrived = tuple(merged), ()

    def _t_reject(self, st: _State, rid: int):
        st.arrived = tuple(r for r in st.arrived if r != rid)
        st.rejected = st.rejected | {rid}

    def _t_admit(self, st: _State, rid: int):
        r = self.req[rid]
        st.waiting = tuple(x for x in st.waiting if x != rid)
        # a request admitted past an earlier-deadline waiter is a
        # priority inversion (impossible head-of-heap, possible FIFO)
        st.inversions += sum(
            1 for w in st.waiting if self.req[w].deadline < r.deadline)
        row = st.rows.alloc()
        prefix = self._prefix_len(r)
        st.pool.alloc(rid, prefix)
        worst = self._worst_pages(r, st.pool)
        if self.cfg.mutate != "skip-reservation":
            st.reserved += worst
        dec = self.decoder_of[r.model]
        st.live[rid] = _Live(rid, row, worst, prefix, -1,
                             st.decoder_host[dec])

    def _t_prefill(self, st: _State, rid: int):
        l = st.live[rid]
        l.generated = 1                  # prefill emits the first token
        if l.generated >= max(self.req[rid].max_new, 1):
            st.finishable = st.finishable + (rid,)

    def _t_decode_tick(self, st: _State, _):
        """One batched decode step over every live, prefetched row —
        exactly DecodeStream._decode_once's accounting."""
        for l in sorted(st.live.values(), key=lambda x: x.row):
            if l.generated < 1 or l.rid in st.finishable:
                continue
            st.pool.extend(l.rid, l.length + 1)
            l.length += 1
            l.generated += 1
            if l.generated >= max(self.req[l.rid].max_new, 1):
                st.finishable = st.finishable + (l.rid,)

    def _t_finish(self, st: _State, rid: int):
        """DecodeStream._finish_locked — the mutations nest here."""
        l = st.live.pop(rid)
        mut = self.cfg.mutate
        if mut != "drop-free":
            st.pool.free(rid)
        if mut == "double-free":
            try:
                st.pool.free(rid)
            except ValueError:
                st.double_frees = st.double_frees + (rid,)
        if mut != "sticky-row":
            st.rows.release(l.row)
        if mut != "skip-reservation":
            st.reserved -= l.worst
        st.finishable = tuple(x for x in st.finishable if x != rid)
        st.done = st.done | {rid}

    def _t_evict(self, st: _State, name: str):
        st.registered = tuple(m for m in st.registered if m != name)
        if self.cfg.mutate == "refcount-skew":
            # bug: drops the model entry without releasing module refs
            st.registry._models.pop(name, None)
        else:
            st.registry.remove_model(name)

    def _t_replan(self, st: _State, mod: str):
        cur = st.decoder_host[mod]
        st.decoder_host[mod] = next(h for h in self.cfg.hosts if h != cur)

    # -- invariant view -----------------------------------------------------
    def view(self, st: _State,
             enabled: list[tuple[str, object]] | None = None) -> StateView:
        pool = st.pool
        owners: dict[int, object] = {}
        multi: list[int] = []
        for seq, pages in pool.tables.items():
            for p in pages:
                if p in owners or p in pool._free:
                    multi.append(p)
                owners[p] = seq
        live = tuple(
            SeqView(rid=l.rid, held_pages=len(pool.tables.get(l.rid, ())),
                    worst_pages=l.worst,
                    remaining_tokens=max(
                        self.req[l.rid].max_new - max(l.generated, 0), 0),
                    deadline=self.req[l.rid].deadline,
                    model=self.req[l.rid].model,
                    host=st.decoder_host.get(
                        self.decoder_of[self.req[l.rid].model]),
                    host_at_admit=l.host_at_admit)
            for l in st.live.values())
        waiting = tuple(
            WaitView(rid=rid,
                     worst_pages=self._worst_pages(self.req[rid], pool),
                     deadline=self.req[rid].deadline,
                     model=self.req[rid].model)
            for rid in st.arrived + st.waiting)
        module_models = {
            mod: tuple(m.name for m in self.cfg.models
                       if m.name in st.registered
                       and mod in (m.decoder, *m.encoders))
            for m2 in self.cfg.models if m2.name in st.registered
            for mod in (m2.decoder, *m2.encoders)}
        deployed = tuple(sorted({
            self.decoder_of[self.req[l.rid].model] for l in st.live.values()}))
        terminal = (not st.arrived and not st.waiting and not st.live
                    and not st.finishable)
        return StateView(
            pages_total=pool.n_pages, pages_free=pool.n_free,
            page_owners=owners, page_multiowner=tuple(multi),
            page_size=pool.page_size,
            rows_total=st.rows.max_slots, rows_live=st.rows.n_live,
            live=live, waiting=waiting,
            refcounts={m: st.registry.refcount(m)
                       for m in module_models},
            module_models=module_models, deployed=deployed,
            inflight_models=tuple(sorted(self._inflight(st))),
            registered_models=st.registered,
            enabled=(tuple(n for n, _ in enabled)
                     if enabled is not None else ()),
            terminal=terminal,
            inversions=st.inversions,
            inversion_bound=self.cfg.inversion_bound,
            double_frees=st.double_frees)


# ---------------------------------------------------------------------------
# counterexamples
# ---------------------------------------------------------------------------

@dataclass
class Counterexample:
    """A replayable transition script reaching an invariant violation."""

    invariant: str
    message: str
    script: tuple[tuple[str, object], ...]

    def format_script(self) -> str:
        lines = [f"violates {self.invariant}: {self.message}", "script:"]
        lines += [f"  {i:3d}. {name}"
                  + (f"({arg!r})" if arg is not None else "()")
                  for i, (name, arg) in enumerate(self.script, 1)]
        return "\n".join(lines)

    def to_chrome_trace(self) -> dict:
        """Export the script as a Chrome trace over a virtual clock
        (one tick per transition) via repro_torch.obs."""
        from repro_torch.obs.trace import Tracer
        step = {"t": 0.0}
        tracer = Tracer(clock=lambda: step["t"])
        for name, arg in self.script:
            rid = arg if isinstance(arg, int) else None
            tracer.record("modelcheck", name, step["t"], step["t"] + 1.0,
                          rid=rid, arg=str(arg))
            step["t"] += 1.0
        tracer.record("modelcheck", "violation", step["t"],
                      step["t"] + 1.0, invariant=self.invariant,
                      message=self.message)
        return tracer.trace.to_chrome_trace()

    def save_trace(self, path) -> None:
        import json
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f, indent=1)


@dataclass
class MCResult:
    states: int
    transitions: int
    elapsed_s: float
    complete: bool                     # frontier exhausted within budget
    counterexample: Counterexample | None
    config: MCConfig

    @property
    def ok(self) -> bool:
        return self.counterexample is None

    def summary(self) -> str:
        rate = self.states / self.elapsed_s if self.elapsed_s > 0 else 0.0
        verdict = ("no invariant violation" if self.ok
                   else f"VIOLATION of {self.counterexample.invariant}")
        return (f"model check: {self.states} states, "
                f"{self.transitions} transitions in {self.elapsed_s:.2f}s "
                f"({rate:,.0f} states/s, "
                f"{'complete' if self.complete else 'BUDGET-CAPPED'}) "
                f"-> {verdict}")


def check(cfg: MCConfig, *, budget_s: float | None = None) -> MCResult:
    """Exhaust the schedule space of ``cfg`` (BFS, fingerprint dedup),
    checking every reached state against the invariant catalog.  Stops
    at the first violation, the state/depth caps, or ``budget_s``."""
    model = SchedulingModel(cfg)
    t0 = time.monotonic()
    init = model.initial()
    frontier: deque[tuple[_State, tuple]] = deque([(init, ())])
    seen = {_fingerprint(init)}
    states = transitions = 0
    complete = True

    while frontier:
        if budget_s is not None and time.monotonic() - t0 > budget_s:
            complete = False
            break
        if states >= cfg.max_states:
            complete = False
            break
        st, script = frontier.popleft()
        states += 1
        enabled = model.enabled(st)
        violations = check_state(model.view(st, enabled),
                                 where="model-check")
        if violations:
            name, msg = violations[0]
            return MCResult(states, transitions,
                            time.monotonic() - t0, False,
                            Counterexample(name, msg, script), cfg)
        if st.depth >= cfg.max_depth:
            complete = False
            continue
        for name, arg in enabled:
            try:
                nxt = model.apply(st, name, arg)
            except PagesExhausted as e:
                # reservation soundness should make this unreachable;
                # if a mutation slips past the state check, surface it
                return MCResult(
                    states, transitions, time.monotonic() - t0, False,
                    Counterexample("admission/reservation-sound", str(e),
                                   script + ((name, arg),)), cfg)
            transitions += 1
            fp = _fingerprint(nxt)
            if fp not in seen:
                seen.add(fp)
                frontier.append((nxt, script + ((name, arg),)))
    return MCResult(states, transitions, time.monotonic() - t0,
                    complete, None, cfg)


def replay(cfg: MCConfig, script) -> list[tuple[str, str]]:
    """Re-drive a fresh model through a counterexample script and return
    the violations observed in the final state — regression tests call
    this to pin the exact interleaving a fix addresses."""
    model = SchedulingModel(cfg)
    st = model.initial()
    for i, (name, arg) in enumerate(script):
        if (name, arg) not in model.enabled(st):
            raise ValueError(
                f"replay step {i}: {name}({arg!r}) not enabled "
                f"(enabled: {model.enabled(st)})")
        try:
            st = model.apply(st, name, arg)
        except PagesExhausted as e:
            # same mapping as check(): an allocator crash mid-script IS
            # the reservation-soundness failure
            return [("admission/reservation-sound", str(e))]
    return check_state(model.view(st, model.enabled(st)),
                       where="model-check")


# ---------------------------------------------------------------------------
# scenarios
# ---------------------------------------------------------------------------

def default_scenario(*, mutate: str | None = None,
                     max_states: int = 200_000) -> MCConfig:
    """Two models sharing one decoder, three SLO-skewed requests, two
    rows, a page pool tight enough that reservations matter, one
    evictable model and a replannable decoder — small enough to exhaust
    in well under a second, rich enough that every mutation in
    ``MUTATIONS`` reaches its invariant violation."""
    return MCConfig(
        requests=(
            MCRequest(rid=1, model="chat", prompt_len=2, max_new=2,
                      deadline=5.0),
            MCRequest(rid=2, model="summarize", prompt_len=2, max_new=2,
                      deadline=1.0),
            # the long request's 3-page worst case is what makes
            # skipping the reservation check observable: admitting it
            # early strands the short requests' outstanding demand
            MCRequest(rid=3, model="chat", prompt_len=2, max_new=4),
        ),
        models=(MCModel("chat", decoder="lm", encoders=("text-enc",)),
                MCModel("summarize", decoder="lm", encoders=("text-enc",))),
        rows=2, pages=5, page_size=2,
        max_queue_depth=2,
        evictable=("summarize",), replannable=("lm",),
        mutate=mutate, max_states=max_states)


def scenario_from_deployment(dep, *, n_requests: int = 3,
                             mutate: str | None = None) -> MCConfig:
    """Derive a bounded scenario from a real ``Deployment``: its
    registered models and shared modules become the machine's registry;
    request sizes stay tiny so the schedule space stays exhaustible."""
    models = []
    for name, spec in sorted(dep.registry.models.items()):
        gen = [m.name for m in spec.modules if m.generative]
        models.append(MCModel(
            name, decoder=gen[0] if gen else f"{spec.head.name}",
            encoders=tuple(e.name for e in spec.encoders)))
    if not models:
        raise ValueError("deployment has no registered models to check")
    reqs = tuple(
        MCRequest(rid=i + 1, model=models[i % len(models)].name,
                  prompt_len=2, max_new=2,
                  deadline=float(i + 1) if i % 2 == 0 else float("inf"))
        for i in range(n_requests))
    evictable = (models[-1].name,) if len(models) > 1 else ()
    return MCConfig(requests=reqs, models=tuple(models),
                    rows=2, pages=2 * n_requests + 1, page_size=2,
                    max_queue_depth=2, evictable=evictable,
                    mutate=mutate)


# ---------------------------------------------------------------------------
# seeded-mutation self-test
# ---------------------------------------------------------------------------

def self_test(*, budget_s: float = 60.0) -> list[Diagnostic]:
    """Prove the checker catches every seeded serving bug and that the
    unmutated machine verifies clean.  Returns Diagnostics (ERROR on a
    missed mutation, spurious violation, or budget overrun)."""
    diags: list[Diagnostic] = []
    t0 = time.monotonic()

    def left() -> float:
        return max(budget_s - (time.monotonic() - t0), 0.1)

    clean = check(default_scenario(), budget_s=left())
    if not clean.ok:
        diags.append(Diagnostic(
            Severity.ERROR, "modelcheck/unclean-baseline",
            "unmutated serving model violates "
            f"{clean.counterexample.invariant}: "
            f"{clean.counterexample.message}",
            entity="default_scenario",
            hint=clean.counterexample.format_script()))
    elif not clean.complete:
        diags.append(Diagnostic(
            Severity.ERROR, "modelcheck/budget-exceeded",
            f"baseline exploration hit the budget after {clean.states} "
            "states without exhausting the schedule space",
            entity="default_scenario"))
    else:
        diags.append(Diagnostic(
            Severity.INFO, "modelcheck/clean",
            f"baseline clean: {clean.summary()}",
            entity="default_scenario"))

    for mut, expected in MUTATIONS.items():
        res = check(default_scenario(mutate=mut), budget_s=left())
        cx = res.counterexample
        if cx is None:
            diags.append(Diagnostic(
                Severity.ERROR, "modelcheck/mutation-missed",
                f"seeded bug {mut!r} explored {res.states} states "
                f"without tripping any of {expected}",
                entity=mut,
                hint="the checker lost coverage of this bug class"))
            continue
        if cx.invariant not in expected:
            diags.append(Diagnostic(
                Severity.ERROR, "modelcheck/mutation-misattributed",
                f"seeded bug {mut!r} tripped {cx.invariant} "
                f"(expected one of {expected}): {cx.message}",
                entity=mut))
            continue
        # the counterexample must replay: same script, same violation
        replayed = replay(default_scenario(mutate=mut), cx.script)
        if cx.invariant not in {n for n, _ in replayed}:
            diags.append(Diagnostic(
                Severity.ERROR, "modelcheck/replay-divergence",
                f"counterexample for {mut!r} does not reproduce "
                f"{cx.invariant} on replay",
                entity=mut, hint=cx.format_script()))
            continue
        diags.append(Diagnostic(
            Severity.INFO, "modelcheck/mutation-caught",
            f"seeded bug {mut!r} caught by {cx.invariant} after "
            f"{res.states} states ({len(cx.script)}-step counterexample)",
            entity=mut))
    return diags
