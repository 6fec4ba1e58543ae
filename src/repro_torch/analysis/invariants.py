"""Declarative invariant catalog for the serving stack.

One ``@invariant``-registered predicate per safety property, shared by
three enforcement layers so simulation, static checking, and live
serving all guard the *same* contracts:

* the **model checker** (``repro_torch.analysis.modelcheck``) evaluates the
  catalog at every explored state of its abstract serving machine;
* the **scheduler** (``serving.scheduler.ServeScheduler``) evaluates the
  runtime-tagged subset as debug assertions while draining;
* the **plan verifier** reports the static-tagged subset through
  ``Deployment.verify()``.

Every predicate consumes a ``StateView`` — a plain-data snapshot of the
shared serving state (page pool, decode rows, reservations, registry
refcounts) that each layer knows how to produce: the model checker from
its explored states, ``DecodeStream.state_view()`` from live objects.
Predicates return a list of violation messages (empty = holds) and must
be pure: no mutation, no device work, stdlib only.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

#: sequence key of the reserved scatter target page (never freed)
DUMMY_SEQ = "<dummy>"


@dataclass(frozen=True)
class SeqView:
    """One live (admitted) sequence's accounting, as the invariants see
    it: held vs worst-case reserved pages, decode progress, SLO."""

    rid: int
    held_pages: int              # pages currently in its block table
    worst_pages: int             # worst-case reservation made at admission
    remaining_tokens: int        # decode budget still outstanding
    deadline: float = float("inf")
    model: str | None = None
    host: str | None = None          # decoder host serving this sequence
    host_at_admit: str | None = None


@dataclass(frozen=True)
class WaitView:
    """One waiting (not yet admitted) sequence."""

    rid: int
    worst_pages: int
    deadline: float = float("inf")
    model: str | None = None


@dataclass
class StateView:
    """Plain-data snapshot of the shared serving state.

    Producers fill what they know; fields left at their defaults (None)
    make the invariants that need them report nothing, so one catalog
    serves partial runtime views and complete model-checker states.
    """

    # -- page pool ------------------------------------------------------
    pages_total: int | None = None
    pages_free: int | None = None
    # owning sequence per live page (the dummy page owns itself under
    # DUMMY_SEQ); a page listed twice upstream must be collapsed by the
    # producer into page_multiowner instead
    page_owners: dict[int, object] = field(default_factory=dict)
    # pages observed under >1 owner (or owned *and* free) — a producer
    # that detects double accounting reports the page ids here
    page_multiowner: tuple[int, ...] = ()
    page_size: int | None = None

    # -- decode rows / sequences ---------------------------------------
    rows_total: int | None = None
    rows_live: int | None = None
    live: tuple[SeqView, ...] = ()
    waiting: tuple[WaitView, ...] = ()

    # -- registry -------------------------------------------------------
    # module -> refcount claimed by the registry
    refcounts: dict[str, int] | None = None
    # module -> names of registered models referencing it (ground truth)
    module_models: dict[str, tuple[str, ...]] | None = None
    # modules with live runtimes (weights deployed)
    deployed: tuple[str, ...] = ()
    # models with requests currently in flight
    inflight_models: tuple[str, ...] = ()
    registered_models: tuple[str, ...] | None = None

    # -- scheduling -----------------------------------------------------
    # transitions enabled in this state (model checker only; None at
    # runtime, where the enabled set is unknowable)
    enabled: tuple[str, ...] | None = None
    # True when no pending work remains (all requests terminal)
    terminal: bool = False
    # SLO priority-inversion event count and its allowed bound
    inversions: int = 0
    inversion_bound: int = 0
    # pages freed for a sequence that did not own them (double free),
    # as detected by the producer (PagePool raises; the model records)
    double_frees: tuple[object, ...] = ()


@dataclass(frozen=True)
class Invariant:
    """One registered safety property."""

    name: str                    # stable "<layer>/<rule>" id
    layer: str                   # pages | admission | registry | sched | slo
    checked_by: tuple[str, ...]  # subset of {"model-check","runtime","static"}
    doc: str
    fn: Callable[[StateView], list[str]]


_CATALOG: dict[str, Invariant] = {}


def invariant(name: str, *, layer: str,
              checked_by: tuple[str, ...] = ("model-check",)):
    """Register a predicate in the catalog.  The decorated function
    takes a ``StateView`` and returns violation messages."""

    def deco(fn: Callable[[StateView], list[str]]):
        if name in _CATALOG:
            raise ValueError(f"invariant {name!r} registered twice")
        _CATALOG[name] = Invariant(name, layer, tuple(checked_by),
                                   (fn.__doc__ or "").strip(), fn)
        return fn

    return deco


def catalog() -> list[Invariant]:
    return sorted(_CATALOG.values(), key=lambda i: i.name)


def get(name: str) -> Invariant:
    return _CATALOG[name]


def check_state(view: StateView, *, where: str | None = None,
                names=None) -> list[tuple[str, str]]:
    """Evaluate the catalog against one state.  Returns
    ``(invariant_name, violation_message)`` pairs; ``where`` restricts
    to invariants tagged for that enforcement layer."""
    out: list[tuple[str, str]] = []
    for inv in catalog():
        if where is not None and where not in inv.checked_by:
            continue
        if names is not None and inv.name not in names:
            continue
        for msg in inv.fn(view):
            out.append((inv.name, msg))
    return out


def catalog_table() -> str:
    """The ROADMAP-style invariant table: name, layer, checked-by."""
    rows = [f"{i.name:32s} {i.layer:10s} {' / '.join(i.checked_by)}"
            for i in catalog()]
    return "\n".join(rows)


# ---------------------------------------------------------------------------
# the catalog
# ---------------------------------------------------------------------------

@invariant("pages/no-double-free", layer="pages",
           checked_by=("model-check", "runtime"))
def _no_double_free(v: StateView) -> list[str]:
    """No page is ever freed by a sequence that does not own it, and no
    page has more than one owner — the double-free guard ``PagePool``
    enforces dynamically, as a state predicate."""
    out = [f"sequence {s!r} freed pages it did not own"
           for s in v.double_frees]
    out += [f"page {p} has multiple owners" for p in v.page_multiowner]
    return out


@invariant("pages/conservation", layer="pages",
           checked_by=("model-check", "runtime"))
def _conservation(v: StateView) -> list[str]:
    """Every page is either on the free list or owned by exactly one
    sequence: free + held == total, always."""
    if v.pages_total is None or v.pages_free is None:
        return []
    held = len(v.page_owners)
    if v.pages_free + held != v.pages_total:
        return [f"page conservation broken: {v.pages_free} free + "
                f"{held} held != {v.pages_total} total "
                "(leak or double accounting)"]
    return []


@invariant("pages/no-leak", layer="pages",
           checked_by=("model-check", "runtime"))
def _no_leak(v: StateView) -> list[str]:
    """A quiescent pool (no live or waiting sequences) holds no pages
    beyond the reserved dummy page."""
    if not v.terminal or v.pages_total is None:
        return []
    leaked = {p: s for p, s in v.page_owners.items() if s != DUMMY_SEQ}
    if leaked:
        owners = sorted({str(s) for s in leaked.values()})
        return [f"{len(leaked)} page(s) leaked after drain "
                f"(still owned by {owners})"]
    return []


@invariant("admission/reservation-sound", layer="admission",
           checked_by=("model-check", "runtime"))
def _reservation_sound(v: StateView) -> list[str]:
    """An admitted sequence can never fail a mid-stream allocation: the
    free list always covers every live sequence's outstanding
    worst-case demand (``PagesExhausted`` is statically unreachable)."""
    if v.pages_free is None or not v.live:
        return []
    outstanding = sum(max(s.worst_pages - s.held_pages, 0) for s in v.live)
    if v.pages_free < outstanding:
        return [f"reservation unsound: {v.pages_free} page(s) free < "
                f"{outstanding} outstanding worst-case demand across "
                f"{len(v.live)} live sequence(s) — a decode extend can "
                "hit PagesExhausted"]
    return []


@invariant("rows/slot-consistent", layer="pages",
           checked_by=("model-check", "runtime"))
def _rows_consistent(v: StateView) -> list[str]:
    """Live decode rows always equal live sequences and never exceed
    capacity (a skewed slot pool double-assigns batch rows)."""
    if v.rows_total is None or v.rows_live is None:
        return []
    out = []
    if v.rows_live != len(v.live):
        out.append(f"slot pool skew: {v.rows_live} live row(s) vs "
                   f"{len(v.live)} live sequence(s)")
    if not 0 <= v.rows_live <= v.rows_total:
        out.append(f"slot pool corrupt: {v.rows_live} live of "
                   f"{v.rows_total} rows")
    return out


@invariant("registry/refcount-consistent", layer="registry",
           checked_by=("model-check", "runtime", "static"))
def _refcounts(v: StateView) -> list[str]:
    """Module refcounts equal the number of registered models that
    reference them; no deployed module is unreferenced; every in-flight
    request's model is still registered (evict-during-serve safety)."""
    out = []
    if v.refcounts is not None and v.module_models is not None:
        for mod, refs in sorted(v.module_models.items()):
            claimed = v.refcounts.get(mod, 0)
            if claimed != len(refs):
                out.append(f"module {mod!r}: refcount {claimed} != "
                           f"{len(refs)} referencing model(s) {refs}")
    if v.refcounts is not None:
        for mod in v.deployed:
            if v.refcounts.get(mod, 0) < 1:
                out.append(f"module {mod!r} has live runtime but "
                           "refcount 0 (evict freed a served module)")
    if v.registered_models is not None:
        gone = [m for m in v.inflight_models
                if m not in v.registered_models]
        if gone:
            out.append(f"model(s) {gone} have in-flight requests but "
                       "were deregistered (evict during serve)")
    return out


@invariant("registry/decoder-pinned", layer="registry",
           checked_by=("model-check",))
def _decoder_pinned(v: StateView) -> list[str]:
    """A decoder module's host never changes while it has live
    sequences — its paged KV cache lives there (replan must not move
    it mid-stream)."""
    return [f"sequence {s.rid}'s decoder moved {s.host_at_admit} -> "
            f"{s.host} while live (paged cache left behind)"
            for s in v.live
            if s.host_at_admit is not None and s.host is not None
            and s.host != s.host_at_admit]


@invariant("sched/deadlock-free", layer="sched",
           checked_by=("model-check",))
def _deadlock_free(v: StateView) -> list[str]:
    """A state with pending work always has an enabled transition."""
    if v.enabled is None or v.terminal:
        return []
    if not v.enabled:
        pend = [w.rid for w in v.waiting] + [s.rid for s in v.live]
        return [f"deadlock: request(s) {pend} pending but no "
                "transition is enabled"]
    return []


@invariant("slo/bounded-inversion", layer="slo",
           checked_by=("model-check", "runtime"))
def _bounded_inversion(v: StateView) -> list[str]:
    """Admission never bypasses a waiting request with an earlier SLO
    deadline more than the configured bound allows."""
    if v.inversions > v.inversion_bound:
        return [f"{v.inversions} SLO priority inversion(s) "
                f"(bound {v.inversion_bound}): a later-deadline request "
                "was admitted past an earlier-deadline waiter"]
    return []
