"""Span/Tracer core: per-request trace trees with an injectable clock.

A ``Span`` is one timed interval — a module phase ("encode", "prefill",
"decode_tick", ...), keyed by the request id it belongs to and linked to
its parent span, so every request's life through the serving stack is
one tree rooted at its "request" span.  ``Span`` iterates as the legacy
``(module, phase, t0, t1)`` timeline tuple, so existing consumers of
``InferenceResult.timeline`` keep working unchanged.

``Tracer`` is the collector: thread-safe, append-only, with an
injectable monotonic clock (tests pass a fake; the serving scheduler
passes its epoch-relative ``_now``).  ``Tracer.trace`` snapshots a
``Trace`` — queryable (``spans_for``/``tree``/``validate``) and
exportable as Chrome-trace/Perfetto JSON (``to_chrome_trace``), where
each request id becomes one track.

``Tracer.scope(name)`` times one host phase of the serving loop
(``s2m3.<part>.<phase>``): two reads of the tracer's clock, kept on the
scope for its caller, and nothing recorded.  While a ``torch.profiler``
records, the scope also opens a host range of its name (a
``record_function`` without a device-side annotation), so the phase
lies in the profile's timeline beside the device's kernels, and the
operators it launches nest under it.  The serving loop's scopes are
siblings that never nest.

A tracer built with ``gc=True`` also records each of Python's garbage
collections as a closed span (``name="python"``, ``phase="gc"``, no rid,
attributes ``generation`` and ``collected``) through one process-wide
``gc.callbacks`` hook.  The hook never takes a tracer's lock (a
collection can start while its own thread holds it): it queues the span,
and the tracer files it, with its span id, at its next ``begin`` or
``trace``.
"""

from __future__ import annotations

import gc as _gc
import json
import threading
import time
import weakref
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

#: tolerance when checking child-within-parent nesting (clock jitter)
_EPS = 1e-9


@dataclass
class Span:
    """One timed interval of a request's life.

    Iterating yields ``(name, phase, t0, t1)`` — the legacy timeline
    tuple shape of ``serving.engine.InferenceResult``.
    """

    name: str                    # module (or "request" for roots)
    phase: str                   # encode | head | prefill | decode | ...
    t0: float
    t1: float | None = None
    rid: int | None = None
    sid: int = -1                # tracer-assigned span id
    parent: int | None = None    # parent span id (None = root)
    attrs: dict[str, Any] = field(default_factory=dict)

    @property
    def dur(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0

    @property
    def open(self) -> bool:
        return self.t1 is None

    def __iter__(self):
        yield self.name
        yield self.phase
        yield self.t0
        yield self.t1


#: whether a ``torch.profiler`` is recording (a flag read, no call into
#: the profiler)
_profiling = torch.autograd._profiler_enabled
#: the profiler's range for a scope: ``record_function``'s host event
#: alone.  ``torch.profiler.record_function`` opens a user annotation,
#: which the CUDA profile also lays on the device's timeline as a
#: ``gpu_user_annotation`` spanning the scope's kernels and the gaps
#: between them; a reader of device busy time would count it as work.
_record_range = torch._C._profiler._RecordFunctionFast


class Scope:
    """One host phase of the serving loop, timed on a tracer's clock.

    ``t0``/``t1`` are the clock on entry and exit, ``dur`` their
    difference.  With no profiler recording the scope reads the clock
    twice and the profiler's flag once, and makes no other object."""

    __slots__ = ("_clock", "name", "t0", "t1", "_range")

    def __init__(self, clock: Callable[[], float], name: str):
        self._clock = clock
        self.name = name
        self._range = None

    def __enter__(self) -> "Scope":
        if _profiling():
            self._range = _record_range(self.name)
            self._range.__enter__()
        self.t0 = self._clock()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = self._clock()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None

    @property
    def dur(self) -> float:
        return self.t1 - self.t0


#: tracers that asked for the collector's pauses (``Tracer(gc=True)``)
_GC_TRACERS: "weakref.WeakSet[Tracer]" = weakref.WeakSet()
#: (a weak reference to a tracer, its clock) at the start of the
#: collection under way: weak, so that the collection frees a tracer's
#: cycle (a scheduler's, through its clock) as it frees any other
_gc_started: list = []


def _gc_hook(phase: str, info: dict) -> None:
    if phase == "start":
        if _GC_TRACERS:
            _gc_started.extend((weakref.ref(t), t.clock())
                               for t in _GC_TRACERS)
        return
    for ref, t0 in _gc_started:
        t = ref()
        if t is not None:
            t._gc_done.append(Span(
                "python", "gc", t0, t.clock(),
                attrs={"generation": info["generation"],
                       "collected": info["collected"]}))
    _gc_started.clear()


def _watch_gc(tracer: "Tracer") -> None:
    if _gc_hook not in _gc.callbacks:
        _gc.callbacks.append(_gc_hook)
    _GC_TRACERS.add(tracer)


class Tracer:
    """Thread-safe span collector with an injectable monotonic clock.
    ``gc=True`` records the collector's pauses as ``gc`` spans."""

    def __init__(self, clock: Callable[[], float] | None = None, *,
                 gc: bool = False):
        self.clock = clock or time.perf_counter
        self._lock = threading.Lock()
        self._spans: list[Span] = []
        self._next_sid = 0
        # gc spans the hook queued, filed under the lock by _file_gc
        self._gc_done: deque[Span] = deque()
        if gc:
            _watch_gc(self)

    def scope(self, name: str) -> Scope:
        """A host phase named ``name``, timed on this tracer's clock
        (``with tracer.scope("s2m3.decode.read") as sc: ...; sc.dur``)."""
        return Scope(self.clock, name)

    def _file_gc(self) -> None:
        """File the gc spans the hook queued, each with its span id."""
        with self._lock:
            while self._gc_done:
                span = self._gc_done.popleft()
                span.sid = self._next_sid
                self._next_sid += 1
                self._spans.append(span)

    def begin(self, name: str, phase: str, *, rid: int | None = None,
              parent: int | None = None, t0: float | None = None,
              **attrs: Any) -> int:
        """Open a span; returns its id for ``end()`` / child parenting."""
        span = Span(name, phase, self.clock() if t0 is None else t0,
                    rid=rid, parent=parent, attrs=dict(attrs))
        if self._gc_done:
            self._file_gc()
        with self._lock:
            span.sid = self._next_sid
            self._next_sid += 1
            self._spans.append(span)
        return span.sid

    def end(self, sid: int, *, t1: float | None = None,
            **attrs: Any) -> Span:
        """Close a span by id (idempotent: re-ending keeps the first t1)."""
        if sid < 0:
            raise ValueError(f"invalid span id {sid}")
        t = self.clock() if t1 is None else t1
        with self._lock:
            span = self._spans[sid]
            if span.t1 is None:
                span.t1 = t
            if attrs:
                span.attrs.update(attrs)
            return span

    def record(self, name: str, phase: str, t0: float, t1: float, *,
               rid: int | None = None, parent: int | None = None,
               **attrs: Any) -> Span:
        """Record an already-measured interval as a closed span."""
        sid = self.begin(name, phase, rid=rid, parent=parent, t0=t0,
                         **attrs)
        return self.end(sid, t1=t1)

    @contextmanager
    def span(self, name: str, phase: str, *, rid: int | None = None,
             parent: int | None = None, **attrs: Any):
        sid = self.begin(name, phase, rid=rid, parent=parent, **attrs)
        try:
            yield sid
        finally:
            self.end(sid)

    @property
    def trace(self) -> "Trace":
        self._file_gc()
        with self._lock:
            return Trace(list(self._spans))


class Trace:
    """An immutable snapshot of collected spans, queryable as per-rid
    trees and exportable as Chrome-trace JSON."""

    def __init__(self, spans: list[Span]):
        self.spans = list(spans)
        self._by_sid = {s.sid: s for s in self.spans}

    def __len__(self) -> int:
        return len(self.spans)

    def rids(self) -> list[int]:
        return sorted({s.rid for s in self.spans if s.rid is not None})

    def spans_for(self, rid: int) -> list[Span]:
        return [s for s in self.spans if s.rid == rid]

    def children(self, sid: int) -> list[Span]:
        return [s for s in self.spans if s.parent == sid]

    def roots(self, rid: int | None = None) -> list[Span]:
        spans = self.spans if rid is None else self.spans_for(rid)
        return [s for s in spans
                if s.parent is None or s.parent not in self._by_sid]

    def tree(self, rid: int) -> Span:
        """The single root span of one request's trace tree."""
        roots = self.roots(rid)
        if len(roots) != 1:
            raise ValueError(
                f"trace for rid {rid} has {len(roots)} roots, expected 1 "
                f"({[s.name for s in roots]})")
        return roots[0]

    def validate(self, rid: int | None = None) -> list[str]:
        """Well-formedness problems (empty list = a contiguous tree):
        unclosed spans, orphan parents, children outside their parent's
        interval, multiple roots per rid."""
        spans = self.spans if rid is None else self.spans_for(rid)
        problems: list[str] = []
        for s in spans:
            where = f"{s.name}/{s.phase} (sid {s.sid}, rid {s.rid})"
            if s.t1 is None:
                problems.append(f"unclosed span {where}")
                continue
            if s.parent is not None:
                p = self._by_sid.get(s.parent)
                if p is None:
                    problems.append(
                        f"orphan span {where}: parent sid {s.parent} "
                        "does not exist")
                    continue
                if p.rid is not None and s.rid is not None \
                        and p.rid != s.rid:
                    problems.append(
                        f"span {where} parented across rids "
                        f"({s.rid} under {p.rid})")
                if p.t1 is not None and (s.t0 < p.t0 - _EPS
                                         or s.t1 > p.t1 + _EPS):
                    problems.append(
                        f"span {where} [{s.t0:.6f}, {s.t1:.6f}] escapes "
                        f"parent {p.name}/{p.phase} "
                        f"[{p.t0:.6f}, {p.t1:.6f}]")
        for r in ({s.rid for s in spans if s.rid is not None}
                  if rid is None else [rid]):
            roots = self.roots(r)
            if len(roots) != 1:
                problems.append(
                    f"rid {r} has {len(roots)} root spans, expected 1")
        return problems

    def to_chrome_trace(self) -> dict:
        """Chrome-trace/Perfetto JSON object format: one complete ("X")
        event per closed span, one track (tid) per request id."""
        events = []
        for s in self.spans:
            if s.t1 is None:
                continue
            args = {"sid": s.sid, **s.attrs}
            if s.parent is not None:
                args["parent"] = s.parent
            events.append({
                "name": f"{s.name}:{s.phase}",
                "cat": s.phase,
                "ph": "X",
                "ts": round(s.t0 * 1e6, 3),       # us, per the spec
                "dur": round(s.dur * 1e6, 3),
                "pid": 0,
                "tid": s.rid if s.rid is not None else -1,
                "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def save(self, path) -> None:
        """Write the Chrome-trace JSON (open in Perfetto / chrome://tracing)."""
        from pathlib import Path

        Path(path).write_text(json.dumps(self.to_chrome_trace()) + "\n")
