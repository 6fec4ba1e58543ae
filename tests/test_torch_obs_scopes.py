"""The serving loop's host scopes and the collector's gc spans
(``repro_torch.obs.trace``): under ``torch.profiler`` every ``s2m3.*``
scope is a top-level host event with the operators it launches nested
under it and no scope inside another; with no profiler recording no
range is entered; the device calls' spans carry ``dispatch_s`` and
``syncs`` (one read a call of greedy rows); each garbage collection is one ``gc`` span, also when it
starts while the tracer's lock is held."""

import gc
import threading

import numpy as np
import pytest
import torch

from repro_torch.common.config import get_config
from repro_torch.models.api import build_model
from repro_torch.obs import __main__ as cli
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import Tracer
from repro_torch.s2m3 import Request
from repro_torch.serving.scheduler import (SchedulerConfig, ServeScheduler,
                                           lm_scheduler)

CPU = torch.device("cpu")

ENCODER_SCOPES = {"s2m3.sched.submit", "s2m3.sched.pick",
                  "s2m3.encode.dispatch", "s2m3.encode.wait",
                  "s2m3.encode.retire", "s2m3.head.dispatch",
                  "s2m3.head.wait", "s2m3.head.retire"}
DECODE_SCOPES = {"s2m3.sched.submit", "s2m3.sched.pick", "s2m3.decode.admit",
                 "s2m3.prefill.dispatch", "s2m3.prefill.read",
                 "s2m3.decode.form", "s2m3.decode.dispatch",
                 "s2m3.decode.read", "s2m3.decode.retire"}


def _encoder_case():
    """The obs demo: two tasks sharing one encoder, each with a head."""
    dep = cli._demo_deployment(CPU)
    sched = ServeScheduler(dep.engine,
                           config=SchedulerConfig(debug_invariants=False))
    return sched, cli._demo_workload(6)


def _decode_case():
    """A head-only generative model on the paged decode stream: rows
    that join and leave, prefills inside ticks."""
    bundle = build_model(get_config("internvl2-1b", smoke=True),
                         compute_dtype=torch.float32)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    cfg = bundle.cfg
    img = np.random.default_rng(5).standard_normal(
        (cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    sched = lm_scheduler(bundle, params, device="cpu", config=SchedulerConfig(
        decode_rows=3, page_size=8, max_seq_len=48, decode_pages=20,
        debug_invariants=False))
    reqs = [Request(rid=i, model="lm", source="dev0", prompt=(5 + i, 9),
                    max_new_tokens=2 + 2 * i, inputs={"vision": img})
            for i in range(4)]
    return sched, reqs


CASES = {"encoder": (_encoder_case, ENCODER_SCOPES),
         "decode": (_decode_case, DECODE_SCOPES)}


def _serve(sched, reqs):
    for r in reqs:
        sched.submit(r)
    while sched.step():
        pass


def _top(e):
    while e.cpu_parent is not None:
        e = e.cpu_parent
    return e


@pytest.fixture(scope="module", params=sorted(CASES))
def profiled(request):
    """One case served under a CPU profile: (scheduler, its profile's
    events, the scope names the case must show)."""
    make, names = CASES[request.param]
    sched, reqs = make()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _serve(sched, reqs)
    return sched, list(prof.events()), names


def test_scopes_are_top_level_host_events(profiled):
    _, events, names = profiled
    scopes = [e for e in events if e.name.startswith("s2m3.")]
    assert {e.name for e in scopes} == names
    # no scope inside another: each is its own top-level event
    assert all(e.cpu_parent is None for e in scopes)


def test_operators_nest_under_the_scopes(profiled):
    """Every operator the serving loop ran lies under one of its scopes,
    so a profile names every host gap by a phase of the loop."""
    _, events, _ = profiled
    ops = [e for e in events if e.name.startswith("aten::")]
    assert ops
    assert {_top(e).name.split(".")[0] for e in ops} == {"s2m3"}


def test_the_span_tree_stays_valid(profiled):
    sched, _, _ = profiled
    assert sched.tracer.trace.validate() == []


def test_call_spans_carry_dispatch_and_syncs(profiled):
    sched, _, _ = profiled
    calls = [s for s in sched.tracer.trace.spans
             if s.phase in ("encode", "head", "prefill", "decode_tick")]
    assert calls
    for s in calls:
        assert 0.0 <= s.attrs["dispatch_s"] <= s.dur
        # every row is greedy: one read a call, a tick's included
        assert s.attrs["syncs"] == 1, s


def test_a_tick_reads_a_token_a_live_row():
    """The greedy rows' tokens come back in one read a tick, however
    many rows are live; on the CPU the tick runs eagerly (``graph`` 0)."""
    sched, reqs = _decode_case()
    _serve(sched, reqs)
    ticks: dict = {}
    for s in sched.tracer.trace.spans:
        if s.phase == "decode_tick":
            ticks.setdefault((s.t0, s.t1), []).append(s)
    assert any(len(rows) > 1 for rows in ticks.values())
    for rows in ticks.values():
        assert {s.attrs["syncs"] for s in rows} == {1}
        assert {s.attrs["rows"] for s in rows} == {len(rows)}
        assert {s.attrs["graph"] for s in rows} == {0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_no_range_is_entered_without_a_profiler(monkeypatch, case):
    entered = []

    class Spy:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            pass

    monkeypatch.setattr(obs_trace, "_record_range", Spy)
    make, names = CASES[case]
    sched, reqs = make()
    _serve(sched, reqs)
    assert entered == []
    # the spy is the range a recording profiler would get
    sched, reqs = make()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        _serve(sched, reqs)
    assert set(entered) == names


def test_a_scope_times_its_body_on_the_tracer_clock():
    t = iter([1.0, 4.5])
    tr = Tracer(clock=lambda: next(t))
    with tr.scope("s2m3.x.y") as sc:
        pass
    assert (sc.t0, sc.t1, sc.dur) == (1.0, 4.5, 3.5)
    assert len(tr.trace) == 0


def _gc_spans(tracer):
    return [s for s in tracer.trace.spans if s.phase == "gc"]


def _collect():
    gc.collect()


def _collect_holding_the_lock(tracer):
    with tracer._lock:
        gc.collect()


@pytest.mark.parametrize("how", ["free", "lock held"])
def test_a_collection_is_one_gc_span(how):
    """A forced full collection gives one closed ``gc`` span; one that
    starts while the same thread holds the tracer's lock (``trace``
    allocates under it) neither deadlocks nor is lost."""
    tr = Tracer(gc=True)
    plain = Tracer()
    run = _collect if how == "free" else (
        lambda: _collect_holding_the_lock(tr))
    was = gc.isenabled()
    gc.disable()              # only the forced collection runs
    try:
        before = len(_gc_spans(tr))
        worker = threading.Thread(target=run, daemon=True)
        worker.start()
        worker.join(timeout=60)
        assert not worker.is_alive(), "the gc hook blocked on the lock"
    finally:
        if was:
            gc.enable()
    spans = _gc_spans(tr)
    assert len(spans) == before + 1
    s = spans[-1]
    assert (s.name, s.rid, s.parent, s.attrs["generation"]) == \
        ("python", None, None, 2)
    assert s.attrs["collected"] >= 0 and 0.0 <= s.t0 <= s.t1
    assert _gc_spans(plain) == []
    assert tr.trace.validate() == []
    events = tr.trace.to_chrome_trace()["traceEvents"]
    assert events[-1]["name"] == "python:gc"
    assert events[-1]["args"]["generation"] == 2


def test_the_scheduler_tracer_records_collections():
    sched, reqs = _encoder_case()
    assert sched.tracer in obs_trace._GC_TRACERS
    sid = sched.tracer.begin("mark", "mark")
    sched.tracer.end(sid)
    gc.collect()
    _serve(sched, reqs)
    spans = sched.tracer.trace.spans
    assert [s.sid for s in spans] == list(range(len(spans)))
    assert any(s.phase == "gc" and s.sid > sid for s in spans)


def test_gc_spans_under_threads_keep_every_span_and_its_id():
    """Threads opening and closing spans while other threads collect:
    every collection is one gc span, every span keeps a unique id equal
    to its place in the trace, none is left open.  (A ``gc.collect()``
    while another thread's collection runs returns without collecting,
    so the collections are counted as they end.)"""
    import sys

    tr = Tracer(gc=True)
    n_span, n_gc, per_span, per_gc = 6, 2, 3000, 60
    errors = []
    ended = []

    def count(phase, info):
        if phase == "stop":
            ended.append(info["generation"])

    def spans(k):
        try:
            for i in range(per_span):
                tr.end(tr.begin("t", "work", rid=None, k=k, i=i))
        except Exception as e:          # surfaced below
            errors.append(e)

    def collect():
        for i in range(per_gc):
            gc.collect(1 if i % 10 == 0 else 0)

    was = gc.isenabled()
    interval = sys.getswitchinterval()
    gc.disable()                        # only the forced collections run
    gc.callbacks.append(count)
    sys.setswitchinterval(1e-6)
    try:
        workers = ([threading.Thread(target=spans, args=(k,), daemon=True)
                    for k in range(n_span)]
                   + [threading.Thread(target=collect, daemon=True)
                      for _ in range(n_gc)])
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=120)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
        gc.callbacks.remove(count)
        if was:
            gc.enable()
    assert errors == [] and len(ended) >= per_gc
    trace = tr.trace
    assert [s.sid for s in trace.spans] == list(range(len(trace)))
    assert sum(s.phase == "work" for s in trace.spans) == n_span * per_span
    assert [s.attrs["generation"] for s in trace.spans
            if s.phase == "gc"] == ended
    assert trace.validate() == []


def test_a_collection_frees_a_gc_tracers_cycle():
    """A scheduler's tracer records the collector's pauses and reads the
    scheduler's clock, a cycle: a collection frees it with everything it
    holds, as it frees any other cycle."""
    import weakref

    sched, _ = _decode_case()
    ref = weakref.ref(sched)
    del sched
    gc.collect()
    assert ref() is None
