"""Observability self-test — the ``python -m repro_torch.obs --self-test``
payload, also run by ``python -m repro_torch.analysis --self``.

Three checks, each reported as ``Diagnostic``s so the analysis CLI can
gate CI on them:

* **span nesting** — a synthetic nested trace must validate clean, and
  the validator must actually flag planted orphans / escaping children
  / double roots (a validator that never fires is worse than none);
* **metrics thread safety** — hammer one counter/histogram from many
  threads; any lost update is an ERROR;
* **instrument-lock lint** — run the ``obs/unlocked-metric-mutation``
  rule over ``repro_torch.obs`` itself, and prove the rule fires on a
  planted-bad instrument class.
"""

from __future__ import annotations

from repro_torch.analysis.diagnostics import Diagnostic, Severity

_BAD_INSTRUMENT = '''
import threading

class RacyCounter:
    kind = "counter"

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n=1):
        self._value += n          # planted: mutation outside the lock
'''


def _check_span_nesting() -> list[Diagnostic]:
    from repro_torch.obs.trace import Span, Trace, Tracer

    diags: list[Diagnostic] = []
    t = [0.0]

    def clock():
        t[0] += 1.0
        return t[0]

    tr = Tracer(clock=clock)
    root = tr.begin("request", "request", rid=1)
    enc = tr.begin("enc", "encode", rid=1, parent=root)
    tr.end(enc)
    tr.record("enc", "wait", t0=1.5, t1=2.0, rid=1, parent=root)
    tr.end(root)
    problems = tr.trace.validate(1)
    if problems:
        diags.append(Diagnostic(
            Severity.ERROR, "obs/span-nesting",
            f"well-formed synthetic trace failed validation: {problems}"))
    if tr.trace.tree(1).sid != root:
        diags.append(Diagnostic(
            Severity.ERROR, "obs/span-nesting",
            "tree() did not return the root span"))

    # the validator must flag planted malformations
    planted = Trace([
        Span("request", "request", 0.0, 10.0, rid=7, sid=0),
        Span("m", "encode", 2.0, 12.0, rid=7, sid=1, parent=0),   # escapes
        Span("m", "wait", 1.0, 2.0, rid=7, sid=2, parent=99),     # orphan
        Span("m", "head", 3.0, None, rid=7, sid=3, parent=0),     # unclosed
    ])
    found = "\n".join(planted.validate(7))
    for needle in ("escapes parent", "orphan", "unclosed"):
        if needle not in found:
            diags.append(Diagnostic(
                Severity.ERROR, "obs/span-nesting",
                f"validator failed to flag a planted {needle!r} span"))
    return diags


def _check_metrics_threading(n_threads: int = 8,
                             n_iter: int = 2000) -> list[Diagnostic]:
    import threading

    from repro_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()

    def work():
        c = reg.counter("selftest.hits", worker="shared")
        h = reg.histogram("selftest.lat")
        for i in range(n_iter):
            c.inc()
            h.observe(float(i))

    threads = [threading.Thread(target=work) for _ in range(n_threads)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    want = n_threads * n_iter
    got = reg.value("selftest.hits", worker="shared")
    hist = reg.histogram("selftest.lat")
    diags: list[Diagnostic] = []
    if got != want:
        diags.append(Diagnostic(
            Severity.ERROR, "obs/metrics-thread-safety",
            f"counter lost updates under {n_threads} threads: "
            f"{got} != {want}"))
    if hist.count != want:
        diags.append(Diagnostic(
            Severity.ERROR, "obs/metrics-thread-safety",
            f"histogram lost observations: {hist.count} != {want}"))
    return diags


def _check_metric_lint() -> list[Diagnostic]:
    from pathlib import Path

    import repro_torch.obs
    from repro_torch.analysis.concurrency_lint import lint_paths, lint_source

    # the shipped instruments must be lint-clean
    diags = [d for d in lint_paths([Path(repro_torch.obs.__file__).parent])
             if d.severity >= Severity.ERROR]
    # and the rule must fire on a planted-bad instrument
    planted = lint_source(_BAD_INSTRUMENT, "<planted>")
    if not any(d.code == "obs/unlocked-metric-mutation" for d in planted):
        diags.append(Diagnostic(
            Severity.ERROR, "obs/metric-lint",
            "obs/unlocked-metric-mutation rule failed to fire on a "
            "planted unlocked instrument mutation"))
    return diags


def self_test() -> list[Diagnostic]:
    """Run all obs self-checks; ERROR diagnostics mean the
    observability layer itself cannot be trusted."""
    diags = (_check_span_nesting() + _check_metrics_threading()
             + _check_metric_lint())
    if not any(d.severity >= Severity.ERROR for d in diags):
        diags.append(Diagnostic(
            Severity.INFO, "obs/self-test",
            "span nesting, metrics thread-safety, and instrument-lock "
            "lint all passed"))
    return diags
