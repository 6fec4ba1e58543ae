"""The port's interprocedural lockset race detector over the port's
serving tree: the tree analyzes clean, seeded lock-removal and
lock-order mutations are caught, the races the JAX package fixed stay
fixed in the port — and the detector gives the JAX package's findings
(codes, severities, messages, entities) on the same sources."""

import textwrap
from pathlib import Path

import pytest

import repro_torch.serving as serving
from repro.analysis import locksets as ref_ls
from repro_torch.analysis import locksets as ls
from repro_torch.analysis.diagnostics import Severity

pytestmark = pytest.mark.analysis

ROOT = Path(serving.__file__).parent
FILES = ("scheduler.py", "decode.py", "kvcache.py", "engine.py")


def _sources():
    return {f: (ROOT / f).read_text() for f in FILES}


def _analyze_with(mutated):
    srcs = _sources()
    srcs.update(mutated)
    return ls.analyze_sources(sorted(srcs.items()))


# ---- the tree is clean --------------------------------------------------

def test_serving_tree_is_lockset_clean():
    rep = ls.lint_serving_locksets()
    assert rep.diagnostics == [], [d.format() for d in rep.diagnostics]
    assert rep.contexts > 20 and rep.accesses > 100


def test_self_test_is_all_clear():
    diags = ls.self_test()
    assert diags and all(d.severity == Severity.INFO for d in diags), \
        [d.format() for d in diags]
    codes = [d.code for d in diags]
    assert codes.count("locksets/mutation-caught") >= 2
    # the removed-lock mutation bites on the port's own DecodeStream.submit
    assert any("DecodeStream.submit" in d.message for d in diags
               if d.entity == "removed-lock")


# ---- seeded mutations on the port's tree --------------------------------

def test_strip_lock_must_bite():
    with pytest.raises(ValueError, match="no lock"):
        ls.strip_lock("class A:\n    def f(self):\n        pass\n", "A", "f")


@pytest.mark.parametrize("cls,method,attr", [
    ("DecodeStream", "submit", "waiting"),
    ("DecodeStream", "stats_dict", "live"),
    ("ServeScheduler", "_enqueue", "queues"),
])
def test_removed_lock_is_detected(cls, method, attr):
    fname = "decode.py" if cls == "DecodeStream" else "scheduler.py"
    rep = _analyze_with(
        {fname: ls.strip_lock(_sources()[fname], cls, method)})
    hits = [d for d in rep.diagnostics
            if d.code in ("locksets/unlocked-write", "locksets/unlocked-read",
                          "locksets/inconsistent-locks")
            and f"{cls}.{method}" in d.message]
    assert hits, [d.format() for d in rep.diagnostics]
    assert any(attr in d.message for d in hits)


@pytest.mark.parametrize("method,needle", [
    ("_route", "_free_at"), ("drain", "results"),
    ("_run_encoder_batch", "_run_encoder_batch")])
def test_fixed_races_stay_fixed(method, needle):
    """Reverting each fix the JAX package made (taking the scheduler's
    lock out of the method) brings the finding back in the port."""
    src = _sources()["scheduler.py"]
    rep = _analyze_with(
        {"scheduler.py": ls.strip_lock(src, "ServeScheduler", method)})
    assert any(needle in d.message for d in rep.diagnostics), \
        [d.format() for d in rep.diagnostics]


def test_lock_order_cycle_is_detected():
    rep = ls.analyze_sources([("deadlock.py", ls._DEADLOCK_SNIPPET)])
    cycles = [d for d in rep.diagnostics
              if d.code == "locksets/lock-order-cycle"]
    assert cycles and "Left._lock" in cycles[0].message


# ---- analysis semantics -------------------------------------------------

_BOX = textwrap.dedent("""
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self.items = []

        def put(self, x):
            with self._lock:
                self.items.append(x)

        def peek(self):
            return self.items[-1]{pragma}
""")

_PASSIVE = textwrap.dedent("""
    import threading

    class Pool:
        def __init__(self):
            self.free = [1, 2, 3]

        def take(self):
            return self.free.pop()

    class Owner:
        def __init__(self):
            self._lock = threading.Lock()
            self.pool = Pool()

        def grab(self):
            with self._lock:
                return self.pool.take()
""")


def test_pragma_suppresses_finding():
    rep = ls.analyze_sources(
        [("box.py", _BOX.format(pragma="  # lockset: ignore"))])
    assert rep.diagnostics == [], [d.format() for d in rep.diagnostics]
    rep = ls.analyze_sources([("box.py", _BOX.format(pragma=""))])
    assert [d.code for d in rep.diagnostics] == ["locksets/unlocked-read"]


def test_caller_locked_passive_class_is_clean():
    rep = ls.analyze_sources([("pool.py", _PASSIVE)])
    assert rep.diagnostics == [], [d.format() for d in rep.diagnostics]


def test_syntax_error_reported_not_raised():
    rep = ls.analyze_sources([("bad.py", "def broken(:\n")])
    assert [d.code for d in rep.diagnostics] == ["locksets/syntax-error"]


# ---- parity with the JAX package's detector -----------------------------

def _findings(report):
    return [(int(d.severity), d.code, d.message, d.entity)
            for d in report.diagnostics]


@pytest.mark.parametrize("named", [
    [("deadlock.py", ls._DEADLOCK_SNIPPET)],
    [("box.py", _BOX.format(pragma=""))],
    [("box.py", _BOX.format(pragma="  # lockset: ignore"))],
    [("pool.py", _PASSIVE)],
    [("bad.py", "def broken(:\n")],
    [("decode.py<removed-lock>",
      ls.strip_lock(_sources()["decode.py"], "DecodeStream", "submit"))],
    sorted({**_sources(), "scheduler.py": ls.strip_lock(
        _sources()["scheduler.py"], "ServeScheduler", "_route")}.items()),
], ids=["deadlock", "race", "pragma", "passive", "syntax", "removed-lock",
        "route-race"])
def test_findings_equal_the_reference(named):
    mine, theirs = ls.analyze_sources(named), ref_ls.analyze_sources(named)
    assert _findings(mine) == _findings(theirs)
    assert (mine.contexts, mine.accesses) == (theirs.contexts,
                                              theirs.accesses)
    assert [tuple(map(str, e)) for e in mine.lock_edges] == [
        tuple(map(str, e)) for e in theirs.lock_edges]
