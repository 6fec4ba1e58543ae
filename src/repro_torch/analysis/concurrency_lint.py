"""AST concurrency lint for the serving layer.

The ``ServeScheduler`` mutates shared state (queues, stats, in-flight
tables, the ``_free_at`` occupancy map) that a submitting producer and a
draining consumer may touch from different threads.  The discipline is:

* every attribute that is ever mutated under the instance's lock must
  *always* be mutated under it (outside ``__init__``) —
  ``concurrency/unlocked-mutation`` ERROR;
* model dispatch (``apply_module`` / ``apply_head`` / ``infer`` /
  ``apply`` / ``generate`` and the other ``_DISPATCH_ATTRS``) must not
  run while holding the lock: device calls are slow and re-entrant
  callbacks (``queue_probe``) would deadlock —
  ``concurrency/dispatch-under-lock`` WARNING (the JAX package's rule
  without its ``jax.*`` / ``jnp.*`` roots, which this package never
  calls);
* its CUDA twin: ``torch.*`` calls, the hand-written kernels' entries
  (``flash_attention``, ``decode_attention``, ``paged_decode_attention``,
  ``ssd_intra_chunk``, ``ssd_chunked``, ``slstm_scan``, called bare or
  through a module) and methods that move a tensor between devices or
  wait on the card (``.to`` / ``.cuda`` / ``.cpu`` / ``.item`` /
  ``.tolist`` / ``.numpy`` / ``.synchronize`` / ``.copy_``) must not run
  while holding the lock either: a launch or a sync under the lock holds
  every other thread for the device's time —
  ``concurrency/cuda-dispatch-under-lock`` WARNING;
* batch-coalescing paths (anything reachable from ``step`` /
  ``_service`` through self-calls) must not mutate the module registry
  (``add_model`` / ``remove_model`` / ``deploy_model`` /
  ``evict_model``): registry churn mid-batch invalidates the specs the
  batch was formed against — ``concurrency/registry-mutation-in-batch-path``
  ERROR;
* allocator mutations (``alloc`` / ``extend`` / ``free`` / ``release``
  on any self-rooted object — the page pool and row slots of a decode
  stream) must run under the lock: a free racing an alloc corrupts the
  free list and double-assigns pages —
  ``concurrency/unlocked-allocator-call`` ERROR;
* metrics instruments (any class declaring
  ``kind = "counter" | "gauge" | "histogram"`` — the ``obs.metrics``
  contract) must mutate their state only under their lock, *every*
  mutation, not just ones some other site happens to guard: instruments
  are shared across scheduler threads by construction —
  ``obs/unlocked-metric-mutation`` ERROR;
* serving and observability code must not read wall clocks directly
  (``time.time()`` / ``time.monotonic()``): both layers take an
  injected clock (``Tracer(clock=...)``, the scheduler's ``now=``) so
  simulated and real runs stay comparable and tests run on virtual
  time — ``obs/raw-clock-call`` WARNING, scoped to files under
  ``serving/`` and ``obs/``.

Scope and honesty: this is a lint, not an escape analysis.  It tracks
direct ``self.X`` mutations (assignment, augmented assignment, ``del``,
and mutating method calls such as ``append`` / ``pop`` / ``update`` /
``setdefault``); local aliases (``q = self.queues[m]; q.append(...)``)
are invisible to it.  Lock detection covers ``self.X = threading.Lock()
/ RLock() / Condition()`` and any ``with self.<attr>`` where the
attribute name contains "lock".
"""

from __future__ import annotations

import ast
from pathlib import Path

from repro_torch.analysis.diagnostics import Diagnostic, Severity

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
             "pop", "popleft", "popitem", "remove", "discard", "clear",
             "update", "setdefault", "add"}
_DISPATCH_ATTRS = {"device_put", "block_until_ready", "apply_module",
                   "apply_head", "infer", "apply", "apply_prefill",
                   "apply_paged_decode", "init_paged_cache", "generate"}
_ALLOC_MUTATORS = {"alloc", "extend", "free", "release"}
_CUDA_ROOTS = {"torch"}
_KERNEL_ENTRIES = {"flash_attention", "decode_attention",
                   "paged_decode_attention", "ssd_intra_chunk",
                   "ssd_chunked", "slstm_scan"}
_DEVICE_METHODS = {"to", "cuda", "cpu", "item", "tolist", "numpy",
                   "synchronize", "copy_"}
_REGISTRY_MUTATORS = {"add_model", "remove_model", "deploy_model",
                      "evict_model"}
_BATCH_ROOTS = {"step", "_service"}
_INSTRUMENT_KINDS = {"counter", "gauge", "histogram"}


def _instrument_kind(cls: ast.ClassDef) -> str | None:
    """The ``kind = "counter"`` class constant that marks an
    ``obs.metrics`` instrument class (None for everything else)."""
    for node in cls.body:
        if isinstance(node, ast.Assign) and isinstance(node.value,
                                                       ast.Constant):
            for t in node.targets:
                if (isinstance(t, ast.Name) and t.id == "kind"
                        and node.value.value in _INSTRUMENT_KINDS):
                    return node.value.value
    return None


def _self_attr(node) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _root_name(node) -> str | None:
    while isinstance(node, ast.Attribute):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _self_rooted(node) -> bool:
    """True when an attribute chain bottoms out at ``self``, looking
    through subscripts too (``self.decode[m].pool``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return isinstance(node, ast.Name) and node.id == "self"


def _is_lock_with(item: ast.withitem, lock_attrs: set[str]) -> bool:
    attr = _self_attr(item.context_expr)
    return attr is not None and (attr in lock_attrs
                                 or "lock" in attr.lower())


class _ClassFacts:
    def __init__(self) -> None:
        self.lock_attrs: set[str] = set()
        # (attr, method, lineno, under_lock)
        self.mutations: list[tuple[str, str, int, bool]] = []
        # (call description, method, lineno)
        self.locked_dispatch: list[tuple[str, str, int]] = []
        self.locked_cuda: list[tuple[str, str, int]] = []
        # (call description, method, lineno, under_lock)
        self.alloc_calls: list[tuple[str, str, int, bool]] = []
        self.self_calls: dict[str, set[str]] = {}
        self.registry_calls: dict[str, list[tuple[str, int]]] = {}
        self.methods: set[str] = set()


def _mutated_attr(stmt) -> list[str]:
    """Direct self.X mutations performed by one statement (not
    recursing into sub-statements)."""
    out = []
    if isinstance(stmt, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
        targets = (stmt.targets if isinstance(stmt, ast.Assign)
                   else [stmt.target])
        for t in targets:
            a = _self_attr(t)
            if a is not None and isinstance(stmt, ast.AugAssign):
                out.append(a)
            elif a is not None and not isinstance(stmt, ast.Assign):
                pass                      # AnnAssign rebinding: see below
            if isinstance(t, (ast.Subscript,)):
                a = _self_attr(t.value)
                if a is not None:
                    out.append(a)         # self.X[k] = v / += v
            elif a is not None and isinstance(stmt, ast.Assign):
                out.append(a)             # self.X = v (rebinding)
    elif isinstance(stmt, ast.Delete):
        for t in stmt.targets:
            a = _self_attr(t)
            if a is not None:
                out.append(a)
            if isinstance(t, ast.Subscript):
                a = _self_attr(t.value)
                if a is not None:
                    out.append(a)
    # bare mutating calls (self.X.append(...) as a statement) are covered
    # by _call_mutations_in_expr — no Expr branch here, or they'd double
    return out


def _call_mutations_in_expr(node) -> list[tuple[str, int]]:
    """Mutating self.X.<mutator>(...) calls used as sub-expressions
    (e.g. ``q = self.queues.setdefault(...)``)."""
    out = []
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
            a = _self_attr(fn.value)
            if a is not None:
                out.append((a, call.lineno))
    return out


def _allocator_calls(node) -> list[tuple[str, int]]:
    """Self-rooted allocator-mutator calls (``self.pool.alloc(...)``,
    ``self.rows.release(...)``) — the decode substrate's free lists."""
    out = []
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        fn = call.func
        if (isinstance(fn, ast.Attribute) and fn.attr in _ALLOC_MUTATORS
                and isinstance(fn.value, (ast.Attribute, ast.Subscript))
                and _self_rooted(fn.value)):
            out.append((ast.unparse(fn), call.lineno))
    return out


def _dispatch_calls(node) -> list[tuple[str, int]]:
    out = []
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        fn = call.func
        if isinstance(fn, ast.Attribute) and fn.attr in _DISPATCH_ATTRS:
            out.append((fn.attr, call.lineno))
    return out


def _cuda_dispatch_calls(node) -> list[tuple[str, int]]:
    """torch calls, kernel-entry calls and device-moving or syncing
    method calls in one statement or expression."""
    out = []
    for call in ast.walk(node):
        if not isinstance(call, ast.Call):
            continue
        fn = call.func
        if isinstance(fn, ast.Name) and fn.id in _KERNEL_ENTRIES:
            out.append((fn.id, call.lineno))
        elif isinstance(fn, ast.Attribute):
            if _root_name(fn) in _CUDA_ROOTS:
                out.append((ast.unparse(fn), call.lineno))
            elif fn.attr in _KERNEL_ENTRIES:
                out.append((ast.unparse(fn), call.lineno))
            elif fn.attr in _DEVICE_METHODS:
                out.append((f".{fn.attr}", call.lineno))
    return out


def _collect_method(facts: _ClassFacts, method: ast.FunctionDef) -> None:
    name = method.name
    facts.methods.add(name)
    facts.self_calls.setdefault(name, set())
    facts.registry_calls.setdefault(name, [])

    def scan(node, under_lock: bool) -> None:
        """Record mutations/dispatch/calls in one statement or header
        expression — the caller guarantees ``node`` contains no nested
        statement bodies (those are recursed with their own lock ctx)."""
        for attr, ln in _call_mutations_in_expr(node):
            facts.mutations.append((attr, name, ln, under_lock))
        for desc, ln in _allocator_calls(node):
            facts.alloc_calls.append((desc, name, ln, under_lock))
        if under_lock:
            for desc, ln in _dispatch_calls(node):
                facts.locked_dispatch.append((desc, name, ln))
            for desc, ln in _cuda_dispatch_calls(node):
                facts.locked_cuda.append((desc, name, ln))
        for call in ast.walk(node):
            if isinstance(call, ast.Call):
                fn = call.func
                a = _self_attr(fn) if isinstance(fn, ast.Attribute) else None
                if a is not None:
                    facts.self_calls[name].add(a)
                cal = (fn.attr if isinstance(fn, ast.Attribute)
                       else fn.id if isinstance(fn, ast.Name) else None)
                if cal in _REGISTRY_MUTATORS:
                    facts.registry_calls[name].append((cal, call.lineno))

    def visit_block(stmts, under_lock: bool) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                for item in stmt.items:
                    scan(item.context_expr, under_lock)
                locked = under_lock or any(
                    _is_lock_with(i, facts.lock_attrs) for i in stmt.items)
                visit_block(stmt.body, locked)
            elif isinstance(stmt, (ast.If, ast.While)):
                scan(stmt.test, under_lock)
                visit_block(stmt.body, under_lock)
                visit_block(stmt.orelse, under_lock)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                scan(stmt.iter, under_lock)
                visit_block(stmt.body, under_lock)
                visit_block(stmt.orelse, under_lock)
            elif isinstance(stmt, ast.Try):
                visit_block(stmt.body, under_lock)
                for h in stmt.handlers:
                    visit_block(h.body, under_lock)
                visit_block(stmt.orelse, under_lock)
                visit_block(stmt.finalbody, under_lock)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                visit_block(stmt.body, under_lock)
            else:
                for attr in _mutated_attr(stmt):
                    facts.mutations.append(
                        (attr, name, stmt.lineno, under_lock))
                scan(stmt, under_lock)

    visit_block(method.body, under_lock=False)


def _lint_class(cls: ast.ClassDef, filename: str) -> list[Diagnostic]:
    facts = _ClassFacts()
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]

    # pass 1: find lock attributes (ctor assignment or with-usage)
    for m in methods:
        for node in ast.walk(m):
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                ctor = node.value.func
                ctor_name = (ctor.attr if isinstance(ctor, ast.Attribute)
                             else ctor.id if isinstance(ctor, ast.Name)
                             else None)
                if ctor_name in _LOCK_CTORS:
                    for t in node.targets:
                        a = _self_attr(t)
                        if a is not None:
                            facts.lock_attrs.add(a)
            elif isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    a = _self_attr(item.context_expr)
                    if a is not None and "lock" in a.lower():
                        facts.lock_attrs.add(a)

    for m in methods:
        _collect_method(facts, m)

    diags: list[Diagnostic] = []
    loc = lambda ln: f"{filename}:{ln}"  # noqa: E731

    if facts.lock_attrs:
        guarded = {a for a, _, _, locked in facts.mutations if locked}
        for attr, meth, ln, locked in facts.mutations:
            if locked or meth == "__init__" or attr not in guarded:
                continue
            if attr in facts.lock_attrs:
                continue
            diags.append(Diagnostic(
                Severity.ERROR, "concurrency/unlocked-mutation",
                f"{cls.name}.{meth} mutates self.{attr} outside the lock, "
                f"but other sites guard it with "
                f"{sorted(facts.lock_attrs)}", entity=loc(ln),
                hint=f"wrap the mutation in `with self."
                     f"{sorted(facts.lock_attrs)[0]}:`"))
        for desc, meth, ln, locked in facts.alloc_calls:
            if locked or meth == "__init__":
                continue
            diags.append(Diagnostic(
                Severity.ERROR, "concurrency/unlocked-allocator-call",
                f"{cls.name}.{meth} calls {desc}(...) outside the lock; "
                "allocator free lists race against concurrent "
                "alloc/free and double-assign pages", entity=loc(ln),
                hint=f"hold `with self.{sorted(facts.lock_attrs)[0]}:` "
                     "across the allocator call"))
        for desc, meth, ln in facts.locked_dispatch:
            diags.append(Diagnostic(
                Severity.WARNING, "concurrency/dispatch-under-lock",
                f"{cls.name}.{meth} dispatches {desc}(...) while holding "
                "the lock; device calls under a lock serialize the "
                "scheduler and can deadlock re-entrant probes",
                entity=loc(ln),
                hint="form the batch under the lock, dispatch outside it"))
        for desc, meth, ln in facts.locked_cuda:
            diags.append(Diagnostic(
                Severity.WARNING, "concurrency/cuda-dispatch-under-lock",
                f"{cls.name}.{meth} calls {desc}(...) while holding the "
                "lock; a CUDA launch, copy or sync under a lock holds "
                "every other scheduler thread for the device's time",
                entity=loc(ln),
                hint="snapshot what the call needs under the lock, launch "
                     "or sync outside it"))

    kind = _instrument_kind(cls)
    if kind is not None:
        # instruments are shared across threads by construction: every
        # non-ctor mutation must hold the lock, whether or not any other
        # site guards that attribute
        for attr, meth, ln, locked in facts.mutations:
            if locked or meth == "__init__" or attr in facts.lock_attrs:
                continue
            diags.append(Diagnostic(
                Severity.ERROR, "obs/unlocked-metric-mutation",
                f"{cls.name} is a {kind} instrument (kind={kind!r}) but "
                f"{cls.name}.{meth} mutates self.{attr} outside the "
                "lock; concurrent scheduler threads would lose updates",
                entity=loc(ln),
                hint="hold `with self._lock:` across every instrument "
                     "mutation (see repro_torch.obs.metrics)"))

    roots = _BATCH_ROOTS & facts.methods
    if roots:
        reachable = set(roots)
        frontier = list(roots)
        while frontier:
            m = frontier.pop()
            for callee in facts.self_calls.get(m, ()):
                if callee in facts.methods and callee not in reachable:
                    reachable.add(callee)
                    frontier.append(callee)
        for meth in sorted(reachable):
            for cal, ln in facts.registry_calls.get(meth, ()):
                diags.append(Diagnostic(
                    Severity.ERROR,
                    "concurrency/registry-mutation-in-batch-path",
                    f"{cls.name}.{meth} (reachable from "
                    f"{sorted(roots)}) calls {cal}(); mutating the "
                    "registry mid-batch invalidates the specs the batch "
                    "was formed against", entity=loc(ln),
                    hint="quiesce the scheduler (drain) before registry "
                         "changes — see Deployment.evict()/replan()"))
    return diags


_RAW_CLOCKS = {"time", "monotonic"}
_CLOCK_SCOPED_DIRS = {"serving", "obs"}


def _clock_scoped(filename: str) -> bool:
    parts = Path(filename).parts
    return bool(_CLOCK_SCOPED_DIRS & set(parts))


def _lint_raw_clocks(tree: ast.Module, filename: str) -> list[Diagnostic]:
    """``obs/raw-clock-call``: direct wall-clock reads in clock-injected
    layers (serving, obs)."""
    diags = []
    for call in ast.walk(tree):
        if not isinstance(call, ast.Call):
            continue
        fn = call.func
        if (isinstance(fn, ast.Attribute) and fn.attr in _RAW_CLOCKS
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "time"):
            diags.append(Diagnostic(
                Severity.WARNING, "obs/raw-clock-call",
                f"direct time.{fn.attr}() call in a clock-injected layer; "
                "serving/obs code must read the injected clock so "
                "simulated and real runs stay comparable",
                entity=f"{filename}:{call.lineno}",
                hint="thread the constructor's `now`/`clock` callable "
                     "through instead (see Tracer(clock=...))"))
    return diags


def lint_source(src: str, filename: str = "<string>") -> list[Diagnostic]:
    try:
        tree = ast.parse(src, filename=filename)
    except SyntaxError as e:
        return [Diagnostic(
            Severity.ERROR, "concurrency/syntax-error",
            f"cannot parse {filename}: {e}", entity=filename)]
    diags: list[Diagnostic] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            diags.extend(_lint_class(node, filename))
    if _clock_scoped(filename):
        diags.extend(_lint_raw_clocks(tree, filename))
    return diags


def lint_paths(paths) -> list[Diagnostic]:
    """Lint .py files; directory arguments are walked recursively."""
    diags: list[Diagnostic] = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        for f in files:
            diags.extend(lint_source(f.read_text(), filename=str(f)))
    return diags


def lint_serving() -> list[Diagnostic]:
    """Lint the in-tree serving layer (the default ``--self`` target)."""
    import repro_torch.serving as serving

    return lint_paths([Path(serving.__file__).parent])
