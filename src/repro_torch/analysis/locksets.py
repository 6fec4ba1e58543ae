"""Interprocedural lockset race detector for the serving stack.

``concurrency_lint`` is per-class and intra-procedural: it cannot see a
lock released across a method call, a helper that relies on every
caller holding the lock, or an admission/evict race that spans
``ServeScheduler`` -> ``DecodeStream`` -> ``PagePool``.  This module is
the Eraser-style upgrade:

1. **Call graph + type environment.**  All classes in the analyzed
   files share one namespace.  Attribute and local types are resolved
   from constructor calls (``self.pool = PagePool(...)``), annotations
   (``self.decode: dict[str, DecodeStream]`` — container element types
   included), parameter annotations, and simple aliasing
   (``stream = self.decode.get(m)``, ``for m, s in dict(self.decode)
   .items()``), so a call like ``stream.tick()`` resolves to
   ``DecodeStream.tick``.

2. **Lockset propagation.**  Starting from every *public* method of
   every lock-owning class with the empty lockset, the analysis walks
   the call graph, carrying the set of held locks — lock identity is
   ``(ClassName, lock_attr)`` — through calls, and records every
   ``self.X`` access (read and write) together with the lockset held at
   that program point.  Private helpers are analyzed only under the
   locksets their real callers establish, so a helper that is always
   entered with the lock held is *not* a false positive.

3. **Race report.**  For each shared attribute (written somewhere
   outside ``__init__``), if at least one access is guarded but the
   intersection of all access locksets is empty, the unprotected sites
   are reported: unguarded writes as ``locksets/unlocked-write``
   (ERROR), unguarded reads as ``locksets/unlocked-read`` (WARNING).
   Classes with *no* guarded access to an attribute are deliberately
   lock-free for it (``S2M3Engine``, ``PagePool`` rely on caller
   locking) and stay silent — callers are analyzed instead.

4. **Lock-order graph.**  Acquiring lock B while holding lock A adds
   edge A -> B (interprocedurally: the edge is found even when the
   acquisition happens two calls deep).  A cycle in this graph is a
   potential deadlock — ``locksets/lock-order-cycle`` (ERROR).

Suppression: a ``# lockset: ignore`` comment on the access line
silences that site.  Aliased mutation through locals
(``fl = self.inflight[r]; fl.pending.discard(...)``) remains invisible
— same documented blind spot as ``concurrency_lint``.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

from repro_torch.analysis.diagnostics import Diagnostic, Severity

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
             "pop", "popleft", "popitem", "remove", "discard", "clear",
             "update", "setdefault", "add", "release", "acquire_row",
             "track_max"}
_HEAP_FNS = {"heappush", "heappop", "heappushpop", "heapify"}
_PRAGMA = "lockset: ignore"


@dataclass(frozen=True, order=True)
class LockId:
    cls: str
    attr: str

    def __str__(self) -> str:
        return f"{self.cls}.{self.attr}"


@dataclass(frozen=True)
class _Type:
    """A resolved static type: a class, or a container of one."""

    cls: str
    container: bool = False     # dict/list/set of `cls` elements

    def element(self) -> "_Type | None":
        return _Type(self.cls) if self.container else None


@dataclass
class _Op:
    """One atomic fact collected from a method body, with the locks
    lexically held at that point (entry locks are added later)."""

    kind: str                   # "read" | "write" | "call" | "acquire"
    lineno: int
    locks: frozenset            # frozenset[LockId] held lexically
    attr: str = ""              # read/write: attribute name
    callee: tuple | None = None  # call: (class, method)
    lock: LockId | None = None  # acquire: the lock being taken


@dataclass
class _MethodInfo:
    name: str
    ops: list[_Op] = field(default_factory=list)


@dataclass
class _ClassInfo:
    name: str
    filename: str
    lock_attrs: set[str] = field(default_factory=set)
    methods: dict[str, _MethodInfo] = field(default_factory=dict)
    attr_types: dict[str, _Type] = field(default_factory=dict)
    node: ast.ClassDef | None = None


@dataclass(frozen=True)
class _AccessRec:
    cls: str
    attr: str
    method: str
    lineno: int
    filename: str
    kind: str                   # "read" | "write"
    locks: frozenset


# ---------------------------------------------------------------------------
# pass 1: class discovery, lock attrs, attribute types
# ---------------------------------------------------------------------------

def _annotation_type(node, known: set[str]) -> _Type | None:
    """``X`` / ``X | None`` / ``dict[K, X]`` / ``list[X]`` -> _Type."""
    if isinstance(node, ast.Name) and node.id in known:
        return _Type(node.id)
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return _Type(node.value) if node.value in known else None
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.BitOr):
        return (_annotation_type(node.left, known)
                or _annotation_type(node.right, known))
    if isinstance(node, ast.Subscript):
        base = node.value
        base_name = base.id if isinstance(base, ast.Name) else None
        elts = (node.slice.elts if isinstance(node.slice, ast.Tuple)
                else [node.slice])
        inner = _annotation_type(elts[-1], known)
        if inner is not None and base_name in {"dict", "list", "set",
                                               "Dict", "List", "Set",
                                               "deque", "Deque"}:
            return _Type(inner.cls, container=True)
    return None


def _self_attr(node) -> str | None:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _ctor_type(node, known: set[str]) -> _Type | None:
    """``ClassName(...)`` -> _Type; ``dict(x)`` propagates x later."""
    if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id in known):
        return _Type(node.func.id)
    return None


def _discover(trees: list[tuple[str, ast.Module]]) -> dict[str, _ClassInfo]:
    classes: dict[str, _ClassInfo] = {}
    for filename, tree in trees:
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef):
                classes[node.name] = _ClassInfo(node.name, filename,
                                                node=node)
    known = set(classes)
    for info in classes.values():
        cls = info.node
        for m in [n for n in cls.body
                  if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]:
            params = {a.arg: _annotation_type(a.annotation, known)
                      for a in m.args.args if a.annotation is not None}
            for node in ast.walk(m):
                if isinstance(node, ast.Assign):
                    for t in node.targets:
                        a = _self_attr(t)
                        if a is None:
                            continue
                        v = node.value
                        ctor = (v.func if isinstance(v, ast.Call) else None)
                        cname = (ctor.attr if isinstance(ctor, ast.Attribute)
                                 else ctor.id if isinstance(ctor, ast.Name)
                                 else None)
                        if cname in _LOCK_CTORS:
                            info.lock_attrs.add(a)
                            continue
                        ty = _ctor_type(v, known)
                        if ty is None and isinstance(v, ast.Name):
                            ty = params.get(v.id)      # self.x = param
                        if ty is not None:
                            info.attr_types.setdefault(a, ty)
                elif isinstance(node, ast.AnnAssign):
                    a = _self_attr(node.target)
                    if a is not None:
                        ty = _annotation_type(node.annotation, known)
                        if ty is not None:
                            info.attr_types.setdefault(a, ty)
                elif isinstance(node, (ast.With, ast.AsyncWith)):
                    for item in node.items:
                        a = _self_attr(item.context_expr)
                        if a is not None and "lock" in a.lower():
                            info.lock_attrs.add(a)
    return classes


# ---------------------------------------------------------------------------
# pass 2: per-method op collection (lexical locks + local types)
# ---------------------------------------------------------------------------

class _Collector:
    def __init__(self, info: _ClassInfo, classes: dict[str, _ClassInfo]):
        self.info = info
        self.classes = classes
        self.known = set(classes)

    def collect(self, m: ast.FunctionDef) -> _MethodInfo:
        out = _MethodInfo(m.name)
        types: dict[str, _Type] = {}
        for a in m.args.args:
            ty = _annotation_type(a.annotation, self.known)
            if ty is not None:
                types[a.arg] = ty
        self._block(m.body, frozenset(), types, out)
        return out

    # -- type resolution ------------------------------------------------
    def _expr_type(self, node, types) -> _Type | None:
        if isinstance(node, ast.Name):
            return types.get(node.id)
        a = _self_attr(node)
        if a is not None:
            return self.info.attr_types.get(a)
        if isinstance(node, ast.Subscript):
            t = self._expr_type(node.value, types)
            return t.element() if t is not None else None
        if isinstance(node, ast.Call):
            ty = _ctor_type(node, self.known)
            if ty is not None:
                return ty
            fn = node.func
            # dict(self.decode) / list(...) keep the element type
            if (isinstance(fn, ast.Name) and fn.id in {"dict", "list",
                                                       "sorted", "set"}
                    and node.args):
                return self._expr_type(node.args[0], types)
            # self.decode.get(k) / .setdefault(k, v) / .pop(k) -> element
            if (isinstance(fn, ast.Attribute)
                    and fn.attr in {"get", "setdefault", "pop"}):
                t = self._expr_type(fn.value, types)
                return t.element() if t is not None else None
            if isinstance(fn, ast.Attribute) and fn.attr in {"items",
                                                             "values"}:
                return self._expr_type(fn.value, types)
        return None

    def _bind(self, target, value_type, types) -> None:
        if value_type is None:
            return
        if isinstance(target, ast.Name):
            types[target.id] = value_type
        elif (isinstance(target, ast.Tuple)
              and value_type.container is False and len(target.elts) == 2):
            # for k, v in <dict-of-X>.items(): bind v
            if isinstance(target.elts[1], ast.Name):
                types[target.elts[1].id] = value_type

    # -- op emission ----------------------------------------------------
    def _lock_of(self, node, types) -> LockId | None:
        """``self._lock`` / ``<typed>.lockattr`` -> LockId."""
        a = _self_attr(node)
        if a is not None:
            if a in self.info.lock_attrs or "lock" in a.lower():
                return LockId(self.info.name, a)
            return None
        if isinstance(node, ast.Attribute) and "lock" in node.attr.lower():
            t = self._expr_type(node.value, types)
            if t is not None and not t.container:
                return LockId(t.cls, node.attr)
        return None

    def _resolve_call(self, call: ast.Call, types) -> tuple | None:
        fn = call.func
        if not isinstance(fn, ast.Attribute):
            return None
        a = _self_attr(fn)
        if a is not None:
            # self.m() — a self-call when m is a method of this class
            if any(isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
                   and n.name == a for n in self.info.node.body):
                return (self.info.name, a)
            return None
        t = self._expr_type(fn.value, types)
        if t is None or t.container:
            return None
        target = self.classes.get(t.cls)
        if target is not None and fn.attr in {
                n.name for n in target.node.body
                if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}:
            return (t.cls, fn.attr)
        return None

    def _scan_expr(self, node, locks, types, out: _MethodInfo) -> None:
        """Record reads, mutator-call writes, and resolved calls inside
        one expression."""
        skip: set[int] = set()
        for call in ast.walk(node):
            if not isinstance(call, ast.Call):
                continue
            callee = self._resolve_call(call, types)
            if callee is not None:
                out.ops.append(_Op("call", call.lineno, locks,
                                   callee=callee))
                if callee[0] == self.info.name:
                    skip.add(id(call.func))   # self.m is not a state read
            fn = call.func
            if isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS:
                a = _self_attr(fn.value)
                if a is not None and a not in self.info.lock_attrs:
                    out.ops.append(_Op("write", call.lineno, locks, attr=a))
                    skip.add(id(fn.value))
            # heapq.heappush(self.waiting, ...) mutates its first arg
            hname = (fn.attr if isinstance(fn, ast.Attribute)
                     else fn.id if isinstance(fn, ast.Name) else None)
            if hname in _HEAP_FNS and call.args:
                a = _self_attr(call.args[0])
                if a is not None:
                    out.ops.append(_Op("write", call.lineno, locks, attr=a))
                    skip.add(id(call.args[0]))
        for sub in ast.walk(node):
            a = _self_attr(sub)
            if (a is None or id(sub) in skip
                    or a in self.info.lock_attrs
                    or not isinstance(sub.ctx, ast.Load)):
                continue
            out.ops.append(_Op("read", sub.lineno, locks, attr=a))

    def _write_targets(self, stmt, locks, types, out: _MethodInfo) -> None:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = stmt.targets
        elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
            targets = [stmt.target]
        elif isinstance(stmt, ast.Delete):
            targets = stmt.targets
        for t in targets:
            a = _self_attr(t)
            if a is not None and a not in self.info.lock_attrs:
                out.ops.append(_Op("write", stmt.lineno, locks, attr=a))
            if isinstance(t, ast.Subscript):
                a = _self_attr(t.value)
                if a is not None and a not in self.info.lock_attrs:
                    out.ops.append(_Op("write", stmt.lineno, locks, attr=a))
                else:
                    self._scan_expr(t.value, locks, types, out)
                self._scan_expr(t.slice, locks, types, out)

    def _block(self, stmts, locks: frozenset, types: dict,
               out: _MethodInfo) -> None:
        for stmt in stmts:
            if isinstance(stmt, (ast.With, ast.AsyncWith)):
                inner = locks
                for item in stmt.items:
                    lid = self._lock_of(item.context_expr, types)
                    if lid is not None:
                        out.ops.append(_Op("acquire", stmt.lineno, inner,
                                           lock=lid))
                        inner = inner | {lid}
                    else:
                        self._scan_expr(item.context_expr, locks, types,
                                        out)
                self._block(stmt.body, inner, types, out)
            elif isinstance(stmt, (ast.If, ast.While)):
                self._scan_expr(stmt.test, locks, types, out)
                self._block(stmt.body, locks, types, out)
                self._block(stmt.orelse, locks, types, out)
            elif isinstance(stmt, (ast.For, ast.AsyncFor)):
                self._scan_expr(stmt.iter, locks, types, out)
                self._bind(stmt.target,
                           self._expr_type(stmt.iter, types), types)
                self._block(stmt.body, locks, types, out)
                self._block(stmt.orelse, locks, types, out)
            elif isinstance(stmt, ast.Try):
                self._block(stmt.body, locks, types, out)
                for h in stmt.handlers:
                    self._block(h.body, locks, types, out)
                self._block(stmt.orelse, locks, types, out)
                self._block(stmt.finalbody, locks, types, out)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._block(stmt.body, locks, types, out)
            elif isinstance(stmt, ast.Return):
                if stmt.value is not None:
                    self._scan_expr(stmt.value, locks, types, out)
            else:
                self._write_targets(stmt, locks, types, out)
                if isinstance(stmt, ast.Assign):
                    self._scan_expr(stmt.value, locks, types, out)
                    ty = self._expr_type(stmt.value, types)
                    for t in stmt.targets:
                        self._bind(t, ty, types)
                elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
                    if getattr(stmt, "value", None) is not None:
                        self._scan_expr(stmt.value, locks, types, out)
                    if isinstance(stmt, ast.AugAssign):
                        # x += 1 reads x too
                        a = _self_attr(stmt.target)
                        if a is not None:
                            out.ops.append(_Op("read", stmt.lineno, locks,
                                               attr=a))
                elif isinstance(stmt, ast.Expr):
                    self._scan_expr(stmt.value, locks, types, out)
                elif isinstance(stmt, (ast.Assert, ast.Raise)):
                    for v in ast.walk(stmt):
                        if v is not stmt:
                            pass
                    self._scan_expr(stmt, locks, types, out)


# ---------------------------------------------------------------------------
# pass 3: interprocedural fixpoint
# ---------------------------------------------------------------------------

@dataclass
class LocksetReport:
    diagnostics: list[Diagnostic]
    contexts: int                  # (class, method, entry-lockset) analyzed
    accesses: int                  # shared-attribute accesses recorded
    lock_edges: list[tuple[LockId, LockId, int]]

    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics
                if d.severity >= Severity.ERROR]


def _analyze(classes: dict[str, _ClassInfo],
             sources: dict[str, list[str]]) -> LocksetReport:
    for info in classes.values():
        coll = _Collector(info, classes)
        for n in info.node.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.methods[n.name] = coll.collect(n)

    records: list[_AccessRec] = []
    edges: dict[tuple[LockId, LockId], int] = {}
    seen: set[tuple[str, str, frozenset]] = set()
    work: list[tuple[str, str, frozenset]] = []

    # entry points: public methods of lock-owning classes run with no
    # lock held; lock-free classes (engine, allocators) are analyzed
    # only under the locksets their callers establish
    for cname, info in classes.items():
        if not info.lock_attrs:
            continue
        for mname in info.methods:
            if mname == "__init__" or mname.startswith("__"):
                continue
            if not mname.startswith("_"):
                work.append((cname, mname, frozenset()))
    seen.update(work)

    while work:
        cname, mname, entry = work.pop()
        info = classes[cname]
        method = info.methods.get(mname)
        if method is None or mname == "__init__":
            continue
        for op in method.ops:
            eff = entry | op.locks
            if op.kind in ("read", "write"):
                records.append(_AccessRec(cname, op.attr, mname, op.lineno,
                                          info.filename, op.kind,
                                          frozenset(eff)))
            elif op.kind == "call":
                key = (op.callee[0], op.callee[1], frozenset(eff))
                if key not in seen:
                    seen.add(key)
                    work.append(key)
            elif op.kind == "acquire":
                for held in eff:
                    if held != op.lock:
                        edges.setdefault((held, op.lock), op.lineno)

    diags = _report(classes, records, sources)
    diags += _cycles(edges, classes)
    edge_list = [(a, b, ln) for (a, b), ln in sorted(
        edges.items(), key=lambda kv: (str(kv[0][0]), str(kv[0][1])))]
    return LocksetReport(diags, contexts=len(seen), accesses=len(records),
                         lock_edges=edge_list)


def _suppressed(rec: _AccessRec, sources) -> bool:
    lines = sources.get(rec.filename, ())
    if 0 < rec.lineno <= len(lines):
        return _PRAGMA in lines[rec.lineno - 1]
    return False


def _report(classes, records: list[_AccessRec], sources) -> list[Diagnostic]:
    by_attr: dict[tuple[str, str], list[_AccessRec]] = {}
    for r in records:
        by_attr.setdefault((r.cls, r.attr), []).append(r)

    diags: list[Diagnostic] = []
    for (cname, attr), recs in sorted(by_attr.items()):
        if not any(r.kind == "write" for r in recs):
            continue                     # never mutated: safe to share
        guarded = [r for r in recs if r.locks]
        if not guarded:
            continue                     # deliberately lock-free
        common = frozenset.intersection(*[r.locks for r in recs])
        if common:
            continue                     # consistently guarded
        consensus = frozenset.intersection(*[r.locks for r in guarded])
        if not consensus:
            sample = guarded[0]
            diags.append(Diagnostic(
                Severity.ERROR, "locksets/inconsistent-locks",
                f"{cname}.{attr} is guarded by different locks at "
                f"different sites ({sorted({str(l) for r in guarded for l in r.locks})}); "
                "no single lock protects it",
                entity=f"{sample.filename}:{sample.lineno}",
                hint="pick one lock and hold it at every access"))
            continue
        reported: set[tuple[int, str]] = set()
        for r in recs:
            if r.locks & consensus or _suppressed(r, sources):
                continue
            key = (r.lineno, r.kind)
            if key in reported:
                continue
            reported.add(key)
            lockstr = " + ".join(sorted(str(l) for l in consensus))
            if r.kind == "write":
                diags.append(Diagnostic(
                    Severity.ERROR, "locksets/unlocked-write",
                    f"{cname}.{r.method} writes self.{attr} with no lock "
                    f"held, but other sites guard it with {lockstr}; "
                    "concurrent submit/drain threads race here",
                    entity=f"{r.filename}:{r.lineno}",
                    hint=f"hold {lockstr} across the write (the lockset "
                         "is propagated through calls — acquiring in a "
                         "caller also fixes this)"))
            else:
                diags.append(Diagnostic(
                    Severity.WARNING, "locksets/unlocked-read",
                    f"{cname}.{r.method} reads self.{attr} with no lock "
                    f"held while writers guard it with {lockstr}; the "
                    "read can observe a torn or stale value",
                    entity=f"{r.filename}:{r.lineno}",
                    hint=f"snapshot self.{attr} under {lockstr} and use "
                         "the copy"))
    return diags


def _cycles(edges: dict[tuple[LockId, LockId], int],
            classes) -> list[Diagnostic]:
    graph: dict[LockId, set[LockId]] = {}
    for a, b in edges:
        graph.setdefault(a, set()).add(b)
    diags: list[Diagnostic] = []
    seen_cycles: set[frozenset] = set()

    def dfs(start: LockId, node: LockId, path: list[LockId]):
        for nxt in sorted(graph.get(node, ()), key=str):
            if nxt == start and len(path) > 1:
                key = frozenset(path)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    cyc = " -> ".join(str(l) for l in path + [start])
                    ln = edges.get((path[-1], start), 0)
                    fn = classes[path[-1].cls].filename
                    diags.append(Diagnostic(
                        Severity.ERROR, "locksets/lock-order-cycle",
                        f"lock-order cycle: {cyc}; two threads entering "
                        "from opposite ends deadlock",
                        entity=f"{fn}:{ln}",
                        hint="impose a global acquisition order or "
                             "release the first lock before taking the "
                             "second"))
            elif nxt not in path:
                dfs(start, nxt, path + [nxt])

    for node in sorted(graph, key=str):
        dfs(node, node, [node])
    return diags


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def analyze_sources(named_sources: list[tuple[str, str]]) -> LocksetReport:
    """Analyze ``(filename, source)`` pairs as one shared namespace."""
    trees = []
    sources: dict[str, list[str]] = {}
    diags: list[Diagnostic] = []
    for filename, src in named_sources:
        sources[filename] = src.splitlines()
        try:
            trees.append((filename, ast.parse(src, filename=filename)))
        except SyntaxError as e:
            diags.append(Diagnostic(
                Severity.ERROR, "locksets/syntax-error",
                f"cannot parse {filename}: {e}", entity=filename))
    classes = _discover(trees)
    report = _analyze(classes, sources)
    report.diagnostics = diags + report.diagnostics
    return report


def analyze_paths(paths) -> LocksetReport:
    named = []
    for p in paths:
        p = Path(p)
        files = sorted(p.rglob("*.py")) if p.is_dir() else [p]
        named += [(str(f), f.read_text()) for f in files]
    return analyze_sources(named)


def lint_serving_locksets() -> LocksetReport:
    """Run the detector over the in-tree serving layer — scheduler,
    decode streams, allocators, and engine analyzed as one call graph."""
    import repro_torch.serving as serving

    root = Path(serving.__file__).parent
    files = [root / f for f in ("scheduler.py", "decode.py",
                                "kvcache.py", "engine.py")]
    return analyze_paths([f for f in files if f.exists()])


# ---------------------------------------------------------------------------
# seeded-mutation self-test
# ---------------------------------------------------------------------------

class _LockStripper(ast.NodeTransformer):
    """Remove ``with self.<lock>:`` wrappers inside one method — the
    'removed lock acquisition' seeded bug, applied to the *real* source."""

    def __init__(self, cls: str, method: str):
        self.cls = cls
        self.method = method
        self._in_target = False
        self.stripped = 0

    def visit_ClassDef(self, node):
        if node.name != self.cls:
            return node
        self.generic_visit(node)
        return node

    def visit_FunctionDef(self, node):
        if node.name != self.method:
            return node
        self._in_target = True
        self.generic_visit(node)
        self._in_target = False
        return node

    def visit_With(self, node):
        self.generic_visit(node)
        if not self._in_target:
            return node
        for item in node.items:
            a = _self_attr(item.context_expr)
            if a is not None and "lock" in a.lower():
                self.stripped += 1
                return node.body          # splice the body in, lock gone
        return node


def strip_lock(src: str, cls: str, method: str) -> str:
    """Return ``src`` with every ``with self._lock:`` removed from
    ``cls.method`` (raises if none was found — the mutation must bite)."""
    tree = ast.parse(src)
    stripper = _LockStripper(cls, method)
    tree = ast.fix_missing_locations(stripper.visit(tree))
    if not stripper.stripped:
        raise ValueError(f"no lock acquisition found in {cls}.{method}")
    return ast.unparse(tree)


_DEADLOCK_SNIPPET = '''
import threading

class Left:
    def __init__(self, peer: "Right"):
        self._lock = threading.Lock()
        self.peer = peer
        self.count = 0

    def bump(self):
        with self._lock:
            self.count += 1
            self.peer.poke()      # acquires Right._lock under Left._lock

class Right:
    def __init__(self, peer: "Left"):
        self._lock = threading.Lock()
        self.peer = peer
        self.count = 0

    def poke(self):
        with self._lock:
            self.count += 1

    def bump(self):
        with self._lock:
            self.count += 1
            self.peer.bump()      # acquires Left._lock under Right._lock
'''


def self_test() -> list[Diagnostic]:
    """Prove the detector catches seeded concurrency bugs and stays
    silent on the real serving tree."""
    import repro_torch.serving as serving

    diags: list[Diagnostic] = []
    root = Path(serving.__file__).parent

    # 1. the real tree must be lockset-clean
    base = lint_serving_locksets()
    if base.diagnostics:
        worst = base.diagnostics[0]
        diags.append(Diagnostic(
            Severity.ERROR, "locksets/unclean-baseline",
            f"serving tree has {len(base.diagnostics)} lockset finding(s); "
            f"first: {worst.message}", entity=worst.entity,
            hint="fix the race (or annotate `# lockset: ignore` with a "
                 "justification) before trusting the self-test"))
    else:
        diags.append(Diagnostic(
            Severity.INFO, "locksets/clean",
            f"serving tree lockset-clean: {base.contexts} contexts, "
            f"{base.accesses} accesses, {len(base.lock_edges)} lock-order "
            "edge(s), no cycle", entity=str(root)))

    # 2. removed lock acquisition in the real DecodeStream.submit must
    # surface as an unlocked write racing the locked admission path
    decode_src = (root / "decode.py").read_text()
    mutated = strip_lock(decode_src, "DecodeStream", "submit")
    rep = analyze_sources([("decode.py<removed-lock>", mutated)])
    hit = [d for d in rep.diagnostics
           if d.code in ("locksets/unlocked-write", "locksets/unlocked-read")
           and ".submit " in d.message]
    if hit:
        diags.append(Diagnostic(
            Severity.INFO, "locksets/mutation-caught",
            "seeded bug 'removed-lock' (DecodeStream.submit without "
            f"self._lock) caught: {hit[0].message}", entity="removed-lock"))
    else:
        diags.append(Diagnostic(
            Severity.ERROR, "locksets/mutation-missed",
            "stripping the lock from DecodeStream.submit produced no "
            "unlocked-access finding", entity="removed-lock",
            hint="interprocedural lockset propagation lost coverage"))

    # 3. an inverted cross-class acquisition order must be reported as a
    # lock-order cycle
    rep = analyze_sources([("deadlock.py<lock-order>", _DEADLOCK_SNIPPET)])
    cyc = [d for d in rep.diagnostics
           if d.code == "locksets/lock-order-cycle"]
    if cyc:
        diags.append(Diagnostic(
            Severity.INFO, "locksets/mutation-caught",
            f"seeded bug 'lock-order-cycle' caught: {cyc[0].message}",
            entity="lock-order-cycle"))
    else:
        diags.append(Diagnostic(
            Severity.ERROR, "locksets/mutation-missed",
            "inverted lock order in the seeded two-class snippet was not "
            "reported as a cycle", entity="lock-order-cycle",
            hint="lock-order edge propagation lost coverage"))
    return diags
