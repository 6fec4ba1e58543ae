"""Static plan verifier: prove a placement sound before it touches a
device.

Given a ``Placement`` + ``ClusterSpec`` + the model set (and optionally
the ``ModuleRegistry`` and the pinned plan options), emits structured
``Diagnostic``s for every way the plan could fail at runtime:

* ``plan/memory-overflow``     — a device's memory ledger exceeds its
  capacity (the mid-``serve()`` OOM, caught statically).
* ``plan/infeasible``          — the strategy itself gave up on a module.
* ``plan/unmapped-module``     — a model references a module the plan
  never assigned (front-runs the engine's ``module_hosts`` PlanError).
* ``plan/unknown-device``      — an assignment names a device that is
  not in the cluster.
* ``plan/duplicate-replica``   — the same device listed twice for one
  module (double-charged ledger).
* ``plan/signature-collision`` — sharing legality: two tasks reuse one
  module signature with different shape/dtype-bearing specs.
* ``plan/dependency-cycle``    — the module dependency graph
  (encoder -> head edges across all models) is not a DAG.
* ``plan/unreachable-route``   — an encoder's host cannot ship its
  output to any of the head's hosts (explicit zero-bandwidth link).
* ``plan/refcount-mismatch``   — registry refcounts disagree with the
  placement (module referenced by live models but not placed).
* ``plan/stale-assignment``    — placement carries a module no live
  model references (eviction leftovers).
* ``plan/unknown-option``      — a plan kwarg the pinned strategy does
  not accept (typo catcher; strategies swallow unknown ``**_``).
* ``plan/page-budget``         — a generative head's paged-KV pool
  (``decode_pages * page_size * kv_bytes_per_token``) does not fit next
  to the weights already on its host (``check_page_budget``, run by the
  ``serve()`` pre-flight with the scheduler's actual decode knobs).
* ``plan/kv-unspecified``      — a generative head declares no
  ``kv_bytes_per_token``, so its page pool cannot be budgeted.
"""

from __future__ import annotations

from repro_torch.analysis.diagnostics import Diagnostic, Severity
from repro_torch.core.cluster import ClusterSpec
from repro_torch.core.module import ModelSpec, ModuleSpec
from repro_torch.core.placement import Placement

_MB = 1024 ** 2

# spec fields that determine whether two tasks may legally share one
# deployed module: architecture size, deployed dtype, and the I/O
# contract (payload in, embedding out)
_SHARING_FIELDS = ("kind", "modality", "n_params", "bytes_per_param",
                   "input_bytes", "output_bytes")


def _hosts_for(placement: Placement, module: ModuleSpec,
               model: ModelSpec) -> list[str]:
    """Assignment lookup that understands both shared keys and the
    no-share strategy's model-suffixed keys."""
    hosts = placement.assignment.get(module.name)
    if hosts is None:
        hosts = placement.assignment.get(f"{module.name}::{model.name}")
    return list(hosts or ())


def check_plan(
    placement: Placement,
    cluster: ClusterSpec,
    models: list[ModelSpec],
    *,
    registry=None,                       # core.registry.ModuleRegistry | None
    placement_name: str | None = None,
    plan_opts: dict | None = None,
) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    dev_names = {d.name for d in cluster.devices}
    module_specs: dict[str, ModuleSpec] = {}
    for mdl in models:
        for m in mdl.modules:
            module_specs.setdefault(m.name, m)

    # -- strategy gave up -----------------------------------------------
    if not placement.feasible:
        for name in (placement.infeasible_modules or ["<plan>"]):
            diags.append(Diagnostic(
                Severity.ERROR, "plan/infeasible",
                f"placement strategy found no device with room for "
                f"{name!r}", entity=name,
                hint="add capacity, evict a model, or drop replication"))

    # -- sharing legality ------------------------------------------------
    diags += _check_sharing(models)

    # -- mapping completeness + host validity ----------------------------
    for mdl in models:
        for m in mdl.modules:
            hosts = _hosts_for(placement, m, mdl)
            if not hosts:
                if m.name in placement.infeasible_modules:
                    continue             # already reported as infeasible
                diags.append(Diagnostic(
                    Severity.ERROR, "plan/unmapped-module",
                    f"module {m.name!r} of model {mdl.name!r} has no "
                    f"host in the plan (assigned modules: "
                    f"{sorted(placement.assignment)})", entity=m.name,
                    hint="re-run plan() after admitting the model, or "
                         "extend the cluster"))
            seen: set[str] = set()
            for h in hosts:
                if h not in dev_names:
                    diags.append(Diagnostic(
                        Severity.ERROR, "plan/unknown-device",
                        f"module {m.name!r} is assigned to {h!r}, which "
                        f"is not in the cluster "
                        f"(devices: {sorted(dev_names)})", entity=h,
                        hint="replan() against the current cluster"))
                if h in seen:
                    diags.append(Diagnostic(
                        Severity.WARNING, "plan/duplicate-replica",
                        f"device {h!r} listed twice for module "
                        f"{m.name!r}; the ledger double-charges it",
                        entity=m.name))
                seen.add(h)

    # -- per-device memory ledger ----------------------------------------
    bytes_of = dict(placement.module_bytes)
    for key in placement.assignment:
        if key not in bytes_of:
            base = key.split("::", 1)[0]
            spec = module_specs.get(base)
            bytes_of[key] = spec.mem_bytes if spec else 0
    for dev in cluster.devices:
        used = placement.bytes_used_on(dev.name, bytes_of)
        if used > dev.mem_capacity:
            diags.append(Diagnostic(
                Severity.ERROR, "plan/memory-overflow",
                f"device {dev.name!r} ledger {used / _MB:.1f} MB exceeds "
                f"capacity {dev.mem_capacity / _MB:.1f} MB "
                f"(modules: {sorted(placement.modules_on(dev.name))})",
                entity=dev.name,
                hint="move or shrink a module, or drop a replica"))

    # -- dependency-graph acyclicity -------------------------------------
    diags += _check_acyclic(models)

    # -- route reachability ----------------------------------------------
    diags += _check_reachable(placement, cluster, models, dev_names)

    # -- registry refcount consistency -----------------------------------
    if registry is not None:
        diags += _check_refcounts(placement, registry, models)

    # -- plan-option typos -----------------------------------------------
    if placement_name and plan_opts:
        diags += _check_plan_opts(placement_name, plan_opts)

    return diags


def check_page_budget(
    placement: Placement,
    cluster: ClusterSpec,
    models: list[ModelSpec],
    *,
    decode_pages: int,
    page_size: int,
) -> list[Diagnostic]:
    """Paged-KV memory ledger for generative heads: each head's decode
    stream allocates ``decode_pages`` pages of ``page_size`` tokens, at
    ``ModuleSpec.kv_bytes_per_token`` bytes per token, resident on the
    head's host next to every module weight already placed there."""
    diags: list[Diagnostic] = []
    heads: dict[str, ModuleSpec] = {}
    for mdl in models:
        if mdl.head.generative:
            heads.setdefault(mdl.head.name, mdl.head)
    if not heads:
        return diags

    bytes_of = dict(placement.module_bytes)
    module_specs = {m.name: m for mdl in models for m in mdl.modules}
    for key in placement.assignment:
        if key not in bytes_of:
            spec = module_specs.get(key.split("::", 1)[0])
            bytes_of[key] = spec.mem_bytes if spec else 0
    cap = {d.name: d.mem_capacity for d in cluster.devices}

    for name, head in sorted(heads.items()):
        if head.kv_bytes_per_token <= 0:
            diags.append(Diagnostic(
                Severity.WARNING, "plan/kv-unspecified",
                f"generative head {name!r} declares no kv_bytes_per_token; "
                "its page pool cannot be checked against device memory",
                entity=name,
                hint="set ModuleSpec.kv_bytes_per_token = "
                     "2 * n_layers * n_kv_heads * head_dim * bytes/elt"))
            continue
        pool = decode_pages * page_size * head.kv_bytes_per_token
        for host in placement.assignment.get(name, ()):
            if host not in cap:
                continue                 # plan/unknown-device covers it
            used = placement.bytes_used_on(host, bytes_of)
            if used + pool > cap[host]:
                diags.append(Diagnostic(
                    Severity.ERROR, "plan/page-budget",
                    f"paged-KV pool of head {name!r} "
                    f"({decode_pages} pages x {page_size} tokens = "
                    f"{pool / _MB:.1f} MB) does not fit on {host!r}: "
                    f"weights already use {used / _MB:.1f} of "
                    f"{cap[host] / _MB:.1f} MB", entity=name,
                    hint="lower decode_pages/page_size in serve(), or "
                         "move the head to a larger device"))
    return diags


def _check_sharing(models: list[ModelSpec]) -> list[Diagnostic]:
    """Shared signatures must agree on shape/dtype-bearing spec fields
    across every task that reuses them (paper Insight 4: same
    architecture AND parameters)."""
    diags: list[Diagnostic] = []
    seen: dict[str, tuple[ModuleSpec, str]] = {}
    reported: set[str] = set()
    for mdl in models:
        for m in mdl.modules:
            prev = seen.setdefault(m.name, (m, mdl.name))
            if prev[0] == m or m.name in reported:
                continue
            fields = [f for f in _SHARING_FIELDS
                      if getattr(prev[0], f) != getattr(m, f)]
            diags.append(Diagnostic(
                Severity.ERROR, "plan/signature-collision",
                f"module {m.name!r} is shared by models "
                f"{prev[1]!r} and {mdl.name!r} with incompatible specs "
                f"(differ on: {', '.join(fields) or 'unknown fields'})",
                entity=m.name,
                hint="rename one module, or align the specs so sharing "
                     "is legal"))
            reported.add(m.name)
    return diags


def _check_acyclic(models: list[ModelSpec]) -> list[Diagnostic]:
    """The module dependency graph (encoder -> head, per model) must be
    a DAG, or request routing could never schedule a topological order."""
    edges: dict[str, set[str]] = {}
    for mdl in models:
        for enc in mdl.encoders:
            edges.setdefault(enc.name, set()).add(mdl.head.name)
            edges.setdefault(mdl.head.name, set())
    indeg = {n: 0 for n in edges}
    for srcs in edges.values():
        for dst in srcs:
            indeg[dst] += 1
    queue = [n for n, d in indeg.items() if d == 0]
    visited = 0
    while queue:
        n = queue.pop()
        visited += 1
        for dst in edges[n]:
            indeg[dst] -= 1
            if indeg[dst] == 0:
                queue.append(dst)
    if visited == len(edges):
        return []
    cyclic = sorted(n for n, d in indeg.items() if d > 0)
    return [Diagnostic(
        Severity.ERROR, "plan/dependency-cycle",
        f"module dependency graph has a cycle through {cyclic}",
        entity=cyclic[0] if cyclic else None,
        hint="a module cannot be an encoder downstream of its own head; "
             "split the shared signature")]


def _check_reachable(placement: Placement, cluster: ClusterSpec,
                     models: list[ModelSpec],
                     dev_names: set[str]) -> list[Diagnostic]:
    """Every encoder host must have a usable link to at least one head
    host (a link with explicit zero/negative bandwidth is a partition —
    ``t_comm`` would divide by zero at runtime)."""

    def bw(src: str, dst: str) -> float:
        if src == dst:
            return float("inf")
        link = cluster.links.get((src, dst), cluster.links.get((dst, src)))
        return link[0] if link else cluster.default_bandwidth

    diags: list[Diagnostic] = []
    for mdl in models:
        head_hosts = [h for h in _hosts_for(placement, mdl.head, mdl)
                      if h in dev_names]
        if not head_hosts:
            continue                     # unmapped-module already covers it
        for enc in mdl.encoders:
            for h in _hosts_for(placement, enc, mdl):
                if h not in dev_names:
                    continue
                if all(bw(h, g) <= 0 for g in head_hosts):
                    diags.append(Diagnostic(
                        Severity.ERROR, "plan/unreachable-route",
                        f"encoder {enc.name!r} on {h!r} cannot reach any "
                        f"head host {head_hosts} of model {mdl.name!r}: "
                        "all links have zero bandwidth", entity=h,
                        hint="fix the link matrix or co-locate the "
                             "encoder with the head"))
    return diags


def _check_refcounts(placement: Placement, registry,
                     models: list[ModelSpec]) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    live = {m.name for mdl in models for m in mdl.modules}
    for name in registry.modules:
        refs = registry.refcount(name)
        placed = len(placement.assignment.get(name, ()))
        if refs > 0 and placed == 0 and name not in \
                placement.infeasible_modules:
            # suffixed no-share keys satisfy the per-model check above
            # but the registry check is only meaningful for shared keys
            if any(k.startswith(f"{name}::") for k in placement.assignment):
                continue
            diags.append(Diagnostic(
                Severity.ERROR, "plan/refcount-mismatch",
                f"module {name!r} is referenced by {refs} model(s) but "
                f"placed on 0 devices", entity=name,
                hint="re-run plan() — the placement predates the last "
                     "add_model()"))
    for key in placement.assignment:
        base = key.split("::", 1)[0]
        if base not in live and registry.refcount(base) == 0:
            diags.append(Diagnostic(
                Severity.WARNING, "plan/stale-assignment",
                f"placement still assigns {key!r} but no live model "
                f"references it", entity=key,
                hint="evict() should have dropped it; re-run plan()"))
    return diags


def _check_plan_opts(placement_name: str,
                     plan_opts: dict) -> list[Diagnostic]:
    from repro_torch.s2m3.policies import get_placement, strategy_options

    try:
        fn = get_placement(placement_name)
    except KeyError:
        return [Diagnostic(
            Severity.ERROR, "plan/unknown-strategy",
            f"placement strategy {placement_name!r} is not registered",
            entity=placement_name)]
    known = strategy_options(fn)
    if known is None:                    # open **kwargs: not checkable
        return []
    unknown = sorted(set(plan_opts) - set(known))
    return [Diagnostic(
        Severity.WARNING, "plan/unknown-option",
        f"plan option {o!r} is not accepted by strategy "
        f"{placement_name!r} (known: {sorted(known)}); it was silently "
        "ignored", entity=o,
        hint="fix the kwarg name in plan()") for o in unknown]
