"""Module placement (paper §V-B, Algorithm 1 lines 1–13) + baselines.

``greedy_place`` is the paper's algorithm: modules in descending memory
order; encoders to the device minimizing *completion time* (Eq. 5 —
compute time plus accumulated compute of modules already on the device),
heads to the device minimizing pure compute time (Eq. 6); first fit that
satisfies the memory constraint (Eq. 4d).  An optional replication pass
fills leftover memory with copies of the largest modules (paper: "If we
have remaining resources, we replicate the modules with larger memory
requirements").

``optimal_place`` is the paper's *Upper* baseline: brute-force
enumeration minimizing simulated total latency — exact but exponential;
only for small instances (the paper's testbed is 5 devices × ≤4 modules).
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from repro_torch.core.cluster import ClusterSpec, DeviceSpec
from repro_torch.core.module import ModelSpec, ModuleSpec, distinct_modules


@dataclass
class Placement:
    # module signature -> list of device names hosting a replica
    assignment: dict[str, list[str]] = field(default_factory=dict)
    feasible: bool = True
    infeasible_modules: list[str] = field(default_factory=list)
    # per-module deployed bytes, keyed like ``assignment`` (filled by the
    # placement strategies; lets reports compute per-device ledgers even
    # for no-share placements whose keys are model-suffixed)
    module_bytes: dict[str, int] = field(default_factory=dict)

    def devices_for(self, module_name: str) -> list[str]:
        return self.assignment.get(module_name, [])

    def modules_on(self, device_name: str) -> list[str]:
        return [m for m, devs in self.assignment.items() if device_name in devs]

    def bytes_on(self, device_name: str, modules: dict[str, ModuleSpec]) -> int:
        return sum(modules[m].mem_bytes for m in self.modules_on(device_name))

    def bytes_used_on(self, device_name: str,
                      module_bytes: dict[str, int] | None = None) -> int:
        """Ledger bytes a device carries, from a bytes-per-key map
        (defaults to ``self.module_bytes``; unknown keys count 0)."""
        mb = module_bytes if module_bytes is not None else self.module_bytes
        return sum(mb.get(m, 0) for m in self.modules_on(device_name))

    def ledger(self, devices,
               module_bytes: dict[str, int] | None = None
               ) -> dict[str, dict[str, int]]:
        """Per-device used/capacity/free memory ledger — the single
        source of truth behind ``PlanReport.memory`` and the static
        ``repro_torch.analysis`` plan verifier."""
        out = {}
        for dev in devices:
            used = self.bytes_used_on(dev.name, module_bytes)
            out[dev.name] = {"used": used, "capacity": dev.mem_capacity,
                             "free": dev.mem_capacity - used}
        return out

    def max_device_bytes(self, modules: dict[str, ModuleSpec]) -> int:
        devs = {d for lst in self.assignment.values() for d in lst}
        if not devs:
            return 0
        return max(self.bytes_on(d, modules) for d in devs)


def expected_work(models: list[ModelSpec]) -> dict[str, float]:
    """Per-module expected request-work multiplicity (the paper's
    *measured* t_comp folds the task workload in — e.g. the retrieval
    text encoder runs ~100 candidate prompts per request, footnote 2)."""
    from repro_torch.core.zoo import TASK_WORK

    acc: dict[str, list[float]] = {}
    for mdl in models:
        work = dict(TASK_WORK.get(mdl.task, ()))
        for m in mdl.encoders:
            acc.setdefault(m.name, []).append(work.get(m.modality, 1.0))
        acc.setdefault(mdl.head.name, []).append(1.0)
    return {k: sum(v) / len(v) for k, v in acc.items()}


def _work_adjusted(module: ModuleSpec, dev: DeviceSpec, cluster: ClusterSpec,
                   work: dict[str, float]) -> float:
    w = work.get(module.name, 1.0)
    rho = getattr(dev, "extra_work_factor", 1.0)
    return cluster.t_comp(module, dev) * (1.0 + (w - 1.0) * rho)


def _completion_time(module: ModuleSpec, dev: DeviceSpec, cluster: ClusterSpec,
                     placed: dict[str, list[ModuleSpec]],
                     work: dict[str, float]) -> float:
    """Eq. 5 (encoders) / Eq. 6 (heads), with workload-inclusive times."""
    t = _work_adjusted(module, dev, cluster, work)
    if module.kind == "encoder":
        t += sum(_work_adjusted(m, dev, cluster, work)
                 for m in placed.get(dev.name, []))
    return t


def greedy_place(
    models: list[ModelSpec],
    cluster: ClusterSpec,
    *,
    share: bool = True,
    replicate: bool = False,
) -> Placement:
    """Algorithm 1 (placement half).

    share=False deploys a dedicated copy of every module per model (the
    paper's non-sharing ablation, Table X): signatures are suffixed with
    the model name so nothing dedups.
    """
    work = expected_work(models)
    if share:
        modules = distinct_modules(models)
    else:
        modules = {}
        for mdl in models:
            for m in mdl.modules:
                import dataclasses as _dc

                key = f"{m.name}::{mdl.name}"
                modules[key] = _dc.replace(m, name=key)

    remaining = {d.name: d.mem_capacity for d in cluster.devices}
    placed: dict[str, list[ModuleSpec]] = {}
    out = Placement(module_bytes={k: m.mem_bytes for k, m in modules.items()})

    # line 3: descending memory requirement
    order = sorted(modules.values(), key=lambda m: -m.mem_bytes)
    for m in order:
        # line 4: devices ascending by completion time
        ranked = sorted(
            cluster.devices,
            key=lambda d: _completion_time(m, d, cluster, placed, work),
        )
        for dev in ranked:                      # lines 5-11: first fit
            if m.mem_bytes <= remaining[dev.name]:
                out.assignment.setdefault(m.name, []).append(dev.name)
                remaining[dev.name] -= m.mem_bytes
                placed.setdefault(dev.name, []).append(m)
                break
        else:
            out.feasible = False
            out.infeasible_modules.append(m.name)

    if replicate:
        # fill leftover memory with replicas of the largest modules
        for m in order:
            for dev in cluster.devices:
                if (dev.name not in out.assignment.get(m.name, ())
                        and m.mem_bytes <= remaining[dev.name]):
                    out.assignment[m.name].append(dev.name)
                    remaining[dev.name] -= m.mem_bytes
                    placed.setdefault(dev.name, []).append(m)
    return out


def centralized_place(models: list[ModelSpec], cluster: ClusterSpec,
                      device_name: str) -> Placement:
    """Everything on one device (the paper's Cloud / Local baselines)."""
    modules = distinct_modules(models)
    dev = cluster.device(device_name)
    total = sum(m.mem_bytes for m in modules.values())
    out = Placement(
        assignment={m: [device_name] for m in modules},
        module_bytes={k: m.mem_bytes for k, m in modules.items()})
    if total > dev.mem_capacity:
        out.feasible = False
        out.infeasible_modules = list(modules)
    return out


def optimal_place(
    models: list[ModelSpec],
    cluster: ClusterSpec,
    workload,                       # list[Request] — evaluated by routing sim
    *,
    max_nodes: int = 8,
) -> tuple[Placement, float]:
    """Brute-force 'Upper' baseline: minimize simulated total latency."""
    from repro_torch.core.routing import simulate

    modules = list(distinct_modules(models).values())
    if len(modules) * len(cluster.devices) > max_nodes * 8:
        # guard: enumeration is |N|^{|M|}
        raise ValueError(
            f"optimal_place would enumerate {len(cluster.devices)}^"
            f"{len(modules)} assignments (modules x devices = "
            f"{len(modules) * len(cluster.devices)} > {max_nodes * 8}); "
            "raise max_nodes or use the greedy strategy")
    best, best_t = None, float("inf")
    names = [d.name for d in cluster.devices]
    caps = {d.name: d.mem_capacity for d in cluster.devices}
    for combo in itertools.product(names, repeat=len(modules)):
        used: dict[str, int] = {}
        ok = True
        for m, dev in zip(modules, combo):
            used[dev] = used.get(dev, 0) + m.mem_bytes
            if used[dev] > caps[dev]:
                ok = False
                break
        if not ok:
            continue
        pl = Placement(
            assignment={m.name: [dev] for m, dev in zip(modules, combo)},
            module_bytes={m.name: m.mem_bytes for m in modules})
        result = simulate(workload, pl, cluster, models)
        if result.total_latency < best_t:
            best, best_t = pl, result.total_latency
    if best is None:
        return Placement(feasible=False), float("inf")
    return best, best_t


def replan(
    models: list[ModelSpec],
    old_cluster: ClusterSpec,
    new_cluster: ClusterSpec,
    old: Placement,
    *,
    place=None,
) -> tuple[Placement, list[tuple[str, str]]]:
    """Elastic reallocation (paper §VI-C "dynamic network conditions").

    Re-runs the placement (``place(models, cluster)``, default greedy) on
    the new device pool and returns (placement, migrations) where
    migrations lists (module, new_device) pairs that require a load —
    modules already resident stay put when the strategy re-chooses their
    device, so the migration set is the switching cost.
    """
    new = (place or greedy_place)(models, new_cluster)
    migrations = []
    for mod, devs in new.assignment.items():
        for d in devs:
            if d not in old.assignment.get(mod, ()):
                migrations.append((mod, d))
    return new, migrations
