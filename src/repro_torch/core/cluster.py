"""Device pool and link model.

A ``DeviceSpec`` is anything that can host modules: an edge device from
the paper's testbed (Table III) or a GPU sub-mesh (core/pod.py).
``t_comp(module, device)`` resolution order: explicit measured table
(paper calibration) -> flops/effective-speed fallback.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.module import ModuleSpec


@dataclass(frozen=True)
class DeviceSpec:
    name: str
    mem_capacity: int            # bytes available for module weights
    compute_speed: float         # effective FLOP/s for the fallback model
    kind: str = "edge"           # edge | server | submesh
    # marginal cost of additional same-module queries relative to the
    # first (batched backends amortize: rho < 1; a thrashing 4 GB Jetson
    # is super-linear: rho > 1).  Routing applies
    # t = t_comp * (1 + (work - 1) * rho).
    extra_work_factor: float = 1.0


@dataclass
class ClusterSpec:
    devices: list[DeviceSpec]
    # (src_name, dst_name) -> (bandwidth bytes/s, latency s); missing ->
    # default link.  src == dst -> zero-cost.
    links: dict[tuple[str, str], tuple[float, float]] = field(default_factory=dict)
    default_bandwidth: float = 12.5e6      # 100 Mbps home network
    default_latency: float = 0.005
    # measured per-(module, device) compute seconds (paper calibration)
    comp_table: dict[tuple[str, str], float] = field(default_factory=dict)

    def device(self, name: str) -> DeviceSpec:
        for d in self.devices:
            if d.name == name:
                return d
        raise KeyError(name)

    def t_comm(self, src: str, dst: str, nbytes: float) -> float:
        if src == dst:
            return 0.0
        bw, lat = self.links.get(
            (src, dst), self.links.get((dst, src),
                                       (self.default_bandwidth,
                                        self.default_latency)))
        return lat + nbytes / bw

    def t_comp(self, module: ModuleSpec, device: DeviceSpec) -> float:
        key = (module.name, device.name)
        if key in self.comp_table:
            return self.comp_table[key]
        if module.flops_per_query <= 0:
            # parameter-free heads (cosine similarity / InfoNCE): negligible
            return 1e-4
        return module.flops_per_query / device.compute_speed

    def without(self, *names: str) -> "ClusterSpec":
        """Cluster with devices removed (availability scenarios, Table IX)."""
        keep = [d for d in self.devices if d.name not in names]
        return ClusterSpec(
            devices=keep, links=self.links,
            default_bandwidth=self.default_bandwidth,
            default_latency=self.default_latency, comp_table=self.comp_table,
        )

    def with_device(self, dev: DeviceSpec) -> "ClusterSpec":
        return ClusterSpec(
            devices=[*self.devices, dev], links=self.links,
            default_bandwidth=self.default_bandwidth,
            default_latency=self.default_latency, comp_table=self.comp_table,
        )
