"""S2M3 on an H100 pod: sub-meshes as devices, roofline-derived t_comp.

The counterpart of the reference's ``core/tpu.py``.  A pod of H100 nodes
is partitioned into sub-meshes; each sub-mesh is a ``DeviceSpec`` whose
memory is its cards' aggregate HBM and whose compute model comes from
the three-term roofline (``common/hw.py``) rather than wall-clock
measurement, so the paper's greedy placement and parallel routing run
unchanged: the algorithms are measurement-agnostic.

The model, every figure from ``common.hw.H100_SXM`` (published, not
measured: NVIDIA's H100 and DGX H100 datasheets):

* a sub-mesh of n GPUs holds n x 80 GB and computes at n x 989e12 x
  ``mfu`` FLOP/s (the dense bf16 tensor-core peak, discounted to a
  serving efficiency);
* partitions are packed in order onto nodes of ``gpus_per_node`` = 8;
* two sub-meshes with a node in common talk over NVLink at
  min(n_i, n_j) x 18 links x 25e9 B/s; any other pair over InfiniBand at
  min(n_i, n_j) x 50e9 B/s (one 400 Gb/s NIC a GPU); every link's
  latency is 1e-5 s, as in the reference, and the cluster's default
  bandwidth is one NIC's.

The production pod is 256 GPUs (32 nodes), the size of
``launch.mesh.make_production_mesh``.  Module compute estimates use the
dry run's roofline where its artifact exists (``results/dryrun_torch``,
``launch.dryrun``), falling back to the analytic one.
"""

from __future__ import annotations

import json
from dataclasses import dataclass

from repro_torch.common.hw import DEFAULT_CHIP, ChipSpec, roofline_terms
from repro_torch.core.cluster import ClusterSpec, DeviceSpec
from repro_torch.core.module import ModuleSpec

LATENCY_S = 1e-5


@dataclass(frozen=True)
class SubMesh:
    name: str
    n_chips: int
    chip: ChipSpec = DEFAULT_CHIP

    @property
    def hbm_bytes(self) -> int:
        return int(self.n_chips * self.chip.hbm_bytes)

    @property
    def flops(self) -> float:
        return self.n_chips * self.chip.peak_flops_bf16


def _nodes(start: int, n: int, per_node: int) -> set[int]:
    """The nodes GPUs [start, start + n) sit on."""
    return set(range(start // per_node, (start + n - 1) // per_node + 1))


def pod_cluster(
    partitions: list[int],
    *,
    chip: ChipSpec = DEFAULT_CHIP,
    mfu: float = 0.4,
) -> ClusterSpec:
    """Partition a pod into sub-meshes, e.g. [64, 64, 64, 64] for a 256-GPU
    pod split four ways, packed in order onto nodes.  ``mfu`` discounts
    peak FLOP/s to a realistic serving efficiency for the fallback
    compute model."""
    devices, nodes, start = [], [], 0
    for i, n in enumerate(partitions):
        sm = SubMesh(f"submesh{i}x{n}", n, chip)
        devices.append(DeviceSpec(
            name=sm.name, mem_capacity=sm.hbm_bytes,
            compute_speed=sm.flops * mfu, kind="submesh"))
        nodes.append(_nodes(start, n, chip.gpus_per_node))
        start += n
    links = {}
    for i in range(len(partitions)):
        for j in range(i + 1, len(partitions)):
            per_gpu = (chip.links * chip.link_bandwidth if nodes[i] & nodes[j]
                       else chip.nic_bandwidth)
            links[(devices[i].name, devices[j].name)] = (
                min(partitions[i], partitions[j]) * per_gpu, LATENCY_S)
    return ClusterSpec(devices=devices, links=links,
                       default_bandwidth=chip.nic_bandwidth,
                       default_latency=LATENCY_S)


def roofline_t_comp(module: ModuleSpec, n_chips: int,
                    chip: ChipSpec = DEFAULT_CHIP) -> float:
    """max(compute, memory) term for one query on an n-GPU sub-mesh."""
    flops = module.flops_per_query
    byts = module.mem_bytes          # weights stream once per query (bs=1)
    t_comp = flops / (n_chips * chip.peak_flops_bf16)
    t_mem = byts / (n_chips * chip.hbm_bandwidth)
    return max(t_comp, t_mem)


def install_roofline_profile(cluster: ClusterSpec, modules,
                             chip: ChipSpec = DEFAULT_CHIP) -> ClusterSpec:
    chips_of = {d.name: int(d.name.rsplit("x", 1)[1]) for d in cluster.devices}
    for m in modules:
        for d in cluster.devices:
            cluster.comp_table[(m.name, d.name)] = roofline_t_comp(
                m, chips_of[d.name], chip)
    return cluster


def load_dryrun_t_comp(arch: str, shape: str, mesh: str = "pod16x16"):
    """Roofline seconds of a dry-run artifact (``launch.dryrun.OUT_DIR``),
    if present, at this model's one peak: the artifact's counts under
    ``common.hw.roofline_terms`` with compute at the bfloat16
    tensor-core peak, as ``roofline_t_comp`` and ``SubMesh.flops`` count
    (the artifact's own ``roofline`` is at the peak of the cell's compute
    dtype, which is bfloat16, the reference's default, so the two
    agree)."""
    from repro_torch.launch.dryrun import OUT_DIR

    f = OUT_DIR / f"{arch}__{shape}__{mesh}.json"
    if not f.exists():
        return None
    data = json.loads(f.read_text())
    if "cost" not in data:                       # a skipped cell
        return None
    coll = data["collectives"]
    return roofline_terms(
        data["cost"]["flops"], data["cost"]["bytes"], coll["total_bytes"],
        "bfloat16", inter_node_bytes=coll["inter_node_bytes"])["roofline_s"]
