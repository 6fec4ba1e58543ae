"""S2M3 on H100 sub-meshes (``repro_torch.core.pod``): the reference's
``tests/test_tpu_cluster.py`` with H100 figures, the NVLink / InfiniBand
link choice, and parity with the reference's ``core/tpu.py`` given a
reference ``ChipSpec`` filled with the same H100 figures.  The same node
model in the dry run: a collective over a group that spans nodes is
counted as inter-node and charged at the NIC's rate, and
``load_dryrun_t_comp`` reads a dry-run record at the pod's bfloat16
peak."""

import json

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.common.hw import ChipSpec as RefChip
from repro.core import placement as ref_placement
from repro.core import tpu as ref_tpu
from repro.core import zoo as ref_zoo
from repro_torch.common import sharding
from repro_torch.common.config import ShapeConfig, get_config
from repro_torch.common.hw import DEFAULT_CHIP, H100_SXM, roofline_terms
from repro_torch.common.profiling import measure
from repro_torch.core.module import ModuleSpec
from repro_torch.core.placement import greedy_place
from repro_torch.core.pod import (
    install_roofline_profile, load_dryrun_t_comp, pod_cluster,
    roofline_t_comp,
)
from repro_torch.core.routing import Request, simulate
from repro_torch.core.zoo import arch_model_spec, paper_zoo
from repro_torch.launch import dryrun

NVLINK = 18 * 25e9          # a card's NVLink 4 links, one direction
NIC = 50e9                  # one 400 Gb/s NDR InfiniBand NIC a card


def test_h100_node_figures():
    assert DEFAULT_CHIP is H100_SXM
    assert H100_SXM.gpus_per_node == 8 and H100_SXM.nic_bandwidth == NIC
    assert H100_SXM.links * H100_SXM.link_bandwidth == NVLINK


def test_pod_cluster_partitions():
    cluster = pod_cluster([64, 64, 64, 64])
    assert len(cluster.devices) == 4
    assert all(d.kind == "submesh" for d in cluster.devices)
    # 64 GPUs x 80 GB each
    assert cluster.devices[0].mem_capacity == 64 * 80e9
    assert cluster.devices[0].compute_speed == pytest.approx(
        64 * 989e12 * 0.4)
    # InfiniBand between sub-meshes on different nodes, and fast
    t = cluster.t_comm(cluster.devices[0].name, cluster.devices[1].name, 1e9)
    assert t == pytest.approx(1e-5 + 1e9 / (64 * NIC))
    assert t < 0.01
    assert cluster.default_bandwidth == NIC


def test_nvlink_within_a_node_infiniband_across():
    """[4, 4, 8, 2, 6]: GPUs 0-3 and 4-7 share node 0 (NVLink); 8-15 is
    node 1 alone; 16-17 and 18-23 share node 2."""
    cluster = pod_cluster([4, 4, 8, 2, 6])
    names = [d.name for d in cluster.devices]
    bw = {(a, b): v[0] for (a, b), v in cluster.links.items()}
    assert bw[(names[0], names[1])] == 4 * NVLINK
    assert bw[(names[3], names[4])] == 2 * NVLINK
    assert bw[(names[1], names[2])] == 4 * NIC
    assert bw[(names[2], names[3])] == 2 * NIC
    assert bw[(names[0], names[4])] == 4 * NIC
    # a partition that spills into the next node shares it
    spill = pod_cluster([4, 8, 4])
    n = [d.name for d in spill.devices]
    assert spill.links[(n[0], n[1])][0] == 4 * NVLINK
    assert spill.links[(n[1], n[2])][0] == 4 * NVLINK
    assert spill.links[(n[0], n[2])][0] == 4 * NIC
    assert all(lat == 1e-5 for _, lat in cluster.links.values())


def test_roofline_t_comp_picks_binding_term():
    small_hot = ModuleSpec("hot", "encoder", "vision", int(1e6),
                           flops_per_query=1e15)   # compute-bound
    big_cold = ModuleSpec("cold", "head", "task", int(20e9),
                          flops_per_query=1e9)     # memory-bound
    t_hot = roofline_t_comp(small_hot, n_chips=64)
    t_cold = roofline_t_comp(big_cold, n_chips=64)
    assert t_hot == pytest.approx(1e15 / (64 * 989e12))
    assert t_cold == pytest.approx(40e9 / (64 * 3.35e12))


def _profiled(cluster, models):
    return install_roofline_profile(
        cluster, {m.name: m for mdl in models for m in mdl.modules}.values())


def test_s2m3_places_paper_zoo_on_a_pod():
    """The paper's whole 14-model zoo fits one 256-GPU pod split 4 ways,
    with every module placed and sharing deduped."""
    models = list(paper_zoo().values())
    cluster = _profiled(pod_cluster([64, 64, 64, 64]), models)
    pl = greedy_place(models, cluster)
    assert pl.feasible
    res = simulate([Request(0, "llava-v1.5-13b", cluster.devices[0].name)],
                   pl, cluster, models)
    assert res.feasible and res.mean_latency < 1.0   # sub-second on a pod


def test_assigned_archs_place_alongside_zoo():
    models = list(paper_zoo().values()) + [
        arch_model_spec(get_config("internvl2-1b")),
        arch_model_spec(get_config("whisper-tiny"))]
    cluster = _profiled(pod_cluster([128, 64, 64]), models)
    pl = greedy_place(models, cluster)
    assert pl.feasible
    res = simulate([Request(0, "internvl2-1b", cluster.devices[0].name)],
                   pl, cluster, models)
    assert res.feasible


@pytest.mark.parametrize("partitions", [[64, 64, 64, 64], [128, 64, 64],
                                        [8, 8, 16, 224]])
def test_pod_matches_reference_with_h100_figures(partitions):
    """The reference's ``core/tpu.py`` given a ``ChipSpec`` of the same
    H100 figures: equal device capacities and compute speeds, equal
    roofline tables, and the same greedy placement."""
    chip = RefChip(name="h100_sxm", peak_flops_bf16=H100_SXM.peak_flops_bf16,
                   hbm_bandwidth=H100_SXM.hbm_bandwidth,
                   hbm_bytes=H100_SXM.hbm_bytes,
                   ici_bandwidth=H100_SXM.nic_bandwidth,
                   ici_links=H100_SXM.links)
    ref_models = list(ref_zoo.paper_zoo().values())
    ref = ref_tpu.pod_cluster(partitions, chip=chip)
    ref_tpu.install_roofline_profile(
        ref, {m.name: m for mdl in ref_models for m in mdl.modules}.values(),
        chip)
    models = list(paper_zoo().values())
    got = _profiled(pod_cluster(partitions), models)
    assert [(d.name, d.mem_capacity, d.compute_speed, d.kind)
            for d in got.devices] == [
        (d.name, d.mem_capacity, d.compute_speed, d.kind)
        for d in ref.devices]
    assert got.comp_table == ref.comp_table
    pl = greedy_place(models, got)
    ref_pl = ref_placement.greedy_place(ref_models, ref)
    assert pl.feasible == ref_pl.feasible
    assert pl.assignment == ref_pl.assignment


def test_collectives_over_groups_that_span_nodes_are_inter_node():
    """On a (2, 8) mesh of 16 ranks, "model" groups ranks 0-7 (one node)
    and "data" groups ranks 0 and 8 (two nodes): only the latter's bytes
    are inter-node, for the in-place c10d ops and DTensor's functional
    collectives alike, and the roofline charges them at the NIC."""
    with dryrun.fake_group(16):
        mesh = sharding.local_mesh((2, 8), device="cpu")
        x = torch.zeros(4, device="meta")                        # 16 B
        d = DTensor.from_local(torch.zeros(4, device="meta"), mesh,
                               [Shard(0), Replicate()], run_check=False)

        def step(t, dt):
            a = sharding.all_reduce(t, mesh, "model")            # intra
            b = sharding.all_reduce(a, mesh, "data")             # inter
            g = dt.redistribute(mesh, [Replicate(), Replicate()])  # inter
            return b, g

        _, rep = measure(step, x, d)
    assert rep.count_by_op == {"all-reduce": 2, "all-gather": 1}
    assert rep.collective_bytes == 16 + 16 + 32
    assert rep.inter_node_bytes == 16 + 32
    t = roofline_terms(0.0, 0.0, rep.collective_bytes, "float32",
                       inter_node_bytes=rep.inter_node_bytes)
    assert t["t_collective_s"] == pytest.approx(16 / NVLINK + 48 / NIC)
    assert t["peak_dtype"] == "float32"


def test_load_dryrun_t_comp_reads_a_record_at_the_pod_peak(tmp_path,
                                                          monkeypatch):
    """A dry-run record, as ``launch.dryrun`` writes it, read back at the
    bfloat16 peak that ``roofline_t_comp`` uses; absent or skipped cells
    give None."""
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    with dryrun.fake_group(4):
        mesh = sharding.local_mesh((2, 2), device="cpu")
        rec = dryrun.lay_out(get_config("tinyllama-1.1b", smoke=True),
                             ShapeConfig("t", "train", 32, 8), mesh)
    (tmp_path / "tinyllama-1.1b__t__pod16x16.json").write_text(
        json.dumps(rec))
    (tmp_path / "zamba2-7b__t__pod16x16.json").write_text(
        json.dumps({"skipped": get_config("tinyllama-1.1b").skip_reason}))
    coll = rec["collectives"]
    assert coll["inter_node_bytes"] == 0            # four ranks: one node
    want = max(rec["cost"]["flops"] / H100_SXM.peak_flops_bf16,
               rec["cost"]["bytes"] / H100_SXM.hbm_bandwidth,
               coll["total_bytes"] / NVLINK)
    assert load_dryrun_t_comp("tinyllama-1.1b", "t") == pytest.approx(want)
    assert rec["roofline"]["peak_dtype"] == "bfloat16"
    assert rec["roofline"]["roofline_s"] == pytest.approx(want)
    assert load_dryrun_t_comp("zamba2-7b", "t") is None
    assert load_dryrun_t_comp("tinyllama-1.1b", "t", "multipod2x16x16") \
        is None
