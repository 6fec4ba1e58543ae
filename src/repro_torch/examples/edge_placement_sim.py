"""Reproduce the paper's testbed numbers through the ``s2m3.Deployment``
facade and render the Fig. 3 timeline.

    PYTHONPATH=src python -m repro_torch.examples.edge_placement_sim
"""

from repro_torch.core.module import distinct_modules
from repro_torch.core.profiles import install_profile, make_testbed
from repro_torch.core.routing import timeline_ascii
from repro_torch.core.zoo import paper_zoo, request_for
from repro_torch.s2m3 import Deployment


def main():
    zoo = paper_zoo()
    clip = zoo["clip-vit-b/16"]
    cluster = make_testbed(with_server=True)
    install_profile(cluster, distinct_modules(list(zoo.values())).values())
    edge = cluster.without("server")
    reqs = [request_for(clip, 0, "jetson-a")]

    print("== CLIP ViT-B/16, image-text retrieval (paper Table VII) ==")
    dep = Deployment(edge).add_model(clip).plan("greedy", routing="paper")
    print(f"greedy placement: {dep.placement.assignment}")
    res = dep.simulate(reqs)
    print(f"S2M3 edge-only:     {res.mean_latency:6.2f} s  (paper 2.48)")
    central = Deployment(cluster).add_model(clip)
    for dev, paper in [("server", 2.44), ("desktop", 3.46),
                       ("laptop", 3.02), ("jetson-a", 45.19)]:
        t = central.plan("centralized", routing="paper",
                         device=dev).simulate(reqs).mean_latency
        print(f"centralized {dev:10s}: {t:6.2f} s  (paper {paper})")
    t_up = dep.plan("optimal", routing="paper",
                    workload=reqs).simulate(reqs).mean_latency
    print(f"Upper (brute force): {t_up:6.2f} s")

    print("\n== Fig. 3 timeline (S2M3, edge-only) ==")
    print(timeline_ascii(res.sim))

    print("\n== Table X: incremental multi-task deployment ==")
    multi = Deployment(edge)
    for name in ("clip-vit-b/16", "encoder-only-vqa-s", "alignment-vit-b",
                 "clip-cls-vit-b/16"):
        before = set(multi.registry.modules)
        multi.add_model(zoo[name])
        new = [m for m in multi.registry.modules if m not in before]
        print(f"+{name:22s} loads {new or 'NOTHING (all shared)'}"
              f" -> total {multi.registry.shared_bytes()/4/1e6:.0f}M params "
              f"(dedicated would be {multi.registry.dedicated_bytes()/4/1e6:.0f}M)")
    report = multi.plan("greedy", routing="paper").report()
    print(f"sharing saving: {report.sharing_savings:.1%}  (paper: 61.5%)")


if __name__ == "__main__":
    main()
