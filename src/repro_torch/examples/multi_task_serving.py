"""S2M3 end-to-end serving example (the paper's scenario, real compute).

Everything goes through the ``s2m3.Deployment`` facade: admit THREE
multi-modal tasks that share encoders (retrieval / classification / VQA
with a tiny answer head) on the mini-clip towers, plan a greedy
placement over 4 logical devices, materialize them on the card, then
drive the SAME ``Request`` objects through the latency simulator and
the live engine — predicted routes and real routes line up, and the
sharing ledger shows the dedup savings.  The serve() pass then shows
the observability layer: per-task SLO-attainment summary, a
Chrome-trace export of the request span trees, and a ``dep.compare()``
drift report.  Last, a task is evicted and a device removed (replan).

    PYTHONPATH=src python -m repro_torch.examples.multi_task_serving
    PYTHONPATH=src python -m repro_torch.examples.multi_task_serving \
        --device cpu --trace /tmp/multi_task_trace.json

Every placement host maps onto the one device (the card unless
``--device`` names another); routes stay keyed by placement name.  The
tower attention runs through the flash kernel on the card and through
its plain version on the CPU.  Weights come from ``torch.Generator``
seed 0, inputs from numpy seed 1.
"""

from __future__ import annotations

import argparse
import copy
from functools import partial

import numpy as np
import torch

from repro_torch.analysis import format_report
from repro_torch.analysis.plan_check import check_plan
from repro_torch.common.device import resolve_device
from repro_torch.configs.s2m3_zoo import get_clip_config
from repro_torch.core.cluster import ClusterSpec, DeviceSpec
from repro_torch.core.module import ModelSpec, ModuleSpec
from repro_torch.models import clip as C
from repro_torch.obs import format_slo_summary, slo_summary
from repro_torch.s2m3 import Deployment, Request

GB = 1024**3
N_DEVICES = 4


def build_deployment(device, *, materialize: bool = True):
    """The three tasks' specs and builders on the mini-clip towers,
    admitted, planned (greedy, paper routing) and — unless
    ``materialize`` is false — materialized on ``device``.  Returns
    (deployment, pool, clip params, clip config)."""
    ccfg = get_clip_config("mini-clip")
    gen = torch.Generator(device=device).manual_seed(0)
    params = C.init_clip(gen, ccfg, device)

    # ---- module & model specs (Table II in miniature) ----
    vis = ModuleSpec("mini-vit", "encoder", "vision", 60_000,
                     flops_per_query=2e6)
    txt = ModuleSpec("mini-trf", "encoder", "text", 50_000,
                     flops_per_query=1e6)
    cos = ModuleSpec("cosine", "head", "task", 0)
    cls = ModuleSpec("mini-classifier", "head", "task", 1_000,
                     flops_per_query=1e4)
    lm = ModuleSpec("mini-lm", "head", "task", 80_000, flops_per_query=4e6)

    retrieval = ModelSpec("retrieval", "retrieval", (vis, txt), cos)
    classify = ModelSpec("classify", "classification", (vis,), cls)
    vqa = ModelSpec("vqa", "vqa-dec", (vis, txt), lm)

    w_cls = torch.randn(ccfg.embed_dim, 10, generator=gen, device=device)
    w_lm = 0.3 * torch.randn(2 * ccfg.embed_dim, 32, generator=gen,
                             device=device)

    def lm_apply(p, enc):
        h = torch.cat([enc["vision"], enc["text"]], -1)
        return torch.argmax(h @ p, -1)        # toy "answer tokens"

    builders = {
        "mini-vit": lambda: (partial(C.encode_image, cfg=ccfg), params["vision"]),
        "mini-trf": lambda: (partial(C.encode_text, cfg=ccfg), params["text"]),
        "cosine": lambda: (
            lambda p, enc: C.retrieval_logits(enc["vision"], enc["text"], p),
            params["logit_scale"]),
        "mini-classifier": lambda: (lambda p, enc: enc["vision"] @ p, w_cls),
        "mini-lm": lambda: (lm_apply, w_lm),
    }

    # ---- one facade call chain: admit -> plan -> materialize ----
    pool = ClusterSpec(devices=[
        DeviceSpec(f"dev{i}", 1 * GB, (2.0 if i < 2 else 1.0) * 1e9)
        for i in range(N_DEVICES)
    ])
    dep = (Deployment(pool)
           .add_model(retrieval, builders)
           .add_model(classify)
           .add_model(vqa)
           .plan(placement="greedy", routing="paper"))
    if materialize:
        dep.materialize(device=device)
    return dep, pool, params, ccfg


def make_inputs(ccfg):
    """4 stub image-patch sets and 4 token rows of 12, from numpy seed 1."""
    rng = np.random.default_rng(1)
    patches = rng.standard_normal(
        (4, ccfg.n_image_tokens, ccfg.vision_width)).astype(np.float32)
    ids = rng.integers(0, ccfg.vocab_size, (4, 12)).astype(np.int32)
    return patches, ids


def _max_diff(a, b) -> float:
    return float((torch.as_tensor(a).float().cpu()
                  - torch.as_tensor(b).float().cpu()).abs().max())


def main(device=None, trace_path=None) -> dict:
    """Run the scenario on ``device`` (the card unless the caller names
    another), writing the serve() trace to ``trace_path`` if given, and
    return what the callers check: the deployment, (simulated, real)
    route pairs, verify()'s findings and the tampered ledger's first,
    the split-vs-monolithic and batched-vs-solo differences, the
    cross-task batches, the SLO rows, the drift report, the evicted
    modules and the retrieval result after the replan."""
    device = resolve_device(device)
    print(f"running on {device} ({N_DEVICES} placement hosts)")
    dep, pool, params, ccfg = build_deployment(device)
    out: dict = {"deployment": dep}

    report = dep.report()
    print("\n" + report.summary())
    print(f"\nHBM ledger: shared={report.shared_bytes:,} B vs "
          f"dedicated={report.dedicated_bytes:,} B "
          f"(saving {report.sharing_savings:.1%})")

    # ---- static pre-flight: prove the plan sound before serving ----
    # materialize()/serve() run this automatically and raise PlanError on
    # ERROR findings; calling verify() directly returns the diagnostics.
    out["verify"] = dep.verify()
    print(f"\nverify(): {format_report(out['verify']).splitlines()[-1]}")
    tampered = copy.deepcopy(dep.placement)
    tampered.module_bytes["mini-vit"] = 10**12   # pretend a 1 TB encoder
    finding = check_plan(tampered, pool, dep.models)[0]
    out["tampered_finding"] = finding
    print(f"tampered ledger is rejected statically -> {finding.code} "
          f"[{finding.entity}]")

    # ---- the same Request drives prediction AND real compute ----
    patches, ids = make_inputs(ccfg)
    workload = [
        Request(0, "retrieval", "dev0",
                inputs={"vision": patches, "text": ids}),
        Request(1, "classify", "dev0", inputs={"vision": patches}),
        Request(2, "vqa", "dev0", inputs={"vision": patches, "text": ids}),
    ]

    predicted = dep.simulate(workload)
    out["routes"] = []
    for req in workload:
        res = dep.submit(req)
        out["routes"].append((predicted.routes[req.rid], res.devices))
        print(f"\n{req.model}: latency {res.latency_s*1e3:.1f} ms, "
              f"output shape {tuple(res.output.shape)}")
        print(f"  sim route  {predicted.routes[req.rid]}")
        print(f"  real route {res.devices}")
        t0 = min(t for _, _, t, _ in res.timeline)
        for mod, phase, a, b in res.timeline:
            bar = " " * int((a - t0) * 200) + "#" * max(1, int((b - a) * 200))
            print(f"  {mod:16s} {phase:7s} |{bar}")

    # equivalence: split == monolithic (paper Q3)
    mono = C.clip_forward(params, torch.from_numpy(patches).to(device),
                          torch.from_numpy(ids).to(device), ccfg)
    split = dep.submit(workload[0]).output
    out["split_diff"] = _max_diff(split, mono)
    print(f"\nsplit-vs-monolithic max |diff|: {out['split_diff']:.2e}  "
          "(Q3: identical)")

    # ---- continuous batching: shared encoders share COMPUTE too ----
    # requests from all three tasks coalesce into one mini-vit batch
    burst = [Request(10 + i, ["retrieval", "classify", "vqa"][i % 3], "dev0",
                     inputs=(workload[i % 3].inputs), slo_deadline=2.0)
             for i in range(9)]
    served = dep.serve(burst, max_batch=8)
    out["cross_task_batches"] = dep.scheduler.cross_task_batches
    print(f"\nserve(): {len(served)} requests drained through the "
          f"scheduler; {dep.scheduler.cross_task_batches} cross-task "
          f"batch(es) formed at shared encoders")
    for mod, st in dep.scheduler.stats_dict().items():
        print(f"  {mod:16s} calls={st['calls']:<3d} "
              f"occupancy(mean)={st['mean_occupancy']:<5} "
              f"max_batch={st['max_batch']} "
              f"cross_task={st['cross_task_batches']}")
    out["batched_diff"] = max(
        _max_diff(r.output, dep.submit(q).output)
        for q, r in zip(burst, served))
    print(f"  batched-vs-solo max |diff|: {out['batched_diff']:.2e}")

    # ---- observability: SLO attainment, trace export, drift ----
    out["slo"] = slo_summary(dep.scheduler)
    print("\nper-task latency / SLO attainment (2 s deadline):")
    print(format_slo_summary(out["slo"]))

    trace = dep.trace()
    if trace.validate() != []:
        raise AssertionError(
            f"serve trace must be contiguous trees: {trace.validate()[:3]}")
    if trace_path is not None:
        trace.save(str(trace_path))
        print(f"\nwrote {len(trace)} spans across {len(trace.rids())} "
              f"request tracks to {trace_path} (open in chrome://tracing)")

    # did serve() do what simulate() promised?  Same Requests, both paths.
    drift = dep.compare(burst, max_batch=8)
    out["drift"] = drift
    print("\n" + drift.summary())
    if drift.n_route_divergences != 0:
        raise AssertionError("sim routes must equal real devices")

    # ---- lifecycle: hot-remove a task, then a device ----
    out["evicted"] = dep.evict("vqa")
    print(f"\nevict vqa frees {out['evicted']} (shared encoders survive)")
    rep = dep.replan(pool.without("dev0"))
    print(f"replan without dev0: migrations {rep.migrations}")
    after = dep.submit(workload[0])
    out["after_replan"] = after
    print(f"retrieval still serves: {after.devices}")
    return out


def cli(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--trace", default="multi_task_trace.json",
                    help="where to write the serve() trace (Chrome JSON)")
    args = ap.parse_args(argv)
    main(args.device, args.trace)


if __name__ == "__main__":
    cli()
