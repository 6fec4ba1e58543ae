"""CLI for the port's observability layer.

    python -m repro_torch.obs trace out.json    # serve a demo two-task
                                                # workload, write the
                                                # Chrome trace (Perfetto)
    python -m repro_torch.obs drift             # demo simulate-vs-serve
                                                # drift report
    python -m repro_torch.obs --self-test       # span nesting + metrics
                                                # thread-safety + instrument
                                                # lint (CI gate; exit 1 on
                                                # failure)

``trace`` and ``drift`` run on the card unless ``--device`` names another
(``--device cpu`` on a machine without one).  The demo deployment is two
tasks sharing one encoder — the smallest workload that exercises
cross-task batch coalescing, so the exported trace shows the
shared-encoder launches tagged with their batch composition.  Its
weights and inputs are drawn from seeded ``torch.Generator``s.
"""

from __future__ import annotations

import argparse
import sys

D = 16


def _demo_deployment(device):
    import torch

    from repro_torch.core.cluster import ClusterSpec, DeviceSpec
    from repro_torch.core.module import ModelSpec, ModuleSpec
    from repro_torch.s2m3 import Deployment

    enc = ModuleSpec("demo-enc", "encoder", "vision", 4 * D * D,
                     flops_per_query=2e5)
    cls_head = ModuleSpec("demo-cls", "head", "task", 4 * D * 4,
                          flops_per_query=1e4)
    reg_head = ModuleSpec("demo-reg", "head", "task", 4 * D,
                          flops_per_query=1e4)
    gen = torch.Generator(device=device).manual_seed(0)
    w_enc, w_cls, w_reg = (
        torch.randn(D, n, generator=gen, device=device) for n in (D, 4, 1))
    builders = {
        "demo-enc": lambda: (lambda p, x: torch.tanh(x @ p), w_enc),
        "demo-cls": lambda: (lambda p, e: e["vision"] @ p, w_cls),
        "demo-reg": lambda: (lambda p, e: e["vision"] @ p, w_reg),
    }
    cluster = ClusterSpec(devices=[
        DeviceSpec(f"dev{i}", 1024**3, 1e9) for i in range(2)])
    return (Deployment(cluster)
            .add_model(ModelSpec("classify", "classification",
                                 (enc,), cls_head), builders)
            .add_model(ModelSpec("score", "regression", (enc,), reg_head))
            .plan("greedy", routing="paper")
            .materialize(device=device))


def _demo_workload(n: int):
    import torch

    from repro_torch.s2m3 import Request

    x = torch.randn(2, D, generator=torch.Generator().manual_seed(3))
    return [Request(i, "classify" if i % 2 == 0 else "score", "dev0",
                    inputs={"vision": x}, slo_deadline=0.5)
            for i in range(n)]


def _cmd_trace(out: str, n: int, device) -> int:
    dep = _demo_deployment(device)
    dep.serve(_demo_workload(n))
    trace = dep.trace()
    problems = trace.validate()
    trace.save(out)
    print(f"served {n} demo request(s) on {device}; wrote {len(trace)} "
          f"span(s) to {out} (open in https://ui.perfetto.dev)")
    for p in problems:
        print(f"MALFORMED: {p}")
    from repro_torch.obs.summary import format_slo_summary, slo_summary

    print(format_slo_summary(slo_summary(dep.scheduler)))
    return 1 if problems else 0


def _cmd_drift(n: int, device) -> int:
    dep = _demo_deployment(device)
    report = dep.compare(_demo_workload(n))
    print(report.summary())
    return 0


def _cmd_self_test() -> int:
    from repro_torch.analysis.diagnostics import errors, format_report
    from repro_torch.obs.selftest import self_test

    diags = self_test()
    print(format_report(diags))
    return 1 if errors(diags) else 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs",
        description="tracing / metrics / drift CLI for the port's S2M3 "
                    "serving stack")
    ap.add_argument("--self-test", action="store_true",
                    help="run the obs self-test (span nesting, metrics "
                         "thread-safety, instrument lint)")
    sub = ap.add_subparsers(dest="cmd")
    p_trace = sub.add_parser(
        "trace", help="serve a demo workload and export its Chrome trace")
    p_trace.add_argument("out", help="output JSON path")
    p_trace.add_argument("-n", type=int, default=6,
                         help="demo requests (default %(default)s)")
    p_drift = sub.add_parser(
        "drift", help="demo simulate-vs-serve drift report")
    p_drift.add_argument("-n", type=int, default=6)
    for p in (p_trace, p_drift):
        p.add_argument("--device", default=None,
                       help="device for the demo deployment (default: the "
                            "CUDA card; pass cpu to run without one)")
    args = ap.parse_args(argv)

    if args.self_test:
        return _cmd_self_test()
    if args.cmd in ("trace", "drift"):
        from repro_torch.common.device import resolve_device

        device = resolve_device(args.device)
        if args.cmd == "trace":
            return _cmd_trace(args.out, args.n, device)
        return _cmd_drift(args.n, device)
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
