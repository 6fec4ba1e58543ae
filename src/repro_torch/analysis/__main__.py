"""CLI for the port's static analysis passes.

    python -m repro_torch.analysis --self            # CI mode: lint the
                                                     # repro_torch package
                                                     # + kernel sweep
                                                     # + obs self-test
                                                     # + model-check and
                                                     #   lockset self-tests
    python -m repro_torch.analysis src/repro_torch/serving   # lint paths
    python -m repro_torch.analysis --kernels         # kernel checker only
    python -m repro_torch.analysis --model-check     # explore the default
                                                     # serving scenario
    python -m repro_torch.analysis --locksets        # interprocedural
                                                     # lockset race detection

``--self`` runs the schedule-space model checker's seeded-mutation
self-test and the lockset detector's self-test, the first under the
``--mc-budget`` wall-clock cap.  The JAX package's ``--self`` also
re-runs its benchmark sections against the committed ``BENCH_*.json``
snapshots; the port has no benchmark yet, so there is no bench gate
here.  The kernel checker is static: it reads the H100's SM count from
``common.hw`` unless ``--device cuda`` asks for the card's, and never
launches.

Exit status 1 when any ERROR-severity finding is emitted (incl. a
model-check invariant violation); WARNING/INFO never fail the run.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

from repro_torch.analysis.diagnostics import errors, format_report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="static plan/kernel/concurrency analysis for the "
                    "PyTorch port of the S2M3 reproduction (no bench "
                    "gate: the port has no benchmark yet)")
    ap.add_argument("paths", nargs="*", type=Path,
                    help="files or directories to run the concurrency "
                         "lint over")
    ap.add_argument("--self", dest="self_mode", action="store_true",
                    help="lint the repro_torch package sources, run the "
                         "zoo kernel sweep and the obs, model-check and "
                         "lockset self-tests (the tier-1/CI mode)")
    ap.add_argument("--kernels", action="store_true",
                    help="run the Hopper launch-plan checker over the "
                         "zoo's served shapes (static: nothing launches)")
    ap.add_argument("--device", default=None,
                    help="read the SM count for the kernel checker from "
                         "this device (e.g. cuda); default the H100's "
                         "published count")
    ap.add_argument("--model-check", action="store_true",
                    help="exhaustively explore the default serving "
                         "scenario's schedule space against the invariant "
                         "catalog (exit 1 on a violation)")
    ap.add_argument("--locksets", action="store_true",
                    help="run the interprocedural lockset race detector "
                         "over the serving layer")
    ap.add_argument("--mc-budget", type=float, default=30.0,
                    metavar="SECONDS",
                    help="wall-clock cap for model-checker exploration "
                         "(and the --self model-check self-test; default "
                         "30)")
    args = ap.parse_args(argv)

    run_kernels = args.kernels or args.self_mode or not args.paths
    diags = []

    if args.self_mode:
        import repro_torch
        from repro_torch.analysis import locksets, modelcheck
        from repro_torch.analysis.concurrency_lint import lint_paths
        from repro_torch.obs.selftest import self_test

        diags += lint_paths([Path(p) for p in repro_torch.__path__])
        diags += self_test()
        # seeded-mutation self-tests: the model checker must catch every
        # injected serving bug and the unmutated tree must verify clean
        diags += modelcheck.self_test(budget_s=args.mc_budget)
        diags += locksets.self_test()
    elif args.paths:
        from repro_torch.analysis.concurrency_lint import lint_paths

        diags += lint_paths(args.paths)
    else:
        from repro_torch.analysis.concurrency_lint import lint_serving

        diags += lint_serving()

    if run_kernels:
        from repro_torch.analysis.kernel_check import check_kernels

        diags += check_kernels(device=args.device)

    if args.model_check:
        from repro_torch.analysis import modelcheck
        from repro_torch.analysis.diagnostics import Diagnostic, Severity

        res = modelcheck.check(modelcheck.default_scenario(),
                               budget_s=args.mc_budget)
        if res.counterexample is not None:
            cx = res.counterexample
            diags.append(Diagnostic(
                Severity.ERROR, f"modelcheck/{cx.invariant}",
                f"{cx.message}\ncounterexample:\n{cx.format_script()}",
                entity="default_scenario"))
        else:
            diags.append(Diagnostic(
                Severity.INFO if res.complete else Severity.WARNING,
                "modelcheck/clean" if res.complete
                else "modelcheck/truncated",
                res.summary(), entity="default_scenario"))

    if args.locksets:
        from repro_torch.analysis.locksets import lint_serving_locksets

        diags += lint_serving_locksets().diagnostics

    print(format_report(diags))
    return 1 if errors(diags) else 0


if __name__ == "__main__":
    sys.exit(main())
