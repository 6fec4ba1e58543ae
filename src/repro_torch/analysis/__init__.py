"""repro_torch.analysis — static analysis for S2M3 deployments.

Five passes, all device-free, all returning structured ``Diagnostic``
objects (severity, stable code, anchoring entity, fix hint):

* **plan verifier** (``plan_check``) — per-device memory ledgers vs
  capacity, module→host mapping completeness, dependency-graph
  acyclicity, route reachability, registry refcount consistency,
  sharing legality and paged-KV page budgets;
* **kernel checker** (``kernel_check``) — the Hopper launch plan of
  every hand-written kernel at the zoo's served shapes, without
  launching: head dims without a kernel instance, dynamic shared memory
  above a block's limit, sLSTM head dims no cluster splits, grid extents
  above CUDA's, and output shape/dtype drift against ``kernels/ref.py``
  (both called on ``meta`` tensors);
* **concurrency lint** (``concurrency_lint``) — AST pass over the
  serving layer: shared-state mutation outside the scheduler lock, JAX
  or CUDA dispatch while holding the lock, registry mutation from
  batch-coalescing paths;
* **schedule-space model checker** (``modelcheck``) — exhaustive
  bounded interleavings of the serving state machine against the
  invariant catalog (``invariants``);
* **lockset race detector** (``locksets``) — interprocedural Eraser-style
  locksets over the serving call graph.

Severities (``Severity``): **ERROR** means executing the plan would
fail (OOM, KeyError, race, a kernel that cannot launch) —
``Deployment`` pre-flights raise ``PlanError`` and the CLI exits
non-zero; **WARNING** means likely-wrong but executable; **INFO** is an
observation (kernel launch summaries).

Entry points: ``Deployment.verify()`` (and the automatic pre-flight in
``materialize()``/``serve()``), or the CLI::

    python -m repro_torch.analysis --self     # lint the port, kernel-check
                                              # the zoo, self-tests; exit 1
                                              # on ERROR
    python -m repro_torch.analysis path/to/file.py --kernels
"""

from __future__ import annotations

from repro_torch.analysis.diagnostics import (
    Diagnostic, PlanError, Severity, errors, format_report, warnings,
)

__all__ = [
    "Diagnostic", "PlanError", "Severity", "errors", "format_report",
    "model_check_deployment", "verify_deployment", "warnings",
]


def verify_deployment(dep, *, kernels: bool = False,
                      decode_pages: int | None = None,
                      page_size: int | None = None,
                      model_check: bool = False,
                      mc_budget: float = 10.0) -> list[Diagnostic]:
    """Run the static plan verifier (and optionally the kernel checker
    and schedule-space model checker) against a ``s2m3.Deployment``.
    When ``decode_pages``/``page_size`` are given (the serve()
    pre-flight passes the scheduler's actual knobs), generative heads'
    paged-KV pools are checked against the per-device memory ledgers
    too.  ``kernels=True`` checks the Hopper launch plans of the zoo's
    served shapes (at the H100's SM count).  ``model_check=True``
    exhaustively explores bounded request interleavings of a scenario
    derived from this deployment's models
    (``modelcheck.scenario_from_deployment``) under an ``mc_budget``-
    second cap, evaluating the invariant catalog at every state; a
    counterexample becomes an ERROR carrying the replayable transition
    script.  Pure inspection: raises nothing, returns the finding list
    for the caller's policy."""
    from repro_torch.analysis.plan_check import check_page_budget, check_plan

    placement = dep._ensure_plan()
    diags = check_plan(
        placement, dep.cluster, dep.models, registry=dep.registry,
        placement_name=dep._placement_name, plan_opts=dep._plan_opts)
    if decode_pages is not None and page_size is not None:
        diags = diags + check_page_budget(
            placement, dep.cluster, dep.models,
            decode_pages=decode_pages, page_size=page_size)
    if kernels:
        from repro_torch.analysis.kernel_check import check_kernels

        diags = diags + check_kernels()
    if model_check:
        diags = diags + model_check_deployment(dep, budget_s=mc_budget)
    return diags


def model_check_deployment(dep, *, budget_s: float = 10.0
                           ) -> list[Diagnostic]:
    """Model-check a scenario derived from ``dep``'s registered models
    under a wall-clock budget; one Diagnostic summarising the run, plus
    an ERROR per invariant counterexample (with transition script)."""
    from repro_torch.analysis import modelcheck as mc

    cfg = mc.scenario_from_deployment(dep)
    res = mc.check(cfg, budget_s=budget_s)
    if res.counterexample is not None:
        cx = res.counterexample
        return [Diagnostic(
            Severity.ERROR, f"modelcheck/{cx.invariant}",
            f"schedule-space violation of {cx.invariant}: {cx.message}\n"
            f"counterexample ({len(cx.script)} step(s)):\n"
            + cx.format_script(),
            entity="Deployment",
            hint="replay with repro_torch.analysis.modelcheck.replay(); "
                 "export a Chrome trace via Counterexample.save_trace()")]
    sev = Severity.INFO if res.complete else Severity.WARNING
    note = ("" if res.complete else
            " (exploration truncated by budget — not exhaustive)")
    return [Diagnostic(
        sev, "modelcheck/clean" if res.complete else "modelcheck/truncated",
        f"schedule-space model check: {res.summary()}{note}",
        entity="Deployment")]
