"""repro_torch.analysis — the static plan verifier and the invariant
catalog behind ``Deployment.verify()`` and the scheduler's runtime
checks.

``plan_check`` proves a placement sound before it touches a device
(memory ledgers, mapping completeness, acyclicity, reachability,
refcounts, sharing legality, paged-KV page budgets); ``invariants`` is
the catalog the scheduler evaluates after every drain step.  The kernel
checker (Hopper launch plans) and the schedule-space model checker are
not ported yet: asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

from repro_torch.analysis.diagnostics import (
    Diagnostic, PlanError, Severity, errors, format_report, warnings,
)

__all__ = [
    "Diagnostic", "PlanError", "Severity", "errors", "format_report",
    "warnings", "verify_deployment",
]


def verify_deployment(dep, *, kernels: bool = False,
                      decode_pages: int | None = None,
                      page_size: int | None = None,
                      model_check: bool = False) -> list[Diagnostic]:
    """Run the static plan verifier against a ``s2m3.Deployment``.
    When ``decode_pages``/``page_size`` are given (the serve()
    pre-flight passes the scheduler's actual knobs), generative heads'
    paged-KV pools are checked against the per-device memory ledgers
    too.  Pure inspection: returns the finding list for the caller's
    policy.  ``kernels=True`` and ``model_check=True`` raise
    ``NotImplementedError`` until their passes are ported."""
    if kernels:
        raise NotImplementedError(
            "verify(kernels=True): the Hopper kernel checker is not "
            "ported yet")
    if model_check:
        raise NotImplementedError(
            "verify(model_check=True): the schedule-space model checker "
            "is not ported yet")
    from repro_torch.analysis.plan_check import check_page_budget, check_plan

    placement = dep._ensure_plan()
    diags = check_plan(
        placement, dep.cluster, dep.models, registry=dep.registry,
        placement_name=dep._placement_name, plan_opts=dep._plan_opts)
    if decode_pages is not None and page_size is not None:
        diags = diags + check_page_budget(
            placement, dep.cluster, dep.models,
            decode_pages=decode_pages, page_size=page_size)
    return diags
