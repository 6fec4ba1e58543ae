"""Structured diagnostics shared by every analysis pass.

A ``Diagnostic`` is one finding: severity, a stable ``code`` (grep /
suppress key, e.g. ``plan/memory-overflow``), a human message, the plan
entity or source location it anchors to, and a fix hint.  Passes return
lists of these; callers decide policy (``Deployment`` pre-flights raise
on ERROR and log WARNINGs, the CLI exits non-zero on ERROR).

Kept dependency-free (stdlib only) so low-level modules — the serving
engine, the kernels — can raise ``PlanError`` without importing the
heavier checker passes.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Severity(enum.IntEnum):
    """Finding severity.  Ordering is meaningful: higher is worse.

    * ``ERROR``   — the plan/kernel/code is unsound; executing it would
      fail (OOM, KeyError, race).  Pre-flights raise, CI fails.
    * ``WARNING`` — likely-wrong or wasteful, but executable (VMEM
      estimate over budget, unknown plan option, stale ledger entry).
    * ``INFO``    — observations (e.g. sharing savings summary).
    """

    INFO = 10
    WARNING = 20
    ERROR = 30

    def __str__(self) -> str:  # "ERROR", not "Severity.ERROR"
        return self.name


@dataclass(frozen=True)
class Diagnostic:
    severity: Severity
    code: str                    # "<pass>/<rule>", stable across releases
    message: str
    entity: str | None = None    # plan entity (module/device) or "file:line"
    hint: str | None = None      # concrete fix suggestion

    def format(self) -> str:
        loc = f" [{self.entity}]" if self.entity else ""
        tail = f"  (fix: {self.hint})" if self.hint else ""
        return f"{self.severity} {self.code}{loc}: {self.message}{tail}"


def errors(diags: list[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity >= Severity.ERROR]


def warnings(diags: list[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity == Severity.WARNING]


def format_report(diags: list[Diagnostic]) -> str:
    if not diags:
        return "no findings"
    lines = [d.format() for d in
             sorted(diags, key=lambda d: (-d.severity, d.code))]
    n_err, n_warn = len(errors(diags)), len(warnings(diags))
    lines.append(f"{len(diags)} finding(s): {n_err} error(s), "
                 f"{n_warn} warning(s)")
    return "\n".join(lines)


@dataclass
class PlanError(KeyError):
    """A plan is statically unsound (or was caught being unsound at
    runtime — ``engine.module_hosts``).  Subclasses ``KeyError`` because
    that is what the engine's mapping lookups historically raised;
    existing ``except KeyError`` call sites keep working.

    ``diagnostics`` carries the full finding list when raised by a
    ``Deployment.verify()`` pre-flight; the module/requested/available
    fields are set when raised for a single unmapped module.
    """

    message: str
    module: str | None = None
    requested: tuple[str, ...] = ()
    available: tuple[str, ...] = ()
    diagnostics: list[Diagnostic] = field(default_factory=list)

    def __post_init__(self):
        KeyError.__init__(self, self.message)

    def __str__(self) -> str:    # KeyError repr-quotes its arg; don't
        return self.message
