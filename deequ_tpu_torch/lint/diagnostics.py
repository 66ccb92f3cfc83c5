"""Structured diagnostics for the plan-time semantic analyzer.

The reference's Catalyst layer resolves columns and checks types in an
analysis phase before any execution; deequ_tpu_torch's analogue is this lint
package, and every problem it finds is reported as a `Diagnostic` with a
stable `DQxxx` code, a severity, an optional source span, and an optional
did-you-mean suggestion. Strict-mode runs aggregate all error-severity
diagnostics into one `PlanValidationError` raised before any kernel
dispatch.

The port's copy of deequ_tpu/lint/diagnostics.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple


class Severity(enum.Enum):
    WARNING = "warning"
    ERROR = "error"


# Stable code registry. Codes are part of the public contract: tests and
# downstream tooling match on them, so never renumber — only append.
CODES = {
    # expression-level (typed expression analysis)
    "DQ100": "expression does not parse",
    "DQ101": "unresolved column",
    "DQ102": "type mismatch",
    "DQ103": "invalid literal",
    "DQ104": "unknown function",
    "DQ105": "wrong function arity",
    # analyzer / constraint spec level
    "DQ110": "invalid analyzer specification",
    # plan level
    "DQ202": "duplicate analyzer in plan",
    "DQ203": "contradictory constraints",
    "DQ204": "unsatisfiable predicate",
    "DQ205": "constant-foldable predicate",
    "DQ206": "fusion-breaking where-clause formatting",
    # performance diagnostics (static cost analyzer, lint/cost.py)
    "DQ300": "redundant analyzer scan covered by the shared pass",
    "DQ301": "fusion-splitting equivalent where-clauses",
    "DQ302": "cap/cardinality blowup",
    "DQ303": "per-pass working set exceeds the cache-tile budget",
    "DQ304": "transfer-per-row anti-pattern",
    "DQ305": "pipeline queue depth cannot hide the measured transfer latency",
    "DQ310": "where predicate not pushdown-eligible",
    "DQ311": "statistics prove every row group skippable",
    "DQ312": "column falls off the decode fast path",
    "DQ313": "column falls off decode-to-wire fusion",
    "DQ314": "state-cache entry unusable; partition falls back to rescan",
    "DQ315": "column-chunk falls off the native parquet reader",
    "DQ316": "constraint falls off row-level failure forensics",
    "DQ317": "forensics audit-trail entry unusable; forensics unavailable",
    "DQ318": "deadline set but the source has no partition boundaries",
    "DQ319": "plan can never be admitted under the tenant's quota window",
    # fleet-level scan sharing (plan-subsumption prover, lint/subsume.py)
    "DQ321": "suite provably contained in a shared scan",
    "DQ322": "scan sharing declined; obligation not provably contained",
    # windowed metrics / drift (windows/, checks/drift.py)
    "DQ323": "window not resolvable from precomputed segments",
    "DQ324": "drift baseline missing or plan-signature mismatched",
    "DQ325": "column falls off the encoded (run/dictionary) fold",
}


@dataclass
class Diagnostic:
    code: str
    severity: Severity
    message: str
    # the expression text the span indexes into, when the diagnostic is
    # anchored to an expression; None for plan-level diagnostics
    source: Optional[str] = None
    span: Optional[Tuple[int, int]] = None
    # what the diagnostic is about in plan terms (analyzer/constraint repr)
    subject: Optional[str] = None
    suggestion: Optional[str] = None

    def __post_init__(self):
        assert self.code in CODES, f"unregistered diagnostic code {self.code}"

    def render(self) -> str:
        head = f"{self.code} [{self.severity.value}] {self.message}"
        if self.suggestion:
            head += f" (did you mean {self.suggestion!r}?)"
        if self.subject:
            head += f" [in {self.subject}]"
        if self.source is not None and self.span is not None:
            a, b = self.span
            a = max(0, min(a, len(self.source)))
            b = max(a, min(b, len(self.source)))
            caret = " " * a + "^" * max(1, b - a)
            head += f"\n    {self.source}\n    {caret}"
        elif self.source is not None:
            head += f"\n    {self.source}"
        return head

    def __str__(self) -> str:
        return self.render()


@dataclass
class LintReport:
    """All diagnostics from one plan validation pass."""

    diagnostics: List[Diagnostic] = field(default_factory=list)
    # machine-readable cost prediction (lint/cost.PlanCost) when the
    # validation pass ran the static cost analyzer; None otherwise
    plan_cost: Optional[object] = None

    @property
    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.ERROR]

    @property
    def warnings(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == Severity.WARNING]

    def extend(self, diags: Sequence[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def render(self) -> str:
        return "\n".join(d.render() for d in self.diagnostics)


class PlanValidationError(ValueError):
    """Aggregated plan-time failure: every error-severity diagnostic from
    the static pass, raised once, before any data is scanned."""

    def __init__(self, diagnostics: Sequence[Diagnostic]):
        self.diagnostics = list(diagnostics)
        errors = [d for d in self.diagnostics if d.severity == Severity.ERROR]
        summary = "; ".join(f"{d.code}: {d.message}" for d in errors[:5])
        if len(errors) > 5:
            summary += f"; ... ({len(errors) - 5} more)"
        super().__init__(
            f"Plan validation failed with {len(errors)} error(s): {summary}\n"
            + "\n".join(d.render() for d in self.diagnostics)
        )
