"""The drift Check family: two-sample state-vs-state constraints.

A `DriftCheck` compares two `StateBag`s — typically "this window's
merged states" against "the same window a week earlier"
(`WindowQuery.states(...)`) or a pinned training-time baseline — and
never rescans either side. It mirrors the ordinary `Check` builder
(immutable, chainable, CheckLevel severity) but evaluates against two
samples instead of one dataset, with its own result types: a
constraint here has no single-dataset metric, it has a drift measure.

    check = (DriftCheck(CheckLevel.ERROR, "weekly skew")
             .has_no_quantile_drift("latency_ms", max_quantile_shift=0.05)
             .has_no_cardinality_drift("user_id", max_ratio_drift=0.10))
    result = check.evaluate(current=this_week, baseline=last_week)

A missing baseline state or a plan-signature mismatch between the two
bags fails the affected constraints and attaches a DQ324 diagnostic
(caret-rendered over the constraint description) rather than raising —
a drifting dataset and a mis-wired baseline should both be visible in
the same result object.

The JAX counterpart is deequ_tpu/checks/drift.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Tuple

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    CountDistinct,
    Mean,
    StandardDeviation,
)
from deequ_tpu_torch.analyzers.drift import (
    StateBag,
    cardinality_drift,
    completeness_drift,
    frequency_chi_square,
    mean_drift,
    quantile_drift,
    stddev_drift,
)
from deequ_tpu_torch.checks.check import CheckLevel, CheckStatus
from deequ_tpu_torch.constraints.constraint import ConstraintStatus
from deequ_tpu_torch.lint.diagnostics import Diagnostic, Severity

__all__ = [
    "DriftCheck",
    "DriftCheckResult",
    "DriftConstraint",
    "DriftConstraintResult",
]


@dataclass(frozen=True)
class DriftConstraint:
    """One two-sample constraint: which analyzer's states to compare,
    how to turn the pair into a drift measure, and the threshold the
    measure must stay under (or, for p-values, over)."""

    description: str
    analyzer: Any
    measure: Callable[[Any, Any], float]
    threshold: float
    #: 'max' — fail when measure > threshold (distances, ratios);
    #: 'min' — fail when measure < threshold (p-values)
    mode: str = "max"

    def holds(self, value: float) -> bool:
        if value != value:  # NaN never passes
            return False
        if self.mode == "min":
            return value >= self.threshold
        return value <= self.threshold


@dataclass
class DriftConstraintResult:
    constraint: DriftConstraint
    status: ConstraintStatus
    message: Optional[str] = None
    #: the drift measure (None when a side was missing)
    value: Optional[float] = None


@dataclass
class DriftCheckResult:
    check: "DriftCheck"
    status: CheckStatus
    constraint_results: List[DriftConstraintResult]
    #: DQ324 diagnostics for missing/mismatched baselines
    diagnostics: List[Diagnostic] = field(default_factory=list)


class DriftCheck:
    """Immutable chainable builder of two-sample drift constraints,
    `Check`-shaped: every `has_no_*` returns a NEW DriftCheck."""

    def __init__(
        self,
        level: CheckLevel,
        description: str,
        constraints: Optional[List[DriftConstraint]] = None,
    ):
        self.level = level
        self.description = description
        self.constraints: Tuple[DriftConstraint, ...] = tuple(constraints or ())

    def _add(self, constraint: DriftConstraint) -> "DriftCheck":
        return DriftCheck(
            self.level, self.description, list(self.constraints) + [constraint]
        )

    # -- the family ----------------------------------------------------------

    def has_no_quantile_drift(
        self,
        column: str,
        max_quantile_shift: float = 0.05,
        *,
        quantile: float = 0.5,
        relative_error: float = 0.01,
    ) -> "DriftCheck":
        """Two-sample KS distance between the column's KLL sketches must
        stay <= `max_quantile_shift`. The `quantile` parameter only
        names which ApproxQuantile analyzer supplies the sketch — the
        comparison uses the whole sketch, not one quantile point."""
        return self._add(
            DriftConstraint(
                description=(
                    f"quantile drift of {column!r} <= {max_quantile_shift}"
                ),
                analyzer=ApproxQuantile(column, quantile, relative_error),
                measure=quantile_drift,
                threshold=float(max_quantile_shift),
            )
        )

    def has_no_cardinality_drift(
        self, column: str, max_ratio_drift: float = 0.10
    ) -> "DriftCheck":
        """HLL distinct-count ratio drift ``max(r, 1/r) - 1`` must stay
        <= `max_ratio_drift`."""
        return self._add(
            DriftConstraint(
                description=(
                    f"cardinality drift of {column!r} <= {max_ratio_drift}"
                ),
                analyzer=ApproxCountDistinct(column),
                measure=cardinality_drift,
                threshold=float(max_ratio_drift),
            )
        )

    def has_no_frequency_drift(
        self, column: str, min_p_value: float = 0.01
    ) -> "DriftCheck":
        """Two-sample chi-square over the column's frequency tables must
        NOT reject homogeneity: p-value >= `min_p_value`. Rides
        `CountDistinct([column])` states (a grouping analyzer — supply
        its states through `StateBag.from_provider`)."""
        return self._add(
            DriftConstraint(
                description=(
                    f"frequency drift of {column!r}: p >= {min_p_value}"
                ),
                analyzer=CountDistinct([column]),
                measure=lambda a, b: frequency_chi_square(a, b).p_value,
                threshold=float(min_p_value),
                mode="min",
            )
        )

    def has_no_completeness_drift(
        self, column: str, max_delta: float = 0.02
    ) -> "DriftCheck":
        return self._add(
            DriftConstraint(
                description=(
                    f"completeness drift of {column!r} <= {max_delta}"
                ),
                analyzer=Completeness(column),
                measure=completeness_drift,
                threshold=float(max_delta),
            )
        )

    def has_no_mean_drift(
        self, column: str, max_relative_delta: float = 0.05
    ) -> "DriftCheck":
        return self._add(
            DriftConstraint(
                description=f"mean drift of {column!r} <= {max_relative_delta}",
                analyzer=Mean(column),
                measure=mean_drift,
                threshold=float(max_relative_delta),
            )
        )

    def has_no_stddev_drift(
        self, column: str, max_relative_delta: float = 0.05
    ) -> "DriftCheck":
        return self._add(
            DriftConstraint(
                description=(
                    f"stddev drift of {column!r} <= {max_relative_delta}"
                ),
                analyzer=StandardDeviation(column),
                measure=stddev_drift,
                threshold=float(max_relative_delta),
            )
        )

    def has_no_drift(
        self,
        column: str,
        *,
        max_quantile_shift: Optional[float] = 0.05,
        max_cardinality_drift: Optional[float] = None,
        max_completeness_delta: Optional[float] = None,
        max_mean_delta: Optional[float] = None,
    ) -> "DriftCheck":
        """The convenience bundle: each non-None threshold adds its
        constraint on `column`."""
        check = self
        if max_quantile_shift is not None:
            check = check.has_no_quantile_drift(
                column, max_quantile_shift=max_quantile_shift
            )
        if max_cardinality_drift is not None:
            check = check.has_no_cardinality_drift(
                column, max_ratio_drift=max_cardinality_drift
            )
        if max_completeness_delta is not None:
            check = check.has_no_completeness_drift(
                column, max_delta=max_completeness_delta
            )
        if max_mean_delta is not None:
            check = check.has_no_mean_drift(
                column, max_relative_delta=max_mean_delta
            )
        return check

    # -- plumbing ------------------------------------------------------------

    def required_analyzers(self) -> List[Any]:
        """Deduplicated analyzers both samples must carry states for —
        feed these to `WindowQuery` (scan-shareable ones) and/or the
        state provider (grouping ones like CountDistinct)."""
        seen = set()
        out: List[Any] = []
        for c in self.constraints:
            if c.analyzer not in seen:
                seen.add(c.analyzer)
                out.append(c.analyzer)
        return out

    def _dq324(self, description: str, detail: str) -> Diagnostic:
        return Diagnostic(
            code="DQ324",
            severity=Severity.WARNING
            if self.level == CheckLevel.WARNING
            else Severity.ERROR,
            message=f"drift baseline unusable: {detail}",
            source=description,
            span=(0, len(description)),
            subject=f"drift check {self.description!r}",
        )

    def evaluate(
        self, current: StateBag, baseline: StateBag
    ) -> DriftCheckResult:
        """Compare the two samples constraint by constraint. Missing
        states on either side and bag-level plan-signature mismatches
        fail the affected constraints with DQ324 attached — never an
        exception, so a sentinel loop can keep watching a broken
        baseline wire-up."""
        diagnostics: List[Diagnostic] = []
        signature_ok = True
        if (
            current.signature is not None
            and baseline.signature is not None
            and current.signature != baseline.signature
        ):
            signature_ok = False
        results: List[DriftConstraintResult] = []
        for constraint in self.constraints:
            desc = constraint.description
            if not signature_ok:
                detail = (
                    f"plan signature mismatch: current "
                    f"{current.signature!r} vs baseline "
                    f"{baseline.signature!r}"
                )
                diagnostics.append(self._dq324(desc, detail))
                results.append(
                    DriftConstraintResult(
                        constraint, ConstraintStatus.FAILURE, detail
                    )
                )
                continue
            cur_state = current.get(constraint.analyzer)
            base_state = baseline.get(constraint.analyzer)
            if cur_state is None or base_state is None:
                side = "current" if cur_state is None else "baseline"
                label = (
                    getattr(
                        current if side == "current" else baseline, "label", ""
                    )
                    or side
                )
                detail = (
                    f"no {side} state for {constraint.analyzer!r} "
                    f"(sample {label!r})"
                )
                diagnostics.append(self._dq324(desc, detail))
                results.append(
                    DriftConstraintResult(
                        constraint, ConstraintStatus.FAILURE, detail
                    )
                )
                continue
            value = float(constraint.measure(cur_state, base_state))
            if constraint.holds(value):
                results.append(
                    DriftConstraintResult(
                        constraint,
                        ConstraintStatus.SUCCESS,
                        None,
                        value,
                    )
                )
            else:
                op = ">=" if constraint.mode == "min" else "<="
                results.append(
                    DriftConstraintResult(
                        constraint,
                        ConstraintStatus.FAILURE,
                        f"drift measure {value:.6g} violates "
                        f"{op} {constraint.threshold} ({desc})",
                        value,
                    )
                )
        if all(r.status == ConstraintStatus.SUCCESS for r in results):
            status = CheckStatus.SUCCESS
        elif self.level == CheckLevel.ERROR:
            status = CheckStatus.ERROR
        else:
            status = CheckStatus.WARNING
        return DriftCheckResult(self, status, results, diagnostics)
