"""Constraints: bind an analyzer + value picker + assertion into a
pass/fail evaluation over a precomputed metric map.

reference: constraints/Constraint.scala:25-615,
constraints/AnalysisBasedConstraint.scala:42-122. Error-message texts are
part of the user-facing contract and mirror the reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    Completeness,
    Correlation,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.core.metrics import Metric


class ConstraintStatus(enum.Enum):
    SUCCESS = "Success"
    FAILURE = "Failure"


@dataclass
class ConstraintResult:
    constraint: "Constraint"
    status: ConstraintStatus
    message: Optional[str] = None
    metric: Optional[Metric] = None


class Constraint:
    """reference: constraints/Constraint.scala:36-38."""

    def evaluate(self, analysis_results: Dict[Analyzer, Metric]) -> ConstraintResult:
        raise NotImplementedError


class ConstraintDecorator(Constraint):
    """reference: constraints/Constraint.scala:41-58."""

    def __init__(self, inner: Constraint):
        self._inner = inner

    @property
    def inner(self) -> Constraint:
        if isinstance(self._inner, ConstraintDecorator):
            return self._inner.inner
        return self._inner

    def evaluate(self, analysis_results: Dict[Analyzer, Metric]) -> ConstraintResult:
        result = self._inner.evaluate(analysis_results)
        result.constraint = self
        return result


class NamedConstraint(ConstraintDecorator):
    """Readable toString wrapper (reference: constraints/Constraint.scala:66)."""

    def __init__(self, constraint: Constraint, name: str):
        super().__init__(constraint)
        self._name = name

    def __repr__(self) -> str:
        return self._name


MISSING_ANALYSIS = "Missing Analysis, can't run the constraint!"
PROBLEMATIC_METRIC_PICKER = "Can't retrieve the value to assert on"
ASSERTION_EXCEPTION = "Can't execute the assertion"


class _ValuePickerException(Exception):
    pass


class _AssertionException(Exception):
    pass


class AnalysisBasedConstraint(Constraint):
    """The single generic evaluation engine
    (reference: constraints/AnalysisBasedConstraint.scala:42-122)."""

    def __init__(
        self,
        analyzer: Analyzer,
        assertion: Callable[[Any], bool],
        value_picker: Optional[Callable[[Any], Any]] = None,
        hint: Optional[str] = None,
    ):
        self.analyzer = analyzer
        self.assertion = assertion
        self.value_picker = value_picker
        self.hint = hint

    def evaluate(self, analysis_results: Dict[Analyzer, Metric]) -> ConstraintResult:
        metric = analysis_results.get(self.analyzer)
        if metric is None:
            return ConstraintResult(
                self, ConstraintStatus.FAILURE, MISSING_ANALYSIS, None
            )
        return self._pick_value_and_assert(metric)

    def _pick_value_and_assert(self, metric: Metric) -> ConstraintResult:
        if metric.value.is_failure:
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                str(metric.value.exception),
                metric,
            )
        try:
            assert_on = self._run_picker(metric.value.get())
            assertion_ok = self._run_assertion(assert_on)
        except _AssertionException as e:
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                f"{ASSERTION_EXCEPTION}: {e}!",
                metric,
            )
        except _ValuePickerException as e:
            return ConstraintResult(
                self,
                ConstraintStatus.FAILURE,
                f"{PROBLEMATIC_METRIC_PICKER}: {e}!",
                metric,
            )
        if assertion_ok:
            return ConstraintResult(self, ConstraintStatus.SUCCESS, metric=metric)
        message = f"Value: {_render_value(assert_on)} does not meet the constraint requirement!"
        if self.hint is not None:
            message += f" {self.hint}"
        return ConstraintResult(self, ConstraintStatus.FAILURE, message, metric)

    def _run_picker(self, metric_value):
        try:
            if self.value_picker is not None:
                return self.value_picker(metric_value)
            return metric_value
        except Exception as e:  # noqa: BLE001
            raise _ValuePickerException(str(e)) from e

    def _run_assertion(self, assert_on) -> bool:
        try:
            return bool(self.assertion(assert_on))
        except Exception as e:  # noqa: BLE001
            raise _AssertionException(str(e)) from e

    def __repr__(self) -> str:
        return f"AnalysisBasedConstraint({self.analyzer!r})"


def _render_value(value) -> str:
    """Scala renders doubles as e.g. 0.8 — Python float repr matches."""
    return str(value)


# ---------------------------------------------------------------------------
# Factories (reference: constraints/Constraint.scala:83-613)
# ---------------------------------------------------------------------------


def size_constraint(
    assertion: Callable[[int], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    size = Size(where)
    constraint = AnalysisBasedConstraint(
        size, assertion, value_picker=lambda d: int(d), hint=hint
    )
    return NamedConstraint(constraint, f"SizeConstraint({size!r})")


def completeness_constraint(
    column: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    completeness = Completeness(column, where)
    constraint = AnalysisBasedConstraint(completeness, assertion, hint=hint)
    return NamedConstraint(constraint, f"CompletenessConstraint({completeness!r})")


def min_constraint(
    column: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    minimum = Minimum(column, where)
    constraint = AnalysisBasedConstraint(minimum, assertion, hint=hint)
    return NamedConstraint(constraint, f"MinimumConstraint({minimum!r})")


def max_constraint(
    column: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    maximum = Maximum(column, where)
    constraint = AnalysisBasedConstraint(maximum, assertion, hint=hint)
    return NamedConstraint(constraint, f"MaximumConstraint({maximum!r})")


def mean_constraint(
    column: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    mean = Mean(column, where)
    constraint = AnalysisBasedConstraint(mean, assertion, hint=hint)
    return NamedConstraint(constraint, f"MeanConstraint({mean!r})")


def sum_constraint(
    column: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    sum_analyzer = Sum(column, where)
    constraint = AnalysisBasedConstraint(sum_analyzer, assertion, hint=hint)
    return NamedConstraint(constraint, f"SumConstraint({sum_analyzer!r})")


def standard_deviation_constraint(
    column: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    std = StandardDeviation(column, where)
    constraint = AnalysisBasedConstraint(std, assertion, hint=hint)
    return NamedConstraint(constraint, f"StandardDeviationConstraint({std!r})")


def approx_count_distinct_constraint(
    column: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    approx = ApproxCountDistinct(column, where)
    constraint = AnalysisBasedConstraint(approx, assertion, hint=hint)
    return NamedConstraint(constraint, f"ApproxCountDistinctConstraint({approx!r})")


def correlation_constraint(
    column_a: str,
    column_b: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    correlation = Correlation(column_a, column_b, where)
    constraint = AnalysisBasedConstraint(correlation, assertion, hint=hint)
    return NamedConstraint(constraint, f"CorrelationConstraint({correlation!r})")
