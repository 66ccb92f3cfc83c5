"""Constraints: bind an analyzer + value picker + assertion into a
pass/fail evaluation over a precomputed metric map.

reference: constraints/Constraint.scala:25-615,
constraints/AnalysisBasedConstraint.scala:42-122. Error-message texts are
part of the user-facing contract and mirror the reference.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Sequence

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Compliance,
    Correlation,
    Distinctness,
    Entropy,
    Histogram,
    Maximum,
    Mean,
    Minimum,
    MutualInformation,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    UniqueValueRatio,
    Uniqueness,
)
from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.scan import DataType, DataTypeInstances
from deequ_tpu_torch.constraints.constrainable_data_types import ConstrainableDataTypes
from deequ_tpu_torch.core.metrics import Distribution, Metric


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

    def calculate_and_evaluate(self, data, device=None) -> ConstraintResult:
        """The analyzer's metric over `data` on `device` (CUDA unless the
        caller asks for ``"cpu"``), then this constraint's verdict."""
        metric = self.analyzer.calculate(data, device=device)
        return self.evaluate({self.analyzer: metric})

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


def anomaly_constraint(
    analyzer: Analyzer,
    anomaly_assertion: Callable[[float], bool],
    hint: Optional[str] = None,
) -> Constraint:
    constraint = AnalysisBasedConstraint(analyzer, anomaly_assertion, hint=hint)
    return NamedConstraint(constraint, f"AnomalyConstraint({analyzer!r})")


def uniqueness_constraint(
    columns: Sequence[str],
    assertion: Callable[[float], bool],
    hint: Optional[str] = None,
) -> Constraint:
    uniqueness = Uniqueness(list(columns))
    constraint = AnalysisBasedConstraint(uniqueness, assertion, hint=hint)
    return NamedConstraint(constraint, f"UniquenessConstraint({uniqueness!r})")


def distinctness_constraint(
    columns: Sequence[str],
    assertion: Callable[[float], bool],
    hint: Optional[str] = None,
) -> Constraint:
    distinctness = Distinctness(list(columns))
    constraint = AnalysisBasedConstraint(distinctness, assertion, hint=hint)
    return NamedConstraint(constraint, f"DistinctnessConstraint({distinctness!r})")


def unique_value_ratio_constraint(
    columns: Sequence[str],
    assertion: Callable[[float], bool],
    hint: Optional[str] = None,
) -> Constraint:
    ratio = UniqueValueRatio(list(columns))
    constraint = AnalysisBasedConstraint(ratio, assertion, hint=hint)
    # missing ")" is deliberate: mirrors the reference's own toString typo
    # (reference: constraints/Constraint.scala:254) for output parity
    return NamedConstraint(constraint, f"UniqueValueRatioConstraint({ratio!r}")


def compliance_constraint(
    name: str,
    column_condition: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    compliance = Compliance(name, column_condition, where)
    constraint = AnalysisBasedConstraint(compliance, assertion, hint=hint)
    return NamedConstraint(constraint, f"ComplianceConstraint({compliance!r})")


def pattern_match_constraint(
    column: str,
    pattern: str,
    assertion: Callable[[float], bool],
    where: Optional[str] = None,
    name: Optional[str] = None,
    hint: Optional[str] = None,
) -> Constraint:
    pattern_match = PatternMatch(column, pattern, where)
    constraint = AnalysisBasedConstraint(pattern_match, assertion, hint=hint)
    constraint_name = (
        name if name is not None else f"PatternMatchConstraint({column}, {pattern})"
    )
    return NamedConstraint(constraint, constraint_name)


def entropy_constraint(
    column: str,
    assertion: Callable[[float], bool],
    hint: Optional[str] = None,
) -> Constraint:
    entropy = Entropy(column)
    constraint = AnalysisBasedConstraint(entropy, assertion, hint=hint)
    return NamedConstraint(constraint, f"EntropyConstraint({entropy!r})")


def mutual_information_constraint(
    column_a: str,
    column_b: str,
    assertion: Callable[[float], bool],
    hint: Optional[str] = None,
) -> Constraint:
    mutual_information = MutualInformation(column_a, column_b)
    constraint = AnalysisBasedConstraint(mutual_information, assertion, hint=hint)
    return NamedConstraint(
        constraint, f"MutualInformationConstraint({mutual_information!r})"
    )


def approx_quantile_constraint(
    column: str,
    quantile: float,
    assertion: Callable[[float], bool],
    hint: Optional[str] = None,
) -> Constraint:
    approx_quantile = ApproxQuantile(column, quantile)
    constraint = AnalysisBasedConstraint(approx_quantile, assertion, hint=hint)
    return NamedConstraint(constraint, f"ApproxQuantileConstraint({approx_quantile!r})")


def histogram_constraint(
    column: str,
    assertion: Callable[[Distribution], bool],
    binning_udf=None,
    max_bins: int = 1000,
    hint: Optional[str] = None,
) -> Constraint:
    histogram = Histogram(column, binning_udf, max_bins)
    constraint = AnalysisBasedConstraint(histogram, assertion, hint=hint)
    return NamedConstraint(constraint, f"HistogramConstraint({histogram!r})")


def histogram_bin_constraint(
    column: str,
    assertion: Callable[[int], bool],
    binning_udf=None,
    max_bins: int = 1000,
    hint: Optional[str] = None,
) -> Constraint:
    histogram = Histogram(column, binning_udf, max_bins)
    constraint = AnalysisBasedConstraint(
        histogram,
        assertion,
        value_picker=lambda d: d.number_of_bins,
        hint=hint,
    )
    return NamedConstraint(constraint, f"HistogramBinConstraint({histogram!r})")


def data_type_constraint(
    column: str,
    data_type: ConstrainableDataTypes,
    assertion: Callable[[float], bool],
    hint: Optional[str] = None,
) -> Constraint:
    """reference: Constraint.scala:548-613 (the ratioTypes value picker)."""

    def ratio_types(ignore_unknown: bool, key_type: str, distribution: Distribution) -> float:
        dv = distribution.values.get(key_type)
        if not ignore_unknown:
            return dv.ratio if dv is not None else 0.0
        absolute = dv.absolute if dv is not None else 0
        if absolute == 0:
            return 0.0
        num_values = sum(v.absolute for v in distribution.values.values())
        unknown = distribution.values.get(DataTypeInstances.UNKNOWN)
        num_unknown = unknown.absolute if unknown is not None else 0
        return absolute / (num_values - num_unknown)

    def picker(distribution: Distribution) -> float:
        if data_type == ConstrainableDataTypes.NULL:
            return ratio_types(False, DataTypeInstances.UNKNOWN, distribution)
        if data_type == ConstrainableDataTypes.NUMERIC:
            return ratio_types(True, DataTypeInstances.FRACTIONAL, distribution) + ratio_types(
                True, DataTypeInstances.INTEGRAL, distribution
            )
        # FRACTIONAL, INTEGRAL, BOOLEAN and STRING share their names with
        # the DataTypeInstances keys
        return ratio_types(True, data_type.value, distribution)

    return AnalysisBasedConstraint(
        DataType(column), assertion, value_picker=picker, hint=hint
    )
