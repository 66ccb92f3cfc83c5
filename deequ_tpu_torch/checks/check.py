"""The user-facing Check DSL: a fluent, immutable builder of constraint
groups with severity levels.

reference: checks/Check.scala:30-984. The methods of the ported analyzers
are reproduced method for method (Scala overloads become Python default
and keyword arguments), with the reference's failure messages.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.analyzers.scan import Patterns
from deequ_tpu_torch.constraints import constraint as C
from deequ_tpu_torch.constraints.constrainable_data_types import ConstrainableDataTypes
from deequ_tpu_torch.constraints.constraint import (
    AnalysisBasedConstraint,
    Constraint,
    ConstraintDecorator,
    ConstraintResult,
    ConstraintStatus,
)


class CheckLevel(enum.Enum):
    ERROR = "Error"
    WARNING = "Warning"


class CheckStatus(enum.Enum):
    SUCCESS = "Success"
    WARNING = "Warning"
    ERROR = "Error"

    @property
    def severity(self) -> int:
        return {"Success": 0, "Warning": 1, "Error": 2}[self.value]


@dataclass
class CheckResult:
    check: "Check"
    status: CheckStatus
    constraint_results: List[ConstraintResult]


def is_one(value: float) -> bool:
    """The default assertion (reference: checks/Check.scala:907)."""
    return value == 1.0


class Check:
    """Immutable list of constraints + severity
    (reference: checks/Check.scala:59)."""

    IsOne = staticmethod(is_one)

    def __init__(
        self,
        level: CheckLevel,
        description: str,
        constraints: Optional[List[Constraint]] = None,
    ):
        self.level = level
        self.description = description
        self.constraints: List[Constraint] = list(constraints or [])

    # -- plumbing ------------------------------------------------------------

    def add_constraint(self, constraint: Constraint) -> "Check":
        """reference: Check.scala:71."""
        return self._copy_with(self.constraints + [constraint])

    def _copy_with(self, constraints: List[Constraint]) -> "Check":
        return Check(self.level, self.description, constraints)

    def _add_filterable_constraint(
        self, creation_func: Callable[[Optional[str]], Constraint]
    ) -> "CheckWithLastConstraintFilterable":
        """reference: Check.scala:76-84."""
        constraint_without_filtering = creation_func(None)
        return CheckWithLastConstraintFilterable(
            self.level,
            self.description,
            self.constraints + [constraint_without_filtering],
            creation_func,
        )

    # -- DSL (reference line numbers from checks/Check.scala) ----------------

    def has_size(self, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        # :97
        return self._add_filterable_constraint(
            lambda filter_: C.size_constraint(assertion, filter_, hint)
        )

    def is_complete(self, column, hint=None) -> "CheckWithLastConstraintFilterable":
        # :110
        return self._add_filterable_constraint(
            lambda filter_: C.completeness_constraint(column, is_one, filter_, hint)
        )

    def has_completeness(
        self, column, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        # :124
        return self._add_filterable_constraint(
            lambda filter_: C.completeness_constraint(column, assertion, filter_, hint)
        )

    def is_unique(self, column, hint=None) -> "Check":
        # :139
        return self.add_constraint(C.uniqueness_constraint([column], is_one, hint))

    def is_primary_key(self, column, *columns, hint=None) -> "Check":
        # :151/:164
        return self.add_constraint(
            C.uniqueness_constraint([column] + list(columns), is_one, hint)
        )

    def has_uniqueness(self, columns, assertion, hint=None) -> "Check":
        # :176/:189/:206/:219
        if isinstance(columns, str):
            columns = [columns]
        return self.add_constraint(C.uniqueness_constraint(columns, assertion, hint))

    def has_distinctness(self, columns, assertion, hint=None) -> "Check":
        # :232
        if isinstance(columns, str):
            columns = [columns]
        return self.add_constraint(C.distinctness_constraint(columns, assertion, hint))

    def has_unique_value_ratio(self, columns, assertion, hint=None) -> "Check":
        # :249
        if isinstance(columns, str):
            columns = [columns]
        return self.add_constraint(
            C.unique_value_ratio_constraint(columns, assertion, hint)
        )

    def has_number_of_distinct_values(
        self, column, assertion, binning_udf=None, max_bins=1000, hint=None
    ) -> "Check":
        # :269
        return self.add_constraint(
            C.histogram_bin_constraint(column, assertion, binning_udf, max_bins, hint)
        )

    def has_histogram_values(
        self, column, assertion, binning_udf=None, max_bins=1000, hint=None
    ) -> "Check":
        # :295
        return self.add_constraint(
            C.histogram_constraint(column, assertion, binning_udf, max_bins, hint)
        )

    def is_newest_point_non_anomalous(
        self,
        metrics_repository,
        anomaly_detection_strategy,
        analyzer,
        with_tag_values: Optional[Dict[str, str]] = None,
        after_date: Optional[int] = None,
        before_date: Optional[int] = None,
        hint=None,
    ) -> "Check":
        # :322 — assertion closes over the repository (reference :926-983)
        assertion = _is_newest_point_non_anomalous_assertion(
            metrics_repository,
            anomaly_detection_strategy,
            analyzer,
            with_tag_values or {},
            after_date,
            before_date,
        )
        return self.add_constraint(C.anomaly_constraint(analyzer, assertion, hint))

    def has_entropy(self, column, assertion, hint=None) -> "Check":
        # :353
        return self.add_constraint(C.entropy_constraint(column, assertion, hint))

    def has_mutual_information(self, column_a, column_b, assertion, hint=None) -> "Check":
        # :371
        return self.add_constraint(
            C.mutual_information_constraint(column_a, column_b, assertion, hint)
        )

    def has_approx_quantile(self, column, quantile, assertion, hint=None) -> "Check":
        # :391
        return self.add_constraint(
            C.approx_quantile_constraint(column, quantile, assertion, hint)
        )

    def has_min(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        # :409
        return self._add_filterable_constraint(
            lambda filter_: C.min_constraint(column, assertion, filter_, hint)
        )

    def has_max(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        # :426
        return self._add_filterable_constraint(
            lambda filter_: C.max_constraint(column, assertion, filter_, hint)
        )

    def has_mean(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        # :443
        return self._add_filterable_constraint(
            lambda filter_: C.mean_constraint(column, assertion, filter_, hint)
        )

    def has_sum(self, column, assertion, hint=None) -> "CheckWithLastConstraintFilterable":
        # :460
        return self._add_filterable_constraint(
            lambda filter_: C.sum_constraint(column, assertion, filter_, hint)
        )

    def has_standard_deviation(
        self, column, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        # :477
        return self._add_filterable_constraint(
            lambda filter_: C.standard_deviation_constraint(
                column, assertion, filter_, hint
            )
        )

    def has_approx_count_distinct(
        self, column, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        # :495
        return self._add_filterable_constraint(
            lambda filter_: C.approx_count_distinct_constraint(
                column, assertion, filter_, hint
            )
        )

    def has_correlation(
        self, column_a, column_b, assertion, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        # :514
        return self._add_filterable_constraint(
            lambda filter_: C.correlation_constraint(
                column_a, column_b, assertion, filter_, hint
            )
        )

    def satisfies(
        self, column_condition, constraint_name, assertion=None, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        # :538
        assertion = assertion if assertion is not None else is_one
        return self._add_filterable_constraint(
            lambda filter_: C.compliance_constraint(
                constraint_name, column_condition, assertion, filter_, hint
            )
        )

    def has_pattern(
        self, column, pattern, assertion=None, name=None, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        # :560
        assertion = assertion if assertion is not None else is_one
        return self._add_filterable_constraint(
            lambda filter_: C.pattern_match_constraint(
                column, pattern, assertion, filter_, name, hint
            )
        )

    def contains_credit_card_number(self, column, assertion=None, hint=None) -> "Check":
        # :581
        return self.has_pattern(
            column,
            Patterns.CREDITCARD,
            assertion,
            name=f"containsCreditCardNumber({column})",
            hint=hint,
        )

    def contains_email(self, column, assertion=None, hint=None) -> "Check":
        # :599
        return self.has_pattern(
            column, Patterns.EMAIL, assertion, name=f"containsEmail({column})", hint=hint
        )

    def contains_url(self, column, assertion=None, hint=None) -> "Check":
        # :616
        return self.has_pattern(
            column, Patterns.URL, assertion, name=f"containsURL({column})", hint=hint
        )

    def contains_social_security_number(self, column, assertion=None, hint=None) -> "Check":
        # :634
        return self.has_pattern(
            column,
            Patterns.SOCIAL_SECURITY_NUMBER_US,
            assertion,
            name=f"containsSocialSecurityNumber({column})",
            hint=hint,
        )

    def has_data_type(
        self, column, data_type: ConstrainableDataTypes, assertion=None, hint=None
    ) -> "Check":
        # :653
        assertion = assertion if assertion is not None else is_one
        return self.add_constraint(C.data_type_constraint(column, data_type, assertion, hint))

    def is_non_negative(self, column, hint=None) -> "CheckWithLastConstraintFilterable":
        # :670 (NULL-coalescing predicate :676)
        return self.satisfies(
            f"COALESCE({column}, 0.0) >= 0", f"{column} is non-negative", hint=hint
        )

    def is_positive(self, column) -> "CheckWithLastConstraintFilterable":
        # :685
        return self.satisfies(f"COALESCE({column}, 1.0) > 0", f"{column} is positive")

    def is_less_than(self, column_a, column_b, hint=None) -> "CheckWithLastConstraintFilterable":
        # :699
        return self.satisfies(
            f"{column_a} < {column_b}", f"{column_a} is less than {column_b}", hint=hint
        )

    def is_less_than_or_equal_to(
        self, column_a, column_b, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        # :717
        return self.satisfies(
            f"{column_a} <= {column_b}",
            f"{column_a} is less than or equal to {column_b}",
            hint=hint,
        )

    def is_greater_than(self, column_a, column_b, hint=None) -> "CheckWithLastConstraintFilterable":
        # :735
        return self.satisfies(
            f"{column_a} > {column_b}", f"{column_a} is greater than {column_b}", hint=hint
        )

    def is_greater_than_or_equal_to(
        self, column_a, column_b, hint=None
    ) -> "CheckWithLastConstraintFilterable":
        # :754
        return self.satisfies(
            f"{column_a} >= {column_b}",
            f"{column_a} is greater than or equal to {column_b}",
            hint=hint,
        )

    def is_contained_in(
        self,
        column,
        allowed_values=None,
        assertion=None,
        hint=None,
        lower_bound=None,
        upper_bound=None,
        include_lower_bound=True,
        include_upper_bound=True,
    ) -> "CheckWithLastConstraintFilterable":
        # values overloads :772-842, numeric range overload :855-871
        if allowed_values is not None:
            assertion = assertion if assertion is not None else is_one
            value_list = ",".join(
                "'" + str(v).replace("'", "''") + "'" for v in allowed_values
            )
            predicate = f"`{column}` IS NULL OR `{column}` IN ({value_list})"
            return self.satisfies(
                predicate,
                f"{column} contained in {','.join(str(v) for v in allowed_values)}",
                assertion,
                hint,
            )
        if lower_bound is None or upper_bound is None:
            raise ValueError(
                "isContainedIn requires allowed_values or lower_bound+upper_bound"
            )
        left_operand = ">=" if include_lower_bound else ">"
        right_operand = "<=" if include_upper_bound else "<"
        predicate = (
            f"`{column}` IS NULL OR "
            f"(`{column}` {left_operand} {lower_bound} AND "
            f"`{column}` {right_operand} {upper_bound})"
        )
        return self.satisfies(
            predicate, f"{column} between {lower_bound} and {upper_bound}", hint=hint
        )

    # -- evaluation ----------------------------------------------------------

    def evaluate(self, context) -> CheckResult:
        """reference: Check.scala:878-890."""
        constraint_results = [c.evaluate(context.metric_map) for c in self.constraints]
        any_failures = any(
            r.status == ConstraintStatus.FAILURE for r in constraint_results
        )
        if any_failures and self.level == CheckLevel.ERROR:
            status = CheckStatus.ERROR
        elif any_failures and self.level == CheckLevel.WARNING:
            status = CheckStatus.WARNING
        else:
            status = CheckStatus.SUCCESS
        return CheckResult(self, status, constraint_results)

    def required_analyzers(self) -> Set[Analyzer]:
        """reference: Check.scala:892-901."""
        out: Set[Analyzer] = set()
        for constraint in self.constraints:
            inner = constraint.inner if isinstance(constraint, ConstraintDecorator) else constraint
            if isinstance(inner, AnalysisBasedConstraint):
                out.add(inner.analyzer)
        return out

    def __repr__(self) -> str:
        return f"Check({self.level.value},{self.description},{len(self.constraints)} constraints)"


class CheckWithLastConstraintFilterable(Check):
    """Allows `.where(filter)` to rebuild the last constraint with a row
    filter (reference: checks/CheckWithLastConstraintFilterable.scala:22-41)."""

    def __init__(
        self,
        level: CheckLevel,
        description: str,
        constraints: List[Constraint],
        create_replacement: Callable[[Optional[str]], Constraint],
    ):
        super().__init__(level, description, constraints)
        self._create_replacement = create_replacement

    def where(self, filter_: str) -> Check:
        adjusted = self.constraints[:-1] + [self._create_replacement(filter_)]
        return Check(self.level, self.description, adjusted)


def _is_newest_point_non_anomalous_assertion(
    metrics_repository,
    anomaly_detection_strategy,
    analyzer,
    with_tag_values: Dict[str, str],
    after_date: Optional[int],
    before_date: Optional[int],
) -> Callable[[float], bool]:
    """Assertion closure that queries the repository for this analyzer's
    metric history and runs the detector on history + current value
    (reference: checks/Check.scala:926-983)."""

    def assertion(current_value: float) -> bool:
        from deequ_tpu_torch.anomaly.detector import AnomalyDetector, DataPoint

        loader = metrics_repository.load()
        if with_tag_values:
            loader = loader.with_tag_values(with_tag_values)
        if after_date is not None:
            loader = loader.after(after_date)
        if before_date is not None:
            loader = loader.before(before_date)
        results = loader.get()

        data_points = []
        for result in results:
            metric = result.analyzer_context.metric_map.get(analyzer)
            value = None
            if metric is not None and metric.value.is_success:
                value = float(metric.value.get())
            data_points.append(DataPoint(result.result_key.data_set_date, value))

        # sort by time; detect on history + new point
        detector = AnomalyDetector(anomaly_detection_strategy)
        detection = detector.is_new_point_anomalous(data_points, current_value)
        return len(detection.anomalies) == 0

    return assertion
