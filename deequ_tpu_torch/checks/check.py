"""The user-facing Check DSL: a fluent, immutable builder of constraint
groups with severity levels.

reference: checks/Check.scala:30-984. The methods of the ported analyzers
are reproduced method for method (Scala overloads become Python default
and keyword arguments), with the reference's failure messages.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Callable, List, Optional, Set

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.constraints import constraint as C
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

