"""Constraint-layer unit tests with stub analyzers — the mirror of the
reference's AnalysisBasedConstraintTest.scala (242 LoC, mocked pickers
and assertions) and ConstraintsTest.scala (164 LoC): evaluation over
precomputed metric maps, every failure mode mapped to its message.

Port-mapped from tests/test_constraints_unit.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import pytest

from deequ_tpu_torch.analyzers import Completeness
from deequ_tpu_torch.constraints import constraint as C
from deequ_tpu_torch.constraints.constraint import (
    AnalysisBasedConstraint,
    ConstraintDecorator,
    ConstraintStatus,
    NamedConstraint,
)
from deequ_tpu_torch.core.maybe import Failure, Success
from deequ_tpu_torch.core.metrics import DoubleMetric, Entity
from torch_fixtures import get_df_missing

pytestmark = pytest.mark.usefixtures("cpu_default")


def metric_of(value: float) -> DoubleMetric:
    return DoubleMetric(Entity.COLUMN, "Completeness", "att1", Success(value))


def failed_metric(exc: BaseException) -> DoubleMetric:
    return DoubleMetric(Entity.COLUMN, "Completeness", "att1", Failure(exc))


ANALYZER = Completeness("att1")


class TestAnalysisBasedConstraintEvaluation:
    """reference: AnalysisBasedConstraint.scala:54-97."""

    def test_success_when_assertion_holds(self):
        constraint = AnalysisBasedConstraint(ANALYZER, lambda v: v == 0.5)
        result = constraint.evaluate({ANALYZER: metric_of(0.5)})
        assert result.status == ConstraintStatus.SUCCESS
        assert result.metric is not None

    def test_failure_when_assertion_does_not_hold(self):
        constraint = AnalysisBasedConstraint(ANALYZER, lambda v: v > 0.9)
        result = constraint.evaluate({ANALYZER: metric_of(0.5)})
        assert result.status == ConstraintStatus.FAILURE
        assert "0.5" in result.message
        assert "does not meet the constraint requirement" in result.message

    def test_missing_analysis_message(self):
        """reference: AnalysisBasedConstraint.scala:115 MissingAnalysis."""
        constraint = AnalysisBasedConstraint(ANALYZER, lambda v: True)
        result = constraint.evaluate({})
        assert result.status == ConstraintStatus.FAILURE
        assert "Missing Analysis" in result.message

    def test_failed_metric_propagates_its_message(self):
        constraint = AnalysisBasedConstraint(ANALYZER, lambda v: True)
        result = constraint.evaluate(
            {ANALYZER: failed_metric(ValueError("kaboom in the scan"))}
        )
        assert result.status == ConstraintStatus.FAILURE
        assert "kaboom in the scan" in result.message

    def test_assertion_exception_becomes_failure(self):
        """reference: AnalysisBasedConstraint.scala:117 AssertionException."""

        def exploding(v):
            raise RuntimeError("assertion blew up")

        constraint = AnalysisBasedConstraint(ANALYZER, exploding)
        result = constraint.evaluate({ANALYZER: metric_of(0.5)})
        assert result.status == ConstraintStatus.FAILURE
        assert "assertion blew up" in result.message

    def test_value_picker_transforms_value(self):
        constraint = AnalysisBasedConstraint(
            ANALYZER, lambda v: v == 6, value_picker=lambda v: v * 12
        )
        assert constraint.evaluate({ANALYZER: metric_of(0.5)}).status \
            == ConstraintStatus.SUCCESS

    def test_value_picker_exception_becomes_failure(self):
        """reference: AnalysisBasedConstraint.scala:116 ProblematicMetricPicker."""

        def bad_picker(v):
            raise RuntimeError("picker exploded")

        constraint = AnalysisBasedConstraint(
            ANALYZER, lambda v: True, value_picker=bad_picker
        )
        result = constraint.evaluate({ANALYZER: metric_of(0.5)})
        assert result.status == ConstraintStatus.FAILURE
        assert "Can't retrieve the value to assert on" in result.message

    def test_hint_appended_to_failure_message(self):
        constraint = AnalysisBasedConstraint(
            ANALYZER, lambda v: v > 0.9, hint="att1 must be nearly full"
        )
        result = constraint.evaluate({ANALYZER: metric_of(0.5)})
        assert "att1 must be nearly full" in result.message


class TestNamedConstraint:
    """reference: Constraint.scala:66."""

    def test_repr_uses_name(self):
        inner = AnalysisBasedConstraint(ANALYZER, lambda v: True)
        named = NamedConstraint(inner, "CompletenessConstraint(custom)")
        assert repr(named) == "CompletenessConstraint(custom)"

    def test_decorator_unwraps_to_innermost(self):
        inner = AnalysisBasedConstraint(ANALYZER, lambda v: True)
        named = NamedConstraint(inner, "outer")
        assert named.inner is inner

    def test_evaluation_passes_through(self):
        inner = AnalysisBasedConstraint(ANALYZER, lambda v: v == 0.5)
        named = NamedConstraint(inner, "outer")
        assert named.evaluate({ANALYZER: metric_of(0.5)}).status \
            == ConstraintStatus.SUCCESS


class TestFactoryReprs:
    """Factory-built constraints carry the reference's display names
    (reference: Constraint.scala:83-613)."""

    @pytest.mark.parametrize(
        "constraint, expected_prefix",
        [
            (C.size_constraint(lambda n: n > 0), "SizeConstraint(Size"),
            (
                C.completeness_constraint("att1", lambda v: True),
                "CompletenessConstraint(Completeness",
            ),
            (
                C.uniqueness_constraint(["att1"], lambda v: True),
                "UniquenessConstraint(Uniqueness",
            ),
            (
                C.distinctness_constraint(["att1"], lambda v: True),
                "DistinctnessConstraint(Distinctness",
            ),
            (
                C.compliance_constraint("name", "att1 > 0", lambda v: True),
                "ComplianceConstraint(Compliance",
            ),
            (
                C.entropy_constraint("att1", lambda v: True),
                "EntropyConstraint(Entropy",
            ),
            (C.mean_constraint("att1", lambda v: True), "MeanConstraint(Mean"),
            (C.min_constraint("att1", lambda v: True), "MinimumConstraint(Minimum"),
            (C.max_constraint("att1", lambda v: True), "MaximumConstraint(Maximum"),
            (C.sum_constraint("att1", lambda v: True), "SumConstraint(Sum"),
            (
                C.standard_deviation_constraint("att1", lambda v: True),
                "StandardDeviationConstraint(StandardDeviation",
            ),
            (
                C.approx_count_distinct_constraint("att1", lambda v: True),
                "ApproxCountDistinctConstraint(ApproxCountDistinct",
            ),
            (
                C.correlation_constraint("a", "b", lambda v: True),
                "CorrelationConstraint(Correlation",
            ),
            (
                C.pattern_match_constraint("att1", r"\d+", lambda v: True),
                "PatternMatchConstraint",
            ),
        ],
    )
    def test_repr(self, constraint, expected_prefix):
        assert repr(constraint).startswith(expected_prefix)


class TestSizeConstraintEndToEnd:
    def test_size_value_formats_as_integer(self):
        """The failure message prints whole-number metric values the way
        the reference does ('Value: 4', not 'Value: 4.0')."""
        from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

        table = get_df_missing()
        constraint = C.size_constraint(lambda n: n > 100)
        inner = constraint.inner if isinstance(constraint, ConstraintDecorator) else constraint
        ctx = AnalysisRunner.do_analysis_run(table, [inner.analyzer])
        result = constraint.evaluate(ctx.metric_map)
        assert result.status == ConstraintStatus.FAILURE
        assert "Value: 12" in result.message
