"""Plan-level lint tests: DQ110 and DQ202-DQ206, plus the constant-fold
and satisfiability engines they're built on.

Port-mapped from tests/test_lint_planlint.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

import pytest
from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

from deequ_tpu_torch import Check, CheckLevel
from deequ_tpu_torch.analyzers import (
    ApproxQuantile,
    Completeness,
    Compliance,
    Mean,
    PatternMatch,
)
from deequ_tpu_torch.data.expr import normalize_expression, parse
from deequ_tpu_torch.data.table import ColumnType
from deequ_tpu_torch.lint import (
    FieldInfo,
    SchemaInfo,
    Severity,
    fold_to_constant,
    lint_analyzer,
    lint_plan,
    satisfiability,
)

pytestmark = pytest.mark.usefixtures("cpu_default")

SCHEMA = SchemaInfo(
    [
        FieldInfo("item", ColumnType.STRING, nullable=False),
        FieldInfo("att1", ColumnType.STRING, nullable=True),
        FieldInfo("count", ColumnType.LONG, nullable=True),
        FieldInfo("price", ColumnType.DOUBLE, nullable=True),
        FieldInfo("flag", ColumnType.BOOLEAN, nullable=False),
    ]
)


def codes(diags):
    return [d.code for d in diags]


class TestConstantFold:
    def test_folds_literal_truths(self):
        assert fold_to_constant(parse("1 < 2"))[1] is True
        assert fold_to_constant(parse("1 > 2"))[1] is False
        assert fold_to_constant(parse("NULL IS NULL"))[1] is True

    def test_division_by_zero_folds_to_null(self):
        ok, value = fold_to_constant(parse("1 / 0 > 3"))
        assert ok and value is None

    def test_kleene_shortcut(self):
        # FALSE AND <anything> folds even when the rest references columns
        ok, value = fold_to_constant(parse("1 > 2 AND price > 0"))
        assert ok and value is False

    def test_column_references_do_not_fold(self):
        assert fold_to_constant(parse("price > 0")) is None


class TestSatisfiability:
    def test_contradictory_interval(self):
        assert satisfiability(parse("price < 1 AND price > 2"), SCHEMA) == "unsat"

    def test_satisfiable_interval(self):
        assert satisfiability(parse("price > 1 AND price < 2"), SCHEMA) == "sat"

    def test_point_interval_strictness(self):
        assert satisfiability(parse("price >= 1 AND price <= 1"), SCHEMA) == "sat"
        assert satisfiability(parse("price > 1 AND price <= 1"), SCHEMA) == "unsat"

    def test_equality_outside_bounds(self):
        assert (
            satisfiability(parse("price = 5 AND price < 3"), SCHEMA) == "unsat"
        )

    def test_null_on_non_nullable_column(self):
        assert satisfiability(parse("flag IS NULL"), SCHEMA) == "unsat"

    def test_plain_is_null_on_nullable_column_is_sat(self):
        assert satisfiability(parse("price IS NULL"), SCHEMA) == "sat"

    def test_null_only_escape(self):
        # the isContainedIn shape with an impossible non-NULL range
        verdict = satisfiability(
            parse("price IS NULL OR (price > 5 AND price < 3)"), SCHEMA
        )
        assert verdict == "null-only"

    def test_string_domains(self):
        assert (
            satisfiability(parse("item = 'a' AND item = 'b'"), SCHEMA) == "unsat"
        )
        assert satisfiability(parse("item = 'a'"), SCHEMA) == "sat"

    def test_opaque_stays_unknown(self):
        assert (
            satisfiability(parse("LENGTH(item) > 3 AND price < 0"), SCHEMA)
            == "unknown"
        )


class TestLintAnalyzer:
    def test_missing_column_dq101(self):
        diags = lint_analyzer(Mean("prce"), SCHEMA)
        assert "DQ101" in codes(diags)
        d = next(d for d in diags if d.code == "DQ101")
        assert d.suggestion == "price"
        assert d.subject == repr(Mean("prce"))

    def test_wrong_type_dq102_via_preconditions(self):
        diags = lint_analyzer(Mean("att1"), SCHEMA)
        assert "DQ102" in codes(diags)
        d = next(d for d in diags if d.code == "DQ102")
        assert d.severity == Severity.ERROR

    def test_bad_parameter_dq110(self):
        diags = lint_analyzer(ApproxQuantile("price", 1.5), SCHEMA)
        assert "DQ110" in codes(diags)

    def test_invalid_pattern_dq103(self):
        diags = lint_analyzer(PatternMatch("att1", "(unclosed"), SCHEMA)
        assert "DQ103" in codes(diags)

    def test_clean_analyzer(self):
        assert lint_analyzer(Mean("price"), SCHEMA) == []
        assert lint_analyzer(Mean("price", where="count > 0"), SCHEMA) == []


class TestLintPlan:
    def test_duplicate_analyzer_dq202(self):
        report = lint_plan(
            SCHEMA, required_analyzers=[Mean("price"), Mean("price")]
        )
        assert "DQ202" in codes(report.diagnostics)
        assert report.errors == []  # duplicates are a warning

    def test_contradictory_constraints_dq203(self):
        check = (
            Check(CheckLevel.ERROR, "c")
            .is_complete("att1")
            .satisfies("att1 IS NULL", "att1 must be null")
        )
        report = lint_plan(SCHEMA, checks=[check])
        assert "DQ203" in codes(report.diagnostics)

    def test_contradictory_compliance_pair_dq203(self):
        check = (
            Check(CheckLevel.ERROR, "c")
            .satisfies("price > 10", "big")
            .satisfies("price < 5", "small")
        )
        report = lint_plan(SCHEMA, checks=[check])
        assert "DQ203" in codes(report.diagnostics)

    def test_compatible_constraints_no_dq203(self):
        check = (
            Check(CheckLevel.ERROR, "c")
            .is_complete("att1")
            .satisfies("price >= 0", "non-negative")
        )
        report = lint_plan(SCHEMA, checks=[check])
        assert "DQ203" not in codes(report.diagnostics)

    def test_unsatisfiable_predicate_dq204(self):
        report = lint_plan(
            SCHEMA,
            required_analyzers=[Compliance("c", "price < 1 AND price > 2")],
        )
        assert "DQ204" in codes(report.diagnostics)
        assert report.errors

    def test_unsatisfiable_where_dq204(self):
        report = lint_plan(
            SCHEMA, required_analyzers=[Mean("price", where="flag IS NULL")]
        )
        assert "DQ204" in codes(report.diagnostics)

    def test_constant_true_predicate_dq205(self):
        report = lint_plan(
            SCHEMA, required_analyzers=[Compliance("c", "1 < 2")]
        )
        assert "DQ205" in codes(report.diagnostics)
        assert report.errors == []  # constant TRUE is a warning

    def test_constant_false_predicate_dq204(self):
        report = lint_plan(
            SCHEMA, required_analyzers=[Compliance("c", "1 > 2")]
        )
        assert "DQ204" in codes(report.diagnostics)

    def test_fusion_breaking_where_dq206(self):
        report = lint_plan(
            SCHEMA,
            required_analyzers=[
                Mean("price", where="count > 1"),
                Completeness("att1", where="count>1"),
            ],
        )
        assert "DQ206" in codes(report.diagnostics)
        d = next(d for d in report.diagnostics if d.code == "DQ206")
        assert "count > 1" in d.message and "count>1" in d.message

    def test_identical_wheres_no_dq206(self):
        report = lint_plan(
            SCHEMA,
            required_analyzers=[
                Mean("price", where="count > 1"),
                Completeness("att1", where="count > 1"),
            ],
        )
        assert "DQ206" not in codes(report.diagnostics)

    def test_clean_plan_is_empty(self):
        check = (
            Check(CheckLevel.ERROR, "clean")
            .is_complete("item")
            .has_mean("price", lambda v: v > 0)
            .satisfies("count >= 0", "non-negative count")
        )
        report = lint_plan(
            SCHEMA, checks=[check], required_analyzers=[Completeness("att1")]
        )
        assert report.diagnostics == []


class TestNormalizeExpression:
    def test_formatting_invariance(self):
        assert normalize_expression("a==1 AND  `b` <> 2.0") == (
            normalize_expression("`a` = 1.0 AND b != 2")
        )

    def test_distinct_predicates_stay_distinct(self):
        assert normalize_expression("a > 1") != normalize_expression("a >= 1")
