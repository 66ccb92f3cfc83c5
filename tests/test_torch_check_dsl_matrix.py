"""Systematic DSL matrix: every Check method × pass/warn/fail × where
variants — the depth of the reference's CheckTest.scala (808 LoC;
reference: src/test/scala/com/amazon/deequ/checks/CheckTest.scala), on
the FixtureSupport tables. Complements tests/test_check_dsl_full.py's
scenario tests with per-method coverage.

Port-mapped from tests/test_check_dsl_matrix.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pytest

from deequ_tpu_torch import Check, CheckLevel, CheckStatus, Table, VerificationSuite
from deequ_tpu_torch.constraints.constrainable_data_types import ConstrainableDataTypes
from deequ_tpu_torch.constraints.constraint import ConstraintStatus
from torch_fixtures import (
    get_df_full,
    get_df_missing,
    get_df_with_distinct_values,
    get_df_with_numeric_values,
    get_df_with_unique_columns,
)

pytestmark = pytest.mark.usefixtures("cpu_default")


def status_of(table: Table, check: Check) -> CheckStatus:
    return VerificationSuite.on_data(table).add_check(check).run().status


def constraint_statuses(table: Table, check: Check):
    result = VerificationSuite.on_data(table).add_check(check).run()
    return [
        cr.status for cr in next(iter(result.check_results.values())).constraint_results
    ]


def error_check() -> Check:
    return Check(CheckLevel.ERROR, "error level")


def warning_check() -> Check:
    return Check(CheckLevel.WARNING, "warning level")


class TestSize:
    """reference: CheckTest.scala:128-154."""

    def test_exact_equality_passes(self):
        assert status_of(get_df_full(), error_check().has_size(lambda n: n == 4)) \
            == CheckStatus.SUCCESS

    def test_bounds(self):
        t = get_df_full()
        assert status_of(t, error_check().has_size(lambda n: n < 5)) == CheckStatus.SUCCESS
        assert status_of(t, error_check().has_size(lambda n: n > 3)) == CheckStatus.SUCCESS
        assert status_of(t, error_check().has_size(lambda n: n > 4)) == CheckStatus.ERROR

    def test_failing_at_warning_level_yields_warning(self):
        assert status_of(get_df_full(), warning_check().has_size(lambda n: n == 0)) \
            == CheckStatus.WARNING

    def test_with_where_filter(self):
        check = error_check().has_size(lambda n: n == 3).where("att1 = 'a'")
        assert status_of(get_df_full(), check) == CheckStatus.SUCCESS


class TestCompletenessFamily:
    """reference: CheckTest.scala:42-62."""

    def test_is_complete_passes_on_full_column(self):
        assert status_of(get_df_missing(), error_check().is_complete("item")) \
            == CheckStatus.SUCCESS

    def test_is_complete_fails_on_missing(self):
        assert status_of(get_df_missing(), error_check().is_complete("att1")) \
            == CheckStatus.ERROR

    def test_has_completeness_exact_fractions(self):
        t = get_df_missing()  # att1: 6/12, att2: 9/12
        assert status_of(t, error_check().has_completeness("att1", lambda v: v == 0.5)) \
            == CheckStatus.SUCCESS
        assert status_of(t, error_check().has_completeness("att2", lambda v: v == 0.75)) \
            == CheckStatus.SUCCESS
        assert status_of(t, error_check().has_completeness("att2", lambda v: v > 0.8)) \
            == CheckStatus.ERROR

    def test_where_filter_changes_fraction(self):
        # rows where att2 = 'd': items 2,6,7,12 -> att1 = b,None,None,None
        check = (
            error_check()
            .has_completeness("att1", lambda v: v == 0.25)
            .where("att2 = 'd'")
        )
        assert status_of(get_df_missing(), check) == CheckStatus.SUCCESS

    def test_missing_column_is_error(self):
        assert status_of(get_df_missing(), error_check().is_complete("nope")) \
            == CheckStatus.ERROR


class TestUniquenessFamily:
    """reference: CheckTest.scala:64-126."""

    def test_is_unique(self):
        t = get_df_with_unique_columns()
        assert status_of(t, error_check().is_unique("unique")) == CheckStatus.SUCCESS
        assert status_of(t, error_check().is_unique("nonUnique")) == CheckStatus.ERROR
        # nulls stay in the DENOMINATOR (numRows), so a unique-but-gappy
        # column is NOT unique (reference: CheckTest.scala:64-82 asserts
        # Failure for uniqueWithNulls)
        assert status_of(t, error_check().is_unique("uniqueWithNulls")) \
            == CheckStatus.ERROR
        assert status_of(t, error_check().is_unique("nonUniqueWithNulls")) \
            == CheckStatus.ERROR

    def test_is_primary_key(self):
        t = get_df_with_unique_columns()
        assert status_of(t, error_check().is_primary_key("unique")) == CheckStatus.SUCCESS
        # a primary key must also be complete: uniqueWithNulls fails
        assert status_of(t, error_check().is_primary_key("uniqueWithNulls")) \
            == CheckStatus.ERROR
        assert status_of(
            t, error_check().is_primary_key("halfUniqueCombinedWithNonUnique", "onlyUniqueWithOtherNonUnique")
        ) == CheckStatus.SUCCESS

    def test_has_uniqueness_fractions(self):
        t = get_df_with_unique_columns()
        # halfUniqueCombinedWithNonUnique: values 0,0,0,4,5,6 -> 3 of 6 unique
        assert status_of(
            t,
            error_check().has_uniqueness(
                ["halfUniqueCombinedWithNonUnique"], lambda v: v == 0.5
            ),
        ) == CheckStatus.SUCCESS
        # multi-column uniqueness over the combination
        assert status_of(
            t,
            error_check().has_uniqueness(
                ["halfUniqueCombinedWithNonUnique", "nonUnique"], lambda v: v == 0.5
            ),
        ) == CheckStatus.SUCCESS

    def test_has_unique_value_ratio(self):
        t = get_df_with_unique_columns()
        # nonUnique: groups {0:3, 5:1, 6:1, 7:1} -> 3 unique of 4 groups
        assert status_of(
            t,
            error_check().has_unique_value_ratio(["nonUnique"], lambda v: v == 0.75),
        ) == CheckStatus.SUCCESS
        assert status_of(
            t,
            error_check().has_unique_value_ratio(["nonUnique"], lambda v: v > 0.75),
        ) == CheckStatus.ERROR

    def test_has_distinctness(self):
        t = get_df_with_distinct_values()
        # att1: groups a,b,c of 6 rows -> 0.5
        assert status_of(
            t, error_check().has_distinctness(["att1"], lambda v: v == 0.5)
        ) == CheckStatus.SUCCESS
        # att2: groups x,y of 6 rows -> 1/3
        assert status_of(
            t, error_check().has_distinctness(["att2"], lambda v: abs(v - 1 / 3) < 1e-12)
        ) == CheckStatus.SUCCESS

    def test_has_number_of_distinct_values(self):
        # histogram semantics: NullValue is a bin (att1: a,b,c + NullValue)
        t = get_df_with_distinct_values()
        assert status_of(
            t, error_check().has_number_of_distinct_values("att1", lambda v: v == 4)
        ) == CheckStatus.SUCCESS
        assert status_of(
            t, error_check().has_number_of_distinct_values("att2", lambda v: v == 3)
        ) == CheckStatus.SUCCESS
        assert status_of(
            t, error_check().has_number_of_distinct_values("att2", lambda v: v == 2)
        ) == CheckStatus.ERROR


class TestHistogramAndEntropy:
    """reference: CheckTest.scala:275-320."""

    def test_has_histogram_values_ratios(self):
        t = get_df_missing()
        # att1 non-null: a x4, b x2; NullValue x6 of 12 rows
        check = error_check().has_histogram_values(
            "att1",
            lambda d: d.values["a"].ratio == 4 / 12
            and d.values["b"].ratio == 2 / 12
            and d.values["NullValue"].ratio == 6 / 12,
        )
        assert status_of(t, check) == CheckStatus.SUCCESS

    def test_has_histogram_values_absolutes(self):
        check = error_check().has_histogram_values(
            "att1",
            lambda d: d.values["a"].absolute == 4 and d.values["b"].absolute == 2,
        )
        assert status_of(get_df_missing(), check) == CheckStatus.SUCCESS

    def test_has_entropy_exact(self):
        t = get_df_full()  # att1: a x3, b x1 over 4 rows
        expected = -(3 / 4 * np.log(3 / 4) + 1 / 4 * np.log(1 / 4))
        assert status_of(
            t, error_check().has_entropy("att1", lambda v: abs(v - expected) < 1e-12)
        ) == CheckStatus.SUCCESS
        assert status_of(
            t, error_check().has_entropy("att1", lambda v: v == 0)
        ) == CheckStatus.ERROR


class TestBasicStats:
    """reference: CheckTest.scala:321-351 'yield correct results for
    basic stats' — exact values through the check surface."""

    def test_all_stats_exact(self):
        t = get_df_with_numeric_values()
        att1 = np.array([1, 2, 3, 4, 5, 6], dtype=np.float64)
        check = (
            error_check()
            .has_min("att1", lambda v: v == 1.0)
            .has_max("att1", lambda v: v == 6.0)
            .has_mean("att1", lambda v: v == 3.5)
            .has_sum("att1", lambda v: v == 21.0)
            .has_standard_deviation(
                "att1", lambda v: abs(v - float(np.std(att1))) < 1e-12
            )
            .has_approx_count_distinct("att1", lambda v: v == 6.0)
        )
        assert status_of(t, check) == CheckStatus.SUCCESS

    def test_approx_quantile(self):
        t = get_df_with_numeric_values()
        assert status_of(
            t,
            error_check().has_approx_quantile("att1", 0.5, lambda v: 3.0 <= v <= 4.0),
        ) == CheckStatus.SUCCESS

    def test_correlation_of_column_with_itself_is_one(self):
        t = get_df_with_numeric_values()
        assert status_of(
            t,
            error_check().has_correlation("att1", "att1", lambda v: v == 1.0),
        ) == CheckStatus.SUCCESS

    def test_stats_with_where_filter(self):
        t = get_df_with_numeric_values()
        check = (
            error_check()
            .has_mean("att1", lambda v: v == 5.0)
            .where("att2 > 0")  # rows 4,5,6
        )
        assert status_of(t, check) == CheckStatus.SUCCESS

    def test_mutual_information(self):
        t = get_df_with_numeric_values()
        # att1 determines att2 -> MI = H(att2)
        check = error_check().has_mutual_information(
            "att1", "att2", lambda v: v > 0.0
        )
        assert status_of(t, check) == CheckStatus.SUCCESS

    def test_stat_on_non_numeric_column_errors(self):
        assert status_of(
            get_df_full(), error_check().has_mean("att1", lambda v: True)
        ) == CheckStatus.ERROR


class TestColumnComparisons:
    """reference: CheckTest.scala:156-192 (conditional column constraints)."""

    def test_is_less_than(self):
        t = get_df_with_numeric_values()
        assert status_of(t, error_check().is_less_than("att1", "att2").where("item > '3'")) \
            == CheckStatus.SUCCESS
        assert status_of(t, error_check().is_less_than("att1", "att2")) \
            == CheckStatus.ERROR

    def test_is_less_than_or_equal_to(self):
        t = get_df_with_numeric_values()
        assert status_of(
            t, error_check().is_less_than_or_equal_to("att1", "att2").where("item > '3'")
        ) == CheckStatus.SUCCESS

    def test_is_greater_than(self):
        t = get_df_with_numeric_values()
        assert status_of(t, error_check().is_greater_than("att2", "att1").where("item > '3'")) \
            == CheckStatus.SUCCESS
        assert status_of(t, error_check().is_greater_than("att1", "att2")) \
            == CheckStatus.ERROR

    def test_is_greater_than_or_equal_to(self):
        t = get_df_with_numeric_values()
        assert status_of(
            t,
            error_check().is_greater_than_or_equal_to("att2", "att1").where("item > '3'"),
        ) == CheckStatus.SUCCESS


class TestSignChecks:
    """reference: CheckTest.scala:478-489 + the NULL-coalescing predicate
    (Check.scala:676)."""

    def test_is_non_negative_passes_with_nulls(self):
        # COALESCE(col, 0) >= 0: nulls count as satisfied
        t = Table.from_pydict({"v": [1.0, 0.0, None, 5.5]})
        assert status_of(t, error_check().is_non_negative("v")) == CheckStatus.SUCCESS

    def test_is_non_negative_fails_on_negative(self):
        t = Table.from_pydict({"v": [1.0, -0.5, 2.0]})
        assert status_of(t, error_check().is_non_negative("v")) == CheckStatus.ERROR

    def test_is_positive(self):
        assert status_of(
            Table.from_pydict({"v": [1, 2, 3]}), error_check().is_positive("v")
        ) == CheckStatus.SUCCESS
        # zero is not positive
        assert status_of(
            Table.from_pydict({"v": [0, 1, 2]}), error_check().is_positive("v")
        ) == CheckStatus.ERROR

    def test_numeric_string_column_is_coerced(self):
        # reference runs these on string columns holding numbers
        t = Table.from_pydict({"v": ["-1", "-2", "-3"]})
        assert status_of(t, error_check().is_non_negative("v")) == CheckStatus.ERROR


class TestSatisfies:
    """reference: CheckTest.scala:194+ (compliance)."""

    def test_full_compliance(self):
        t = get_df_with_numeric_values()
        assert status_of(
            t, error_check().satisfies("att1 > 0", "positive")
        ) == CheckStatus.SUCCESS

    def test_fractional_compliance_with_assertion(self):
        t = get_df_with_numeric_values()
        assert status_of(
            t,
            error_check().satisfies(
                "att1 > 3", "bigger than 3", lambda v: v == 0.5
            ),
        ) == CheckStatus.SUCCESS

    def test_compliance_where_filter(self):
        t = get_df_with_numeric_values()
        check = error_check().satisfies(
            "att2 > 0", "att2 positive on filtered", lambda v: v == 1.0
        ).where("att1 > 3")
        assert status_of(t, check) == CheckStatus.SUCCESS

    def test_invalid_expression_is_error(self):
        assert status_of(
            get_df_with_numeric_values(),
            error_check().satisfies("SELECT GARBAGE ( (", "bad"),
        ) == CheckStatus.ERROR


class TestDataTypeCheck:
    """reference: CheckTest.scala:430-438."""

    def test_integral_column(self):
        t = Table.from_pydict({"v": ["1", "2", "3"]})
        assert status_of(
            t,
            error_check().has_data_type(
                "v", ConstrainableDataTypes.INTEGRAL, lambda v: v == 1.0
            ),
        ) == CheckStatus.SUCCESS

    def test_fractional_ratio(self):
        t = Table.from_pydict({"v": ["1.0", "2.0", "3"]})
        # 2 of 3 fractional
        assert status_of(
            t,
            error_check().has_data_type(
                "v", ConstrainableDataTypes.FRACTIONAL, lambda v: abs(v - 2 / 3) < 1e-12
            ),
        ) == CheckStatus.SUCCESS

    def test_numeric_union_type(self):
        t = Table.from_pydict({"v": ["1.0", "2", "x"]})
        assert status_of(
            t,
            error_check().has_data_type(
                "v", ConstrainableDataTypes.NUMERIC, lambda v: abs(v - 2 / 3) < 1e-12
            ),
        ) == CheckStatus.SUCCESS

    def test_boolean_type(self):
        t = Table.from_pydict({"v": ["true", "false", "true"]})
        assert status_of(
            t,
            error_check().has_data_type(
                "v", ConstrainableDataTypes.BOOLEAN, lambda v: v == 1.0
            ),
        ) == CheckStatus.SUCCESS


class TestStatusPrecedence:
    """Overall status = max severity over checks
    (reference: VerificationSuite.scala:272-278)."""

    def test_warning_and_error_mix(self):
        t = get_df_missing()
        result = (
            VerificationSuite.on_data(t)
            .add_check(warning_check().is_complete("att1"))  # fails -> WARNING
            .add_check(error_check().is_complete("item"))  # passes
            .run()
        )
        assert result.status == CheckStatus.WARNING
        result = (
            VerificationSuite.on_data(t)
            .add_check(warning_check().is_complete("att1"))  # fails -> WARNING
            .add_check(error_check().is_complete("att2"))  # fails -> ERROR
            .run()
        )
        assert result.status == CheckStatus.ERROR

    def test_success_when_all_pass(self):
        result = (
            VerificationSuite.on_data(get_df_full())
            .add_check(error_check().is_complete("att1"))
            .add_check(warning_check().has_size(lambda n: n == 4))
            .run()
        )
        assert result.status == CheckStatus.SUCCESS

    def test_constraint_order_preserved(self):
        check = (
            error_check()
            .is_complete("item")
            .has_size(lambda n: n == 4)
            .is_unique("item")
        )
        statuses = constraint_statuses(get_df_full(), check)
        assert len(statuses) == 3
        assert all(s == ConstraintStatus.SUCCESS for s in statuses)


class TestExoticColumnNames:
    """reference: CheckTest.scala:491-558 — special characters must
    survive the expression layer via backtick quoting."""

    @pytest.fixture
    def table(self):
        return Table.from_pydict(
            {"item.one with spaces": ["a", "b", "c"], "thing#2": [1.0, 2.0, 3.0]}
        )

    def test_completeness(self, table):
        assert status_of(
            table, error_check().is_complete("item.one with spaces")
        ) == CheckStatus.SUCCESS

    def test_contained_in_values(self, table):
        assert status_of(
            table,
            error_check().is_contained_in("item.one with spaces", ("a", "b", "c")),
        ) == CheckStatus.SUCCESS

    def test_contained_in_bounds(self, table):
        assert status_of(
            table,
            error_check().is_contained_in("thing#2", lower_bound=0.5, upper_bound=3.5),
        ) == CheckStatus.SUCCESS


class TestHints:
    """Hints ride through to constraint messages
    (reference: constraints carry `hint`)."""

    def test_hint_in_failed_constraint_message(self):
        result = (
            VerificationSuite.on_data(get_df_missing())
            .add_check(
                error_check().has_completeness(
                    "att1", lambda v: v > 0.9, hint="att1 must be well-populated"
                )
            )
            .run()
        )
        rows = result.check_results_as_rows()
        assert any(
            "att1 must be well-populated" in (row["constraint_message"] or "")
            for row in rows
        )
