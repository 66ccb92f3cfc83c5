"""Per-rule trigger boundaries + generated code strings + evaluated
candidates — the depth of the reference's ConstraintRulesTest.scala
(728 LoC) and ConstraintSuggestionResultTest.scala (498 LoC). Rules are
unit-tested against hand-built profiles (the reference's style), and
each candidate constraint is re-evaluated against data that should
satisfy / violate it.

Port-mapped from tests/test_constraint_rules_full.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import math

import pytest

from deequ_tpu_torch.analyzers.scan import DataTypeInstances
from deequ_tpu_torch.core.metrics import Distribution, DistributionValue
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.profiles.column_profile import (
    NumericColumnProfile,
    StandardColumnProfile,
)
from deequ_tpu_torch.suggestions.rules import (
    DEFAULT_RULES,
    CategoricalRangeRule,
    CompleteIfCompleteRule,
    FractionalCategoricalRangeRule,
    NonNegativeNumbersRule,
    RetainCompletenessRule,
    RetainTypeRule,
    Rules,
    UniqueIfApproximatelyUniqueRule,
)
from deequ_tpu_torch.constraints.constraint import ConstraintStatus
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

pytestmark = pytest.mark.usefixtures("cpu_default")


def string_profile(column="col", completeness=1.0, distinct=10,
                   data_type=DataTypeInstances.STRING, inferred=False,
                   histogram=None):
    return StandardColumnProfile(
        column, completeness, distinct, data_type, inferred, {}, histogram
    )


def numeric_profile(column="col", completeness=1.0, distinct=10,
                    minimum=None, data_type=DataTypeInstances.INTEGRAL):
    return NumericColumnProfile(
        column, completeness, distinct, data_type, True, {}, None,
        mean=1.0, maximum=10.0, minimum=minimum, sum=10.0, std_dev=1.0,
    )


def evaluate_candidate(suggestion, table: Table) -> ConstraintStatus:
    """Run the suggested constraint against real data (the reference
    round-trips candidates through VerificationSuite the same way)."""
    constraint = suggestion.constraint
    inner = getattr(constraint, "inner", constraint)  # unwrap NamedConstraint
    ctx = AnalysisRunner.do_analysis_run(table, [inner.analyzer])
    return constraint.evaluate(ctx.metric_map).status


class TestCompleteIfCompleteRule:
    """reference: rules/CompleteIfCompleteRule.scala:25 — fires iff
    completeness == 1.0."""

    def test_trigger_boundaries(self):
        rule = CompleteIfCompleteRule()
        assert rule.should_be_applied(string_profile(completeness=1.0), 100)
        assert not rule.should_be_applied(string_profile(completeness=0.99), 100)
        assert not rule.should_be_applied(string_profile(completeness=0.0), 100)

    def test_code_string(self):
        s = CompleteIfCompleteRule().candidate(string_profile(column="abc"), 100)
        assert s.code_for_constraint == '.is_complete("abc")'
        assert s.column_name == "abc"
        assert s.current_value == "Completeness: 1.0"

    def test_candidate_evaluates(self):
        s = CompleteIfCompleteRule().candidate(string_profile(column="v"), 3)
        assert evaluate_candidate(s, Table.from_pydict({"v": ["a", "b", "c"]})) \
            == ConstraintStatus.SUCCESS
        assert evaluate_candidate(s, Table.from_pydict({"v": ["a", None, "c"]})) \
            == ConstraintStatus.FAILURE


class TestRetainCompletenessRule:
    """reference: rules/RetainCompletenessRule.scala:28-43 — fires for
    0.2 < completeness < 1.0; suggests the binomial-CI lower bound
    (z=1.96, floored to 2 decimals)."""

    def test_trigger_boundaries(self):
        rule = RetainCompletenessRule()
        assert not rule.should_be_applied(string_profile(completeness=0.2), 100)
        assert rule.should_be_applied(string_profile(completeness=0.21), 100)
        assert rule.should_be_applied(string_profile(completeness=0.99), 100)
        assert not rule.should_be_applied(string_profile(completeness=1.0), 100)
        assert not rule.should_be_applied(string_profile(completeness=0.1), 100)

    def test_ci_lower_bound_in_code(self):
        p, n = 0.5, 100
        target = math.floor((p - 1.96 * math.sqrt(p * (1 - p) / n)) * 100) / 100
        s = RetainCompletenessRule().candidate(
            string_profile(column="c", completeness=p), n
        )
        assert f"v >= {target}" in s.code_for_constraint
        assert f"above {target}!" in s.code_for_constraint

    def test_candidate_evaluates_against_bound(self):
        # p=0.5, n=4 -> target = floor(0.5 - 1.96*0.25) = 0.01
        s = RetainCompletenessRule().candidate(
            string_profile(column="v", completeness=0.5), 4
        )
        assert evaluate_candidate(
            s, Table.from_pydict({"v": ["a", None, "b", None]})
        ) == ConstraintStatus.SUCCESS


class TestRetainTypeRule:
    """reference: rules/RetainTypeRule.scala:27 — fires only for INFERRED
    Integral/Fractional/Boolean."""

    def test_trigger_matrix(self):
        rule = RetainTypeRule()
        for dt, expected in [
            (DataTypeInstances.INTEGRAL, True),
            (DataTypeInstances.FRACTIONAL, True),
            (DataTypeInstances.BOOLEAN, True),
            (DataTypeInstances.STRING, False),
            (DataTypeInstances.UNKNOWN, False),
        ]:
            profile = string_profile(data_type=dt, inferred=True)
            assert rule.should_be_applied(profile, 10) == expected, dt
        # not inferred (schema-known) -> never fires
        profile = string_profile(data_type=DataTypeInstances.INTEGRAL, inferred=False)
        assert not rule.should_be_applied(profile, 10)

    def test_code_string(self):
        s = RetainTypeRule().candidate(
            string_profile(column="n", data_type=DataTypeInstances.FRACTIONAL,
                           inferred=True),
            10,
        )
        assert s.code_for_constraint == \
            '.has_data_type("n", ConstrainableDataTypes.FRACTIONAL)'

    def test_candidate_evaluates(self):
        s = RetainTypeRule().candidate(
            string_profile(column="v", data_type=DataTypeInstances.INTEGRAL,
                           inferred=True),
            3,
        )
        assert evaluate_candidate(s, Table.from_pydict({"v": ["1", "2", "3"]})) \
            == ConstraintStatus.SUCCESS
        assert evaluate_candidate(s, Table.from_pydict({"v": ["1", "x", "3"]})) \
            == ConstraintStatus.FAILURE


def histogram_of(pairs, total):
    return Distribution(
        {k: DistributionValue(c, c / total) for k, c in pairs}, len(pairs)
    )


class TestCategoricalRangeRule:
    """reference: rules/CategoricalRangeRule.scala:27-60 — fires when the
    ratio of singleton bins is <= 0.1; values ordered by popularity."""

    def test_trigger_boundary(self):
        rule = CategoricalRangeRule()
        # 10 bins, 1 singleton -> ratio 0.1 -> fires
        hist = histogram_of([(f"v{i}", 5) for i in range(9)] + [("solo", 1)], 46)
        assert rule.should_be_applied(string_profile(histogram=hist), 46)
        # 2 singletons of 10 -> 0.2 -> no
        hist = histogram_of(
            [(f"v{i}", 5) for i in range(8)] + [("s1", 1), ("s2", 1)], 42
        )
        assert not rule.should_be_applied(string_profile(histogram=hist), 42)

    def test_requires_string_type_and_histogram(self):
        rule = CategoricalRangeRule()
        hist = histogram_of([("a", 5), ("b", 5)], 10)
        assert not rule.should_be_applied(
            string_profile(data_type=DataTypeInstances.INTEGRAL, histogram=hist), 10
        )
        assert not rule.should_be_applied(string_profile(histogram=None), 10)

    def test_values_ordered_by_popularity_in_code(self):
        hist = histogram_of([("rare", 2), ("common", 10), ("mid", 5)], 17)
        s = CategoricalRangeRule().candidate(
            string_profile(column="cat", histogram=hist), 17
        )
        assert '.is_contained_in("cat", ["common", "mid", "rare"])' \
            == s.code_for_constraint

    def test_quote_escaping(self):
        hist = histogram_of([("it's", 5), ("ok", 5)], 10)
        s = CategoricalRangeRule().candidate(
            string_profile(column="c", histogram=hist), 10
        )
        # SQL-side: doubled single quote (reference Check.scala:836-841)
        inner = getattr(s.constraint, "inner", s.constraint)
        assert "it''s" in inner.analyzer.predicate
        assert evaluate_candidate(
            s, Table.from_pydict({"c": ["it's", "ok", "ok"]})
        ) == ConstraintStatus.SUCCESS

    def test_null_bin_excluded_from_values(self):
        hist = histogram_of([("a", 6), ("NullValue", 3), ("b", 6)], 15)
        s = CategoricalRangeRule().candidate(
            string_profile(column="c", histogram=hist), 15
        )
        assert "NullValue" not in s.code_for_constraint


class TestFractionalCategoricalRangeRule:
    """reference: rules/FractionalCategoricalRangeRule.scala:29 — top
    categories covering >= 0.9, CI-adjusted assertion."""

    def test_fires_on_long_tail(self):
        # 2 big categories cover 90%, tail of 10 singletons
        pairs = [("a", 500), ("b", 400)] + [(f"t{i}", 10) for i in range(10)]
        hist = histogram_of(pairs, 1000)
        rule = FractionalCategoricalRangeRule()
        assert rule.should_be_applied(string_profile(histogram=hist), 1000)

    def test_not_fired_when_all_unique(self):
        pairs = [(f"u{i}", 1) for i in range(10)]
        hist = histogram_of(pairs, 10)
        assert not FractionalCategoricalRangeRule().should_be_applied(
            string_profile(histogram=hist), 10
        )

    def test_code_contains_ci_bound_and_categories(self):
        pairs = [("a", 500), ("b", 400)] + [(f"t{i}", 10) for i in range(10)]
        hist = histogram_of(pairs, 1000)
        s = FractionalCategoricalRangeRule().candidate(
            string_profile(column="c", histogram=hist), 1000
        )
        assert '.is_contained_in("c", ["a", "b"]' in s.code_for_constraint
        assert "lambda v: v >=" in s.code_for_constraint
        # evaluated against matching data: 95% in {a,b} passes the bound
        t = Table.from_pydict({"c": ["a"] * 10 + ["b"] * 9 + ["z"]})
        assert evaluate_candidate(s, t) == ConstraintStatus.SUCCESS


class TestNonNegativeNumbersRule:
    """reference: rules/NonNegativeNumbersRule.scala:25-44."""

    def test_trigger_boundaries(self):
        rule = NonNegativeNumbersRule()
        assert rule.should_be_applied(numeric_profile(minimum=0.0), 10)
        assert rule.should_be_applied(numeric_profile(minimum=4.5), 10)
        assert not rule.should_be_applied(numeric_profile(minimum=-0.01), 10)
        assert not rule.should_be_applied(numeric_profile(minimum=None), 10)
        # non-numeric profile never fires
        assert not rule.should_be_applied(string_profile(), 10)

    def test_code_and_current_value(self):
        s = NonNegativeNumbersRule().candidate(numeric_profile(column="n", minimum=0.0), 10)
        assert s.code_for_constraint == '.is_non_negative("n")'
        assert s.current_value == "Minimum: 0.0"

    def test_candidate_evaluates(self):
        s = NonNegativeNumbersRule().candidate(numeric_profile(column="v", minimum=0.0), 3)
        assert evaluate_candidate(s, Table.from_pydict({"v": [0, 1, 2]})) \
            == ConstraintStatus.SUCCESS
        assert evaluate_candidate(s, Table.from_pydict({"v": [0, -1, 2]})) \
            == ConstraintStatus.FAILURE


class TestUniqueIfApproximatelyUniqueRule:
    """reference: rules/UniqueIfApproximatelyUniqueRule.scala:28-41 —
    NOT in DEFAULT; fires for complete columns whose approx distinct
    count is within 8% of the row count."""

    def test_trigger_boundaries(self):
        rule = UniqueIfApproximatelyUniqueRule()
        assert rule.should_be_applied(string_profile(distinct=100), 100)
        assert rule.should_be_applied(string_profile(distinct=92), 100)
        assert not rule.should_be_applied(string_profile(distinct=91), 100)
        # 108/100: |1-1.08| is one double ulp ABOVE 0.08 — doesn't fire,
        # the same IEEE behavior the reference's Scala doubles have
        assert rule.should_be_applied(string_profile(distinct=107), 100)
        assert not rule.should_be_applied(string_profile(distinct=108), 100)
        assert not rule.should_be_applied(string_profile(distinct=109), 100)
        # incomplete column never fires
        assert not rule.should_be_applied(
            string_profile(completeness=0.99, distinct=100), 100
        )
        assert not rule.should_be_applied(string_profile(distinct=0), 0)

    def test_code_string(self):
        s = UniqueIfApproximatelyUniqueRule().candidate(
            string_profile(column="id", distinct=100), 100
        )
        assert s.code_for_constraint == '.is_unique("id")'

    def test_candidate_evaluates(self):
        s = UniqueIfApproximatelyUniqueRule().candidate(
            string_profile(column="v", distinct=3), 3
        )
        assert evaluate_candidate(s, Table.from_pydict({"v": ["a", "b", "c"]})) \
            == ConstraintStatus.SUCCESS
        assert evaluate_candidate(s, Table.from_pydict({"v": ["a", "a", "c"]})) \
            == ConstraintStatus.FAILURE


class TestRuleSets:
    def test_default_has_six_rules(self):
        """reference: ConstraintSuggestionRunner.scala:29-35."""
        rules = DEFAULT_RULES()
        assert len(rules) == 6
        names = {type(r).__name__ for r in rules}
        assert names == {
            "CompleteIfCompleteRule",
            "RetainCompletenessRule",
            "RetainTypeRule",
            "CategoricalRangeRule",
            "FractionalCategoricalRangeRule",
            "NonNegativeNumbersRule",
        }
        assert "UniqueIfApproximatelyUniqueRule" not in names

    def test_rules_default_constant(self):
        assert len(Rules.DEFAULT) == 6

    def test_every_rule_has_description(self):
        for rule in list(DEFAULT_RULES()) + [UniqueIfApproximatelyUniqueRule()]:
            assert rule.rule_description


class TestSuggestionsEndToEnd:
    """reference: ConstraintSuggestionsIntegrationTest.scala — the rules
    fire on real profiled data and the code strings are executable DSL."""

    @pytest.fixture
    def table(self):
        import numpy as np

        rng = np.random.default_rng(0)
        n = 500
        return Table.from_pydict(
            {
                "id": [f"id{i}" for i in range(n)],
                "status": [["active", "inactive"][i % 2] for i in range(n)],
                "count": [int(v) for v in rng.integers(0, 50, n)],
                "maybe": [("x" if i % 3 else None) for i in range(n)],
            }
        )

    def test_fired_rules(self, table):
        from deequ_tpu_torch.suggestions.runner import ConstraintSuggestionRunner

        result = (
            ConstraintSuggestionRunner.on_data(table)
            .add_constraint_rules(DEFAULT_RULES)
            .run()
        )
        by_col = result.constraint_suggestions
        assert any(
            s.code_for_constraint == '.is_complete("id")' for s in by_col["id"]
        )
        assert any(
            ".is_contained_in" in s.code_for_constraint for s in by_col["status"]
        )
        assert any(
            s.code_for_constraint == '.is_non_negative("count")'
            for s in by_col["count"]
        )
        assert any(
            ".has_completeness" in s.code_for_constraint for s in by_col["maybe"]
        )

    def test_generated_code_is_executable_dsl(self, table):
        """Every generated snippet must parse and run against the Check
        builder (the reference emits compilable Scala; we emit runnable
        Python)."""
        from deequ_tpu_torch import Check, CheckLevel, VerificationSuite
        from deequ_tpu_torch.constraints.constrainable_data_types import (
            ConstrainableDataTypes,
        )
        from deequ_tpu_torch.suggestions.runner import ConstraintSuggestionRunner

        result = (
            ConstraintSuggestionRunner.on_data(table)
            .add_constraint_rules(DEFAULT_RULES)
            .run()
        )
        check = Check(CheckLevel.WARNING, "generated")
        for suggestion in result.all_suggestions():
            check = eval(  # noqa: S307 - our own generated snippets
                "check" + suggestion.code_for_constraint,
                {"check": check, "ConstrainableDataTypes": ConstrainableDataTypes},
            )
        outcome = VerificationSuite.on_data(table).add_check(check).run()
        statuses = [
            cr.status
            for cr in next(iter(outcome.check_results.values())).constraint_results
        ]
        assert statuses and all(
            s == ConstraintStatus.SUCCESS for s in statuses
        ), statuses
