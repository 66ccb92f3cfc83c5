"""Check DSL + VerificationSuite end-to-end (mirrors reference
checks/CheckTest.scala, VerificationSuiteTest.scala and the README
BasicExample contract from BASELINE.md).

Port-mapped from tests/test_checks_and_verification.py: the same cases
against deequ_tpu_torch, with every run on device="cpu" and the toy
tables of tests/fixtures.py as the port's tables
(tests/torch_fixtures.py).
"""

import json

import pytest

from deequ_tpu_torch import (
    Check,
    CheckLevel,
    CheckStatus,
    ConstrainableDataTypes,
    Table,
    VerificationSuite,
)
from deequ_tpu_torch.analyzers import Size
from deequ_tpu_torch.constraints.constraint import ConstraintStatus
from deequ_tpu_torch.ops import runtime

from torch_fixtures import (
    get_basic_example_table,
    get_df_full,
    get_df_missing,
    get_df_with_numeric_values,
    get_df_with_unique_columns,
)


class TestBasicExample:
    """The README contract: Completeness(name)=0.8 fails, containsURL=0.4
    fails, everything else passes (reference: examples/BasicExample.scala +
    README.md:113-119)."""

    def run_example(self):
        data = get_basic_example_table()
        return (
            VerificationSuite.on_data(data, device="cpu")
            .add_check(
                Check(CheckLevel.ERROR, "integrity checks")
                .has_size(lambda s: s == 5)
                .is_complete("id")
                .is_unique("id")
                .is_complete("name")
                .is_contained_in("priority", ["high", "low"])
                .is_non_negative("numViews")
            )
            .add_check(
                Check(CheckLevel.WARNING, "distribution checks")
                .contains_url("description", lambda v: v >= 0.5)
                .has_approx_quantile("numViews", 0.5, lambda v: v <= 10)
            )
            .run()
        )

    def test_overall_status(self):
        result = self.run_example()
        assert result.status == CheckStatus.ERROR

    def test_failing_constraints_and_messages(self):
        result = self.run_example()
        failures = [
            r
            for check_result in result.check_results.values()
            for r in check_result.constraint_results
            if r.status != ConstraintStatus.SUCCESS
        ]
        by_name = {repr(r.constraint): r for r in failures}
        assert len(failures) == 2
        assert (
            by_name["CompletenessConstraint(Completeness(name,None))"].message
            == "Value: 0.8 does not meet the constraint requirement!"
        )
        assert (
            by_name["containsURL(description)"].message
            == "Value: 0.4 does not meet the constraint requirement!"
        )

    def test_check_levels(self):
        result = self.run_example()
        statuses = {
            check.description: res.status for check, res in result.check_results.items()
        }
        assert statuses["integrity checks"] == CheckStatus.ERROR
        assert statuses["distribution checks"] == CheckStatus.WARNING

    def test_single_fused_scan_plus_grouping(self):
        data = get_basic_example_table()
        with runtime.monitored() as stats:
            self.run_example.__wrapped__(self) if hasattr(self.run_example, "__wrapped__") else self.run_example()
        # 1 fused scan (size/completeness×2/compliance×2/pattern/quantile)
        # + 2 jobs for the uniqueness grouping set
        assert stats.device_passes + stats.group_passes == 3


class TestCheckDSL:
    def test_has_size_where(self):
        df = get_df_with_numeric_values()
        check = Check(CheckLevel.ERROR, "size").has_size(lambda s: s == 3).where("att1 > 3")
        result = VerificationSuite().run(df, [check], device="cpu")
        assert result.status == CheckStatus.SUCCESS

    def test_completeness_family(self):
        df = get_df_missing()
        check = (
            Check(CheckLevel.ERROR, "completeness")
            .has_completeness("att1", lambda v: v == 0.5)
            .has_completeness("att2", lambda v: v == 0.75)
        )
        result = VerificationSuite().run(df, [check], device="cpu")
        assert result.status == CheckStatus.SUCCESS

    def test_uniqueness_and_primary_key(self):
        df = get_df_with_unique_columns()
        good = (
            Check(CheckLevel.ERROR, "unique")
            .is_unique("unique")
            .is_primary_key("unique", "nonUnique")
            .has_uniqueness("nonUnique", lambda v: v == 0.5)
            .has_distinctness(["nonUnique"], lambda v: v == pytest.approx(4 / 6))
            .has_unique_value_ratio(["nonUnique"], lambda v: v == 0.75)
        )
        result = VerificationSuite().run(df, [good], device="cpu")
        assert result.status == CheckStatus.SUCCESS

    def test_min_max_mean_sum_std(self):
        df = get_df_with_numeric_values()
        check = (
            Check(CheckLevel.ERROR, "numbers")
            .has_min("att1", lambda v: v == 1.0)
            .has_max("att1", lambda v: v == 6.0)
            .has_mean("att1", lambda v: v == 3.5)
            .has_sum("att1", lambda v: v == 21.0)
            .has_standard_deviation("att1", lambda v: abs(v - 1.707825) < 1e-5)
            .has_approx_count_distinct("att1", lambda v: v == 6.0)
            .has_correlation("att1", "att2", lambda v: v > 0.9)
        )
        result = VerificationSuite().run(df, [check], device="cpu")
        for r in list(result.check_results.values())[0].constraint_results:
            assert r.status == ConstraintStatus.SUCCESS, (repr(r.constraint), r.message)

    def test_comparison_dsl(self):
        df = get_df_with_numeric_values()
        check = (
            Check(CheckLevel.ERROR, "cmp")
            .is_less_than_or_equal_to("att1", "att2")
            .where("att1 > 3")
            .is_non_negative("att1")
            .is_positive("att1")
        )
        result = VerificationSuite().run(df, [check], device="cpu")
        assert result.status == CheckStatus.SUCCESS

    def test_is_contained_in_range(self):
        df = get_df_with_numeric_values()
        check = Check(CheckLevel.ERROR, "range").is_contained_in(
            "att1", lower_bound=1.0, upper_bound=6.0
        )
        result = VerificationSuite().run(df, [check], device="cpu")
        assert result.status == CheckStatus.SUCCESS

    def test_entropy_and_mi(self):
        df = get_df_full()
        import numpy as np

        expected = -(3 / 4) * np.log(3 / 4) - (1 / 4) * np.log(1 / 4)
        check = (
            Check(CheckLevel.ERROR, "info")
            .has_entropy("att1", lambda v: v == pytest.approx(expected))
            # joint (a,c):3,(b,d):1 -> MI = 3/4·ln(4/3) + 1/4·ln(4)
            .has_mutual_information(
                "att1", "att2",
                lambda v: v == pytest.approx(0.75 * np.log(4 / 3) + 0.25 * np.log(4.0)),
            )
        )
        result = VerificationSuite().run(df, [check], device="cpu")
        for r in list(result.check_results.values())[0].constraint_results:
            assert r.status == ConstraintStatus.SUCCESS, (repr(r.constraint), r.message)

    def test_has_data_type(self):
        df = Table.from_pydict({"s": ["1", "2", "3.0"]})
        check = Check(CheckLevel.ERROR, "dt").has_data_type(
            "s", ConstrainableDataTypes.NUMERIC
        )
        result = VerificationSuite().run(df, [check], device="cpu")
        assert result.status == CheckStatus.SUCCESS
        check2 = Check(CheckLevel.ERROR, "dt2").has_data_type(
            "s", ConstrainableDataTypes.INTEGRAL, lambda v: v == pytest.approx(2 / 3)
        )
        result2 = VerificationSuite().run(df, [check2], device="cpu")
        assert result2.status == CheckStatus.SUCCESS

    def test_histogram_dsl(self):
        df = get_df_missing()
        check = (
            Check(CheckLevel.ERROR, "hist")
            .has_number_of_distinct_values("att1", lambda n: n == 3)
            .has_histogram_values("att1", lambda d: d["a"].absolute == 4)
        )
        result = VerificationSuite().run(df, [check], device="cpu")
        assert result.status == CheckStatus.SUCCESS

    def test_pattern_dsl(self):
        df = Table.from_pydict(
            {
                "email": ["someone@somewhere.org", "nope"],
                "ssn": ["123-45-6789", "123-45-6789"],
            }
        )
        check = (
            Check(CheckLevel.ERROR, "patterns")
            .contains_email("email", lambda v: v == 0.5)
            .contains_social_security_number("ssn")
        )
        result = VerificationSuite().run(df, [check], device="cpu")
        assert result.status == CheckStatus.SUCCESS

    def test_warning_level_check(self):
        df = get_df_missing()
        check = Check(CheckLevel.WARNING, "warn").is_complete("att1")
        result = VerificationSuite().run(df, [check], device="cpu")
        assert result.status == CheckStatus.WARNING

    def test_missing_analysis_message(self):
        from deequ_tpu_torch.runners.context import AnalyzerContext

        check = Check(CheckLevel.ERROR, "x").is_complete("att1")
        result = check.evaluate(AnalyzerContext.empty())
        assert result.constraint_results[0].message == (
            "Missing Analysis, can't run the constraint!"
        )

    def test_failure_metric_propagates_message(self):
        df = get_df_full()
        check = Check(CheckLevel.ERROR, "x").has_mean("att1", lambda v: True)
        result = VerificationSuite().run(df, [check], device="cpu")
        cr = list(result.check_results.values())[0].constraint_results[0]
        assert cr.status == ConstraintStatus.FAILURE
        assert "Expected type of column att1" in cr.message


class TestVerificationResult:
    def test_exports(self):
        df = get_df_with_numeric_values()
        result = VerificationSuite().run(
            df,
            [Check(CheckLevel.ERROR, "group-1").has_size(lambda s: s == 6).has_mean("att1", lambda v: v == 3.5)], device="cpu"
        )
        metrics = result.success_metrics_as_rows()
        assert {
            "entity": "Dataset",
            "instance": "*",
            "name": "Size",
            "value": 6.0,
        } in metrics
        checks = json.loads(result.check_results_as_json())
        assert len(checks) == 2
        assert all(r["check"] == "group-1" for r in checks)
        assert all(r["constraint_status"] == "Success" for r in checks)

    def test_required_analyzers_deduped_across_checks(self):
        df = get_df_with_numeric_values()
        with runtime.monitored() as stats:
            VerificationSuite().run(
                df,
                [
                    Check(CheckLevel.ERROR, "a").is_complete("att1"),
                    Check(CheckLevel.WARNING, "b").has_completeness("att1", lambda v: v > 0.5),
                ], device="cpu"
            )
        assert stats.device_passes == 1
