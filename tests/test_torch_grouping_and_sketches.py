"""Grouping-analyzer + sketch tests (mirrors reference AnalyzerTests
uniqueness/entropy/MI sections, NullHandlingTests frequency cases, and the
approximate analyzer error-bound tests).

Port-mapped from tests/test_grouping_and_sketches.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    ApproxQuantiles,
    CountDistinct,
    Distinctness,
    Entropy,
    Histogram,
    MutualInformation,
    UniqueValueRatio,
    Uniqueness,
    compute_frequencies,
)
from deequ_tpu_torch.core.exceptions import (
    EmptyStateException,
    IllegalAnalyzerParameterException,
    NumberOfSpecifiedColumnsException,
)
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.runners import AnalysisRunner

from torch_fixtures import (
    get_df_full,
    get_df_missing,
    get_df_with_conditionally_informative_columns,
    get_df_with_conditionally_uninformative_columns,
    get_df_with_distinct_values,
    get_df_with_unique_columns,
    get_full_nulls,
)

pytestmark = pytest.mark.usefixtures("cpu_default")


def value_of(metric):
    assert metric.value.is_success, f"expected success, got {metric.value}"
    return metric.value.get()


def failure_of(metric):
    assert metric.value.is_failure, f"expected failure, got {metric.value}"
    return metric.value.exception


class TestUniquenessFamily:
    def test_uniqueness(self):
        df = get_df_with_unique_columns()
        assert value_of(Uniqueness("unique").calculate(df)) == 1.0
        assert value_of(Uniqueness("uniqueWithNulls").calculate(df)) == pytest.approx(5 / 6)
        assert value_of(Uniqueness("nonUnique").calculate(df)) == pytest.approx(3 / 6)

    def test_uniqueness_multi_column(self):
        df = get_df_full()
        # (a,c) x3? fixture: att1=[a,a,a,b], att2=[c,c,c,d] -> groups (a,c):3,(b,d):1
        assert value_of(Uniqueness(["att1", "att2"]).calculate(df)) == pytest.approx(1 / 4)

    def test_distinctness(self):
        df = get_df_with_distinct_values()
        assert value_of(Distinctness(["att1"]).calculate(df)) == pytest.approx(3 / 6)
        assert value_of(Distinctness(["att2"]).calculate(df)) == pytest.approx(2 / 6)

    def test_unique_value_ratio(self):
        df = get_df_with_unique_columns()
        # nonUnique groups: {0:3, 5:1, 6:1, 7:1} -> 3 unique / 4 distinct
        assert value_of(UniqueValueRatio(["nonUnique"]).calculate(df)) == pytest.approx(3 / 4)

    def test_count_distinct(self):
        df = get_df_with_unique_columns()
        assert value_of(CountDistinct("uniqueWithNulls").calculate(df)) == 5.0

    def test_fully_null_column(self):
        df = get_full_nulls()
        assert value_of(CountDistinct("att1").calculate(df)) == 0.0
        err = failure_of(Uniqueness("att1").calculate(df))
        assert isinstance(err, EmptyStateException)
        err = failure_of(Entropy("att1").calculate(df))
        assert isinstance(err, EmptyStateException)


class TestEntropyAndMI:
    def test_entropy(self):
        df = get_df_full()
        # att1: a:3, b:1 over 4 rows
        expected = -(3 / 4) * np.log(3 / 4) - (1 / 4) * np.log(1 / 4)
        assert value_of(Entropy("att1").calculate(df)) == pytest.approx(expected)

    def test_mutual_information_uninformative(self):
        df = get_df_with_conditionally_uninformative_columns()
        assert value_of(MutualInformation("att1", "att2").calculate(df)) == pytest.approx(0.0)

    def test_mutual_information_informative(self):
        df = get_df_with_conditionally_informative_columns()
        # deterministic 1:1 mapping: MI == entropy of att1 (ln 3)
        assert value_of(MutualInformation("att1", "att2").calculate(df)) == pytest.approx(
            np.log(3)
        )

    def test_entropy_equals_mi_with_self(self):
        df = get_df_full()
        mi = value_of(MutualInformation("att1", "att1").calculate(df))
        entropy = value_of(Entropy("att1").calculate(df))
        assert mi == pytest.approx(entropy)

    def test_mi_requires_two_columns(self):
        df = get_df_full()
        err = failure_of(MutualInformation(["att1", "att2", "item"]).calculate(df))
        assert isinstance(err, NumberOfSpecifiedColumnsException)


class TestFrequencyState:
    def test_state_merge_equals_whole(self):
        df = get_df_missing()
        left, right = df.slice(0, 6), df.slice(6, 12)
        whole = compute_frequencies(df, ["att1"])
        merged = compute_frequencies(left, ["att1"]).merge(
            compute_frequencies(right, ["att1"])
        )
        assert merged == whole

    def test_null_rows_excluded_but_counted(self):
        df = get_full_nulls()
        state = compute_frequencies(df, ["att1"])
        assert state.num_rows == 3
        assert state.num_groups == 0


class TestHistogram:
    def test_histogram_with_nulls(self):
        df = get_df_missing()
        dist = value_of(Histogram("att1").calculate(df))
        assert dist.number_of_bins == 3  # a, b, NullValue
        assert dist["a"].absolute == 4
        assert dist["b"].absolute == 2
        assert dist["NullValue"].absolute == 6
        assert dist["a"].ratio == pytest.approx(4 / 12)

    def test_histogram_numeric_column(self):
        df = Table.from_pydict({"x": [1, 1, 2, None]})
        dist = value_of(Histogram("x").calculate(df))
        assert dist["1"].absolute == 2
        assert dist["NullValue"].absolute == 1

    def test_max_bins_cap(self):
        df = get_df_full()
        err = failure_of(Histogram("att1", max_detail_bins=1001).calculate(df))
        assert isinstance(err, IllegalAnalyzerParameterException)

    def test_detail_bins_limited_but_bincount_full(self):
        df = Table.from_pydict({"x": list("abcdef")})
        dist = value_of(Histogram("x", max_detail_bins=3).calculate(df))
        assert dist.number_of_bins == 6
        assert len(dist.values) == 3


class TestApproxCountDistinct:
    def test_small_exact(self):
        df = get_df_with_unique_columns()
        assert value_of(ApproxCountDistinct("uniqueWithNulls").calculate(df)) == 5.0

    def test_with_filter(self):
        df = get_df_with_unique_columns()
        m = ApproxCountDistinct("uniqueWithNulls", where="unique < 4").calculate(df)
        assert value_of(m) == 2.0

    def test_fully_null_is_zero(self):
        df = get_full_nulls()
        assert value_of(ApproxCountDistinct("att1").calculate(df)) == 0.0

    def test_error_bound_large(self):
        rng = np.random.default_rng(3)
        n = 50_000
        values = rng.integers(0, 20_000, n)
        df = Table.from_numpy({"x": values})
        exact = len(np.unique(values))
        est = value_of(ApproxCountDistinct("x").calculate(df))
        assert abs(est - exact) / exact < 0.12  # ~2.4 sigma at rsd 0.05

    def test_state_merge(self):
        df = Table.from_pydict({"x": [str(i) for i in range(100)]})
        left, right = df.slice(0, 50), df.slice(50, 100)
        sa = ApproxCountDistinct("x").compute_state_from(left)
        sb = ApproxCountDistinct("x").compute_state_from(right)
        merged = sa.merge(sb)
        direct = ApproxCountDistinct("x").compute_state_from(df)
        assert np.array_equal(merged.registers, direct.registers)


class TestApproxQuantile:
    def test_median_small(self):
        df = Table.from_pydict({"x": [0, 0, 5, 10, 12]})
        assert value_of(ApproxQuantile("x", 0.5).calculate(df)) == 5.0

    def test_quantiles_within_bounds(self):
        df = Table.from_numpy({"x": np.arange(-1000, 1000).astype(np.float64)})
        assert -20 < value_of(ApproxQuantile("x", 0.5).calculate(df)) < 20
        assert -520 < value_of(ApproxQuantile("x", 0.25).calculate(df)) < -480
        assert 480 < value_of(ApproxQuantile("x", 0.75).calculate(df)) < 520

    def test_param_checks(self):
        df = Table.from_pydict({"x": [1, 2, 3]})
        err = failure_of(ApproxQuantile("x", 0.5, relative_error=1.1).calculate(df))
        assert isinstance(err, IllegalAnalyzerParameterException)
        assert str(err) == (
            "Relative error parameter must be in the closed interval [0, 1]. "
            "Currently, the value is: 1.1!"
        )
        err = failure_of(ApproxQuantile("x", -0.2).calculate(df))
        assert "Quantile parameter" in str(err)

    def test_fully_null(self):
        df = Table.from_numpy({"x": np.array([np.nan, np.nan])})
        err = failure_of(ApproxQuantile("x", 0.5).calculate(df))
        assert isinstance(err, EmptyStateException)

    def test_approx_quantiles_keyed(self):
        df = Table.from_numpy({"x": np.arange(100).astype(np.float64)})
        metric = ApproxQuantiles("x", [0.25, 0.5, 0.75]).calculate(df)
        values = metric.value.get()
        assert set(values.keys()) == {"0.25", "0.5", "0.75"}
        assert values["0.5"] == pytest.approx(49.5, abs=2)
        flat = metric.flatten()
        assert {m.name for m in flat} == {
            "ApproxQuantiles-0.25",
            "ApproxQuantiles-0.5",
            "ApproxQuantiles-0.75",
        }

    def test_merge_parity(self):
        rng = np.random.default_rng(5)
        values = rng.normal(size=10_000)
        df = Table.from_numpy({"x": values})
        a = ApproxQuantile("x", 0.5)
        s1 = a.compute_state_from(df.slice(0, 5000))
        s2 = a.compute_state_from(df.slice(5000, 10000))
        merged_median = s1.merge(s2).digest.quantile(0.5)
        exact = float(np.quantile(values, 0.5))
        assert abs(merged_median - exact) < 0.05


class TestGroupingJobCounts:
    def test_shared_frequency_pass(self):
        df = get_df_with_unique_columns()
        analyzers = [
            Uniqueness("nonUnique"),
            UniqueValueRatio(["nonUnique"]),
            Distinctness(["nonUnique"]),
            Entropy("nonUnique"),
        ]
        # separate: 2 jobs each = 8
        with runtime.monitored() as separate:
            results = [a.calculate(df) for a in analyzers]
        assert separate.jobs == 8

        # fused: 1 group-by + 1 shared aggregation = 2 jobs
        with runtime.monitored() as fused:
            context = AnalysisRunner.on_data(df).add_analyzers(analyzers).run()
        assert fused.jobs == 2

        for analyzer, sep in zip(analyzers, results):
            assert context.metric(analyzer).value.get() == sep.value.get()

    def test_mixed_scan_and_grouping(self):
        from deequ_tpu_torch.analyzers import Completeness, Size

        df = get_df_with_unique_columns()
        with runtime.monitored() as stats:
            context = (
                AnalysisRunner.on_data(df)
                .add_analyzers(
                    [
                        Size(),
                        Completeness("unique"),
                        Uniqueness("nonUnique"),
                        Distinctness(["nonUnique"]),
                        Uniqueness(["nonUnique", "unique"]),
                    ]
                )
                .run()
            )
        # 1 scan + (2 jobs × 2 grouping sets) = 5
        assert stats.jobs == 5
        assert all(m.value.is_success for m in context.all_metrics())
