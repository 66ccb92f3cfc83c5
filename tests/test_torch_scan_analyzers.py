"""Analyzer unit tests: toy tables -> exact metric values incl. NaN /
empty / failure cases (mirrors reference analyzers/AnalyzerTests.scala and
NullHandlingTests.scala).

Port-mapped from tests/test_scan_analyzers.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import (
    Completeness,
    Compliance,
    Correlation,
    DataType,
    DataTypeInstances,
    Maximum,
    Mean,
    Minimum,
    NumMatches,
    NumMatchesAndCount,
    PatternMatch,
    Patterns,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.scan import determine_type
from deequ_tpu_torch.core.exceptions import (
    EmptyStateException,
    NoSuchColumnException,
    WrongColumnTypeException,
)
from deequ_tpu_torch.data.table import Table

from torch_fixtures import (
    get_df_full,
    get_df_missing,
    get_df_with_numeric_values,
    get_full_nulls,
)

pytestmark = pytest.mark.usefixtures("cpu_default")


def value_of(metric):
    assert metric.value.is_success, f"expected success, got {metric.value}"
    return metric.value.get()


def failure_of(metric):
    assert metric.value.is_failure, f"expected failure, got {metric.value}"
    return metric.value.exception


class TestSize:
    def test_size(self):
        assert value_of(Size().calculate(get_df_full())) == 4.0
        assert value_of(Size().calculate(get_df_missing())) == 12.0

    def test_size_with_filter(self):
        df = get_df_with_numeric_values()
        assert value_of(Size(where="att1 > 3").calculate(df)) == 3.0


class TestCompleteness:
    def test_completeness(self):
        df = get_df_missing()
        assert value_of(Completeness("att1").calculate(df)) == 0.5
        assert value_of(Completeness("att2").calculate(df)) == 0.75

    def test_completeness_with_filter(self):
        # rows where att2 is defined: 6 of them; att1 defined on 4 of those
        df = Table.from_pydict(
            {
                "att1": ["a", None, "b", "c", None, "d"],
                "att2": ["x", "x", "x", None, None, "x"],
            }
        )
        m = Completeness("att1", where="att2 IS NOT NULL").calculate(df)
        assert value_of(m) == 0.75

    def test_fully_null_is_zero(self):
        assert value_of(Completeness("att1").calculate(get_full_nulls())) == 0.0

    def test_missing_column_fails(self):
        err = failure_of(Completeness("nope").calculate(get_df_full()))
        assert isinstance(err, NoSuchColumnException)


class TestCompliance:
    def test_compliance(self):
        df = get_df_with_numeric_values()
        assert value_of(Compliance("rule1", "att1 > 3").calculate(df)) == 0.5
        assert value_of(Compliance("rule2", "att1 > 0").calculate(df)) == 1.0

    def test_compliance_with_filter(self):
        df = get_df_with_numeric_values()
        m = Compliance("rule", "att2 = 0", where="att1 < 4").calculate(df)
        assert value_of(m) == 1.0

    def test_bad_predicate_fails(self):
        df = get_df_with_numeric_values()
        m = Compliance("rule", "!!not valid sql!!").calculate(df)
        assert m.value.is_failure


class TestPatternMatch:
    def test_pattern(self):
        df = Table.from_pydict({"s": ["123", "abc", "12b", None]})
        m = PatternMatch("s", r"\d+").calculate(df)
        assert value_of(m) == 0.5

    def test_email(self):
        df = Table.from_pydict(
            {"s": ["someone@somewhere.org", "someone@else", "x", None]}
        )
        assert value_of(PatternMatch("s", Patterns.EMAIL).calculate(df)) == 0.25

    def test_url(self):
        df = Table.from_pydict(
            {
                "s": [
                    "http://foo.com/blah_blah",
                    "https://www.example.com/foo/?bar=baz",
                    "not a url",
                    None,
                ]
            }
        )
        assert value_of(PatternMatch("s", Patterns.URL).calculate(df)) == 0.5

    def test_ssn_and_creditcard(self):
        df = Table.from_pydict({"s": ["123-45-6789", "000-00-0000", "x"]})
        m = PatternMatch("s", Patterns.SOCIAL_SECURITY_NUMBER_US).calculate(df)
        assert value_of(m) == pytest.approx(1 / 3)
        df2 = Table.from_pydict({"s": ["4012888888881881", "9999999999999999"]})
        m2 = PatternMatch("s", Patterns.CREDITCARD).calculate(df2)
        assert value_of(m2) == 0.5

    def test_non_string_column_fails(self):
        df = get_df_with_numeric_values()
        err = failure_of(PatternMatch("att1", r"\d+").calculate(df))
        assert isinstance(err, WrongColumnTypeException)


class TestNumericAnalyzers:
    def test_mean_min_max_sum(self):
        df = get_df_with_numeric_values()
        assert value_of(Mean("att1").calculate(df)) == 3.5
        assert value_of(Minimum("att1").calculate(df)) == 1.0
        assert value_of(Maximum("att1").calculate(df)) == 6.0
        assert value_of(Sum("att1").calculate(df)) == 21.0

    def test_with_filter(self):
        df = get_df_with_numeric_values()
        assert value_of(Mean("att1", where="att2 = 0").calculate(df)) == 2.0
        assert value_of(Minimum("att1", where="att1 > 3").calculate(df)) == 4.0
        assert value_of(Maximum("att1", where="att1 < 4").calculate(df)) == 3.0
        assert value_of(Sum("att1", where="att2 > 0").calculate(df)) == 15.0

    def test_stddev(self):
        df = get_df_with_numeric_values()
        expected = float(np.std(np.arange(1, 7)))  # population stddev
        assert value_of(StandardDeviation("att1").calculate(df)) == pytest.approx(
            expected, abs=1e-12
        )

    def test_correlation_perfect(self):
        df = Table.from_pydict({"att1": [1.0, 2.0, 3.0], "att2": [4.0, 5.0, 6.0]})
        assert value_of(Correlation("att1", "att2").calculate(df)) == pytest.approx(
            1.0, abs=1e-12
        )

    def test_correlation_exact(self):
        df = get_df_with_numeric_values()
        expected = float(
            np.corrcoef(np.array([1, 2, 3, 4, 5, 6]), np.array([0, 0, 0, 5, 6, 7]))[0, 1]
        )
        assert value_of(Correlation("att1", "att2").calculate(df)) == pytest.approx(
            expected, abs=1e-12
        )

    def test_non_numeric_fails(self):
        df = get_df_full()
        err = failure_of(Mean("att1").calculate(df))
        assert isinstance(err, WrongColumnTypeException)

    def test_empty_state_on_all_null(self):
        df = Table.from_pydict({"x": [None, None]}, types=None)
        # all-None infers STRING; use numeric column with all nulls instead
        df = Table.from_numpy(
            {"x": np.array([np.nan, np.nan])},
        )
        for analyzer in [Mean("x"), Minimum("x"), Maximum("x"), Sum("x"), StandardDeviation("x")]:
            err = failure_of(analyzer.calculate(df))
            assert isinstance(err, EmptyStateException)

    def test_empty_state_message_contains_analyzer(self):
        df = Table.from_numpy({"numericCol": np.array([np.nan] * 8)})
        err = failure_of(Mean("numericCol").calculate(df))
        assert (
            str(err)
            == "Empty state for analyzer Mean(numericCol,None), all input values were NULL."
        )


class TestStates:
    def test_state_merges(self):
        df = get_df_with_numeric_values()
        left = df.slice(0, 3)
        right = df.slice(3, 6)
        for analyzer in [
            Size(),
            Completeness("att1"),
            Mean("att1"),
            Minimum("att1"),
            Maximum("att1"),
            Sum("att1"),
            StandardDeviation("att1"),
            Correlation("att1", "att2"),
        ]:
            sa = analyzer.compute_state_from(left)
            sb = analyzer.compute_state_from(right)
            merged_metric = analyzer.compute_metric_from(sa.merge(sb))
            direct_metric = analyzer.calculate(df)
            assert value_of(merged_metric) == pytest.approx(
                value_of(direct_metric), abs=1e-9
            ), repr(analyzer)

    def test_null_column_states(self):
        df = Table.from_numpy({"x": np.array([np.nan] * 8)})
        assert Size().compute_state_from(df) == NumMatches(8)
        assert Completeness("x").compute_state_from(df) == NumMatchesAndCount(0, 8)
        assert Mean("x").compute_state_from(df) is None
        assert StandardDeviation("x").compute_state_from(df) is None
        assert Minimum("x").compute_state_from(df) is None
        assert Maximum("x").compute_state_from(df) is None
        assert Sum("x").compute_state_from(df) is None
        assert Correlation("x", "x").compute_state_from(df) is None


class TestDataType:
    def test_datatype_histogram(self):
        df = Table.from_pydict({"s": ["1", "2.0", "true", "xyz", None]})
        dist = value_of(DataType("s").calculate(df))
        assert dist[DataTypeInstances.INTEGRAL].absolute == 1
        assert dist[DataTypeInstances.FRACTIONAL].absolute == 1
        assert dist[DataTypeInstances.BOOLEAN].absolute == 1
        assert dist[DataTypeInstances.STRING].absolute == 1
        assert dist[DataTypeInstances.UNKNOWN].absolute == 1
        assert dist[DataTypeInstances.INTEGRAL].ratio == pytest.approx(0.2)

    def test_fully_null(self):
        df = get_full_nulls()
        dist = value_of(DataType("att1").calculate(df))
        assert dist[DataTypeInstances.UNKNOWN].ratio == 1.0

    def test_determine_type(self):
        df = Table.from_pydict({"s": ["1", "2", None]})
        dist = value_of(DataType("s").calculate(df))
        assert determine_type(dist) == DataTypeInstances.INTEGRAL
        df2 = Table.from_pydict({"s": ["1", "2.0"]})
        assert determine_type(value_of(DataType("s").calculate(df2))) == DataTypeInstances.FRACTIONAL
        df3 = Table.from_pydict({"s": ["true", "false"]})
        assert determine_type(value_of(DataType("s").calculate(df3))) == DataTypeInstances.BOOLEAN
        df4 = Table.from_pydict({"s": ["true", "1"]})
        assert determine_type(value_of(DataType("s").calculate(df4))) == DataTypeInstances.STRING

    def test_typed_columns(self):
        df = get_df_with_numeric_values()
        dist = value_of(DataType("att1").calculate(df))
        assert dist[DataTypeInstances.INTEGRAL].ratio == 1.0


class TestBatching:
    def test_multi_batch_equals_single_batch(self):
        from deequ_tpu_torch.ops.fused import FusedScanPass

        rng = np.random.default_rng(0)
        x = rng.normal(size=1000) * 10
        y = rng.normal(size=1000) + 0.3 * x
        x[::7] = np.nan
        df = Table.from_numpy({"x": x, "y": y})
        analyzers = [
            Size(),
            Completeness("x"),
            Mean("x"),
            Minimum("x"),
            Maximum("x"),
            Sum("x"),
            StandardDeviation("x"),
            Correlation("x", "y"),
        ]
        single = FusedScanPass(analyzers, batch_size=1 << 22).run(df)
        multi = FusedScanPass(analyzers, batch_size=64).run(df)
        for s, m in zip(single, multi):
            ms = s.analyzer.compute_metric_from(s.state_or_raise())
            mm = m.analyzer.compute_metric_from(m.state_or_raise())
            if ms.value.is_success:
                assert value_of(mm) == pytest.approx(value_of(ms), rel=1e-12), repr(
                    s.analyzer
                )
