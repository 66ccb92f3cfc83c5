"""Anomaly detection in the port against the JAX package.

Port-mapped copies of tests/test_anomaly_detection.py,
tests/test_anomaly_strategies_full.py and
tests/test_check_dsl_full.py::TestAnomalyHistoryFiltering: the same
cases against deequ_tpu_torch, with every run and every Holt-Winters fit
on device="cpu". Then the parity tests: the Holt-Winters recursion and
its gradient against the JAX package's `jax.lax.scan` and
`jax.value_and_grad`, `detect` on seeded weekly and yearly series, and
an anomaly check over metrics repositories filled by both packages.
"""

from __future__ import annotations

import numpy as np
import pytest

from deequ_tpu_torch import Check, CheckLevel, CheckStatus, Table
from deequ_tpu_torch.anomaly import (
    AnomalyDetector,
    BatchNormalStrategy,
    DataPoint,
    HoltWinters,
    MetricInterval,
    OnlineNormalStrategy,
    RateOfChangeStrategy,
    SeriesSeasonality,
    SimpleThresholdStrategy,
)
from deequ_tpu_torch.anomaly.base import Anomaly
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner


def run_checks(table: Table, *checks: Check):
    analyzers = []
    for check in checks:
        analyzers.extend(check.required_analyzers())
    return AnalysisRunner.do_analysis_run(table, analyzers, "cpu")


# -- tests/test_anomaly_detection.py ------------------------------------------


class TestSimpleThreshold:
    def test_bounds(self):
        data = [-1.0, 2.0, 3.0, 0.5]
        strategy = SimpleThresholdStrategy(upper_bound=1.0, lower_bound=0.0)
        anomalies = strategy.detect(data, (0, 4))
        assert [i for i, _ in anomalies] == [0, 1, 2]

    def test_interval(self):
        data = [-1.0, 2.0, 3.0, 0.5]
        strategy = SimpleThresholdStrategy(upper_bound=1.0, lower_bound=0.0)
        anomalies = strategy.detect(data, (2, 4))
        assert [i for i, _ in anomalies] == [2]

    def test_invalid_bounds(self):
        with pytest.raises(ValueError):
            SimpleThresholdStrategy(upper_bound=0.0, lower_bound=1.0)


class TestRateOfChange:
    def test_first_order(self):
        data = [1.0, 2.0, 3.0, 10.0, 11.0]
        strategy = RateOfChangeStrategy(max_rate_decrease=-2.0, max_rate_increase=2.0)
        anomalies = strategy.detect(data, (0, 5))
        assert [i for i, _ in anomalies] == [3]

    def test_requires_a_bound(self):
        with pytest.raises(ValueError):
            RateOfChangeStrategy()

    def test_second_order(self):
        data = [1.0, 2.0, 4.0, 8.0, 16.0]
        strategy = RateOfChangeStrategy(max_rate_increase=3.0, order=2)
        anomalies = strategy.detect(data, (0, 5))
        # second differences: 1, 2, 4 -> index 4 (diff 4 > 3)
        assert [i for i, _ in anomalies] == [4]


class TestOnlineNormal:
    def test_detects_outlier(self):
        rng = np.random.default_rng(42)
        data = list(rng.normal(10.0, 1.0, 50))
        data[40] = 100.0
        strategy = OnlineNormalStrategy(ignore_start_percentage=0.2)
        anomalies = strategy.detect(data, (30, 50))
        assert 40 in [i for i, _ in anomalies]

    def test_anomalies_excluded_from_stats(self):
        rng = np.random.default_rng(0)
        data = list(rng.normal(0.0, 1.0, 100))
        data[50] = 500.0
        data[51] = 500.0
        strategy = OnlineNormalStrategy()
        anomalies = strategy.detect(data, (40, 100))
        indices = [i for i, _ in anomalies]
        assert 50 in indices and 51 in indices


class TestBatchNormal:
    def test_excludes_interval_from_stats(self):
        rng = np.random.default_rng(1)
        data = list(rng.normal(5.0, 1.0, 60))
        data[55] = 50.0
        strategy = BatchNormalStrategy()
        anomalies = strategy.detect(data, (50, 60))
        assert [i for i, _ in anomalies] == [55]

    def test_needs_data_outside_interval(self):
        strategy = BatchNormalStrategy()
        with pytest.raises(ValueError):
            strategy.detect([1.0, 2.0], (0, 2))


class TestAnomalyDetector:
    def history(self):
        return [DataPoint(t, float(t % 3 == 0)) for t in range(10)]

    def test_sorts_and_filters(self):
        detector = AnomalyDetector(SimpleThresholdStrategy(upper_bound=5.0))
        points = [
            DataPoint(3, 2.0),
            DataPoint(1, 10.0),
            DataPoint(2, None),  # missing -> dropped
        ]
        result = detector.detect_anomalies_in_history(points)
        assert [(t, a.value) for t, a in result.anomalies] == [(1, 10.0)]

    def test_new_point(self):
        detector = AnomalyDetector(SimpleThresholdStrategy(upper_bound=5.0))
        history = [DataPoint(t, 1.0) for t in range(5)]
        ok = detector.is_new_point_anomalous(history, DataPoint(10, 4.0))
        assert ok.anomalies == []
        bad = detector.is_new_point_anomalous(history, DataPoint(11, 6.0))
        assert len(bad.anomalies) == 1

    def test_new_point_must_be_after_history(self):
        detector = AnomalyDetector(SimpleThresholdStrategy(upper_bound=5.0))
        history = [DataPoint(t, 1.0) for t in range(5)]
        with pytest.raises(ValueError, match="history range"):
            detector.is_new_point_anomalous(history, DataPoint(3, 1.0))

    def test_empty_history_rejected(self):
        detector = AnomalyDetector(SimpleThresholdStrategy(upper_bound=5.0))
        with pytest.raises(ValueError):
            detector.is_new_point_anomalous([], DataPoint(1, 1.0))


class TestHoltWinters:
    def seasonal_series(self, cycles: int, noise: float = 0.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        pattern = np.array([10.0, 12, 14, 16, 14, 12, 10])
        series = np.tile(pattern, cycles) + np.arange(7 * cycles) * 0.1
        return series + rng.normal(0, noise, len(series))

    def test_no_anomaly_on_clean_continuation(self):
        series = self.seasonal_series(5)
        strategy = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cpu")
        anomalies = strategy.detect(list(series), (28, 35))
        assert anomalies == []

    def test_detects_break(self):
        series = self.seasonal_series(5).copy()
        series[30] += 50.0
        strategy = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cpu")
        anomalies = strategy.detect(list(series), (28, 35))
        assert 30 in [i for i, _ in anomalies]

    def test_needs_two_cycles(self):
        strategy = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cpu")
        with pytest.raises(ValueError, match="two full cycles"):
            strategy.detect([1.0] * 20, (10, 20))

    def test_monthly_yearly(self):
        # with only 2 training cycles the 1.96·sd(|residual|) threshold is
        # tight (same formula as the reference) — assert the real break is
        # found and dominates, rather than zero false positives
        rng = np.random.default_rng(7)
        pattern = np.array([5.0, 6, 8, 12, 15, 18, 20, 19, 15, 11, 7, 5])
        series = np.tile(pattern, 3) + rng.normal(0, 0.3, 36)
        series[30] += 40.0
        strategy = HoltWinters(MetricInterval.MONTHLY, SeriesSeasonality.YEARLY, device="cpu")
        anomalies = strategy.detect(list(series), (24, 36))
        indices = [i for i, _ in anomalies]
        assert 30 in indices


class TestAnomalyCheckIntegration:
    def test_verification_with_anomaly_check(self):
        from deequ_tpu_torch import Table, CheckStatus, VerificationSuite
        from deequ_tpu_torch.analyzers import Size
        from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey
        from deequ_tpu_torch.verification.run_builder import AnomalyCheckConfig
        from deequ_tpu_torch.checks.check import CheckLevel

        repo = InMemoryMetricsRepository()
        # build history of sizes ~ 1000
        for day in range(1, 6):
            t = Table.from_pydict({"x": list(range(1000 + day))})
            (
                VerificationSuite.on_data(t, device="cpu")
                .use_repository(repo)
                .add_required_analyzer(Size())
                .save_or_append_result(ResultKey(day, {}))
                .run()
            )

        # normal new value passes
        t_ok = Table.from_pydict({"x": list(range(1010))})
        result = (
            VerificationSuite.on_data(t_ok, device="cpu")
            .use_repository(repo)
            .add_anomaly_check(
                RateOfChangeStrategy(max_rate_decrease=-100.0, max_rate_increase=100.0),
                Size(),
                AnomalyCheckConfig(CheckLevel.ERROR, "size anomaly"),
            )
            .save_or_append_result(ResultKey(6, {}))
            .run()
        )
        assert result.status == CheckStatus.SUCCESS

        # anomalous new value fails
        t_bad = Table.from_pydict({"x": list(range(5000))})
        result = (
            VerificationSuite.on_data(t_bad, device="cpu")
            .use_repository(repo)
            .add_anomaly_check(
                RateOfChangeStrategy(max_rate_decrease=-100.0, max_rate_increase=100.0),
                Size(),
                AnomalyCheckConfig(CheckLevel.ERROR, "size anomaly"),
            )
            .run()
        )
        assert result.status == CheckStatus.ERROR


def test_anomaly_check_does_not_see_current_runs_own_metric():
    """Results are saved AFTER check evaluation: the anomaly assertion's
    history query must not include this run's own metric (reference:
    VerificationSuite.scala:121-139 passes saveOrAppendResultsWithKey=None
    into the runner and saves post-evaluate). With the wrong order, the
    2->5 size jump in AnomalyDetectionExample is invisible (diff 0)."""
    import numpy as np

    from deequ_tpu_torch import CheckStatus, Table, VerificationSuite
    from deequ_tpu_torch.analyzers import Size
    from deequ_tpu_torch.anomaly.strategies import RateOfChangeStrategy
    from deequ_tpu_torch.repository.base import ResultKey
    from deequ_tpu_torch.repository.memory import InMemoryMetricsRepository

    repo = InMemoryMetricsRepository()
    yesterday = Table.from_numpy({"x": np.arange(2.0)})
    today = Table.from_numpy({"x": np.arange(5.0)})

    r1 = (
        VerificationSuite()
        .on_data(yesterday, device="cpu")
        .use_repository(repo)
        .save_or_append_result(ResultKey(1000))
        .add_anomaly_check(RateOfChangeStrategy(max_rate_increase=2.0), Size())
        .run()
    )
    # first run: empty history -> the anomaly constraint fails like the
    # reference's require(dataSeries.nonEmpty); only the SAVE matters here
    assert repo.load_by_key(ResultKey(1000)).metric(Size()).value.get() == 2.0

    r2 = (
        VerificationSuite()
        .on_data(today, device="cpu")
        .use_repository(repo)
        .save_or_append_result(ResultKey(2000))
        .add_anomaly_check(RateOfChangeStrategy(max_rate_increase=2.0), Size())
        .run()
    )
    assert r2.status == CheckStatus.WARNING  # 2 -> 5 is anomalous
    # ... but the metric WAS saved after evaluation
    assert repo.load_by_key(ResultKey(2000)).metric(Size()).value.get() == 5.0


# -- tests/test_anomaly_strategies_full.py -------------------------------------


class TestSimpleThresholdBoundaries:
    def test_bounds_are_inclusive(self):
        s = SimpleThresholdStrategy(lower_bound=-1.0, upper_bound=1.0)
        series = [-1.0, 1.0, -1.0001, 1.0001]
        found = s.detect(series, (0, len(series)))
        assert [i for i, _ in found] == [2, 3]

    def test_search_interval_clamps_to_series(self):
        s = SimpleThresholdStrategy(upper_bound=0.0)
        assert s.detect([1.0, 1.0], (0, 100)) == [
            (0, s.detect([1.0], (0, 1))[0][1]),
            (1, s.detect([1.0], (0, 1))[0][1]),
        ] or len(s.detect([1.0, 1.0], (0, 100))) == 2

    def test_inverted_interval_rejected(self):
        with pytest.raises(ValueError):
            SimpleThresholdStrategy(upper_bound=1.0).detect([1.0], (2, 1))

    def test_inverted_bounds_rejected(self):
        with pytest.raises(ValueError):
            SimpleThresholdStrategy(lower_bound=2.0, upper_bound=1.0)

    def test_detail_message(self):
        s = SimpleThresholdStrategy(lower_bound=0.0, upper_bound=1.0)
        ((_, anomaly),) = s.detect([2.0], (0, 1))
        assert "[SimpleThresholdStrategy]" in anomaly.detail
        assert "2.0" in anomaly.detail

    def test_anomaly_equality_ignores_detail(self):
        """reference: DetectionResult.scala:19-56."""
        assert Anomaly(1.0, 1.0, "left") == Anomaly(1.0, 1.0, "right")
        assert Anomaly(1.0, 1.0, "d") != Anomaly(2.0, 1.0, "d")


class TestRateOfChangeBoundaries:
    def test_only_increase_bound(self):
        s = RateOfChangeStrategy(max_rate_increase=1.0)
        series = [0.0, 0.5, 2.5, 2.0]
        found = s.detect(series, (0, len(series)))
        assert [i for i, _ in found] == [2]

    def test_only_decrease_bound(self):
        s = RateOfChangeStrategy(max_rate_decrease=-1.0)
        series = [2.0, 1.5, 0.0, 0.5]
        found = s.detect(series, (0, len(series)))
        assert [i for i, _ in found] == [2]

    def test_needs_at_least_one_bound(self):
        with pytest.raises(ValueError):
            RateOfChangeStrategy()

    def test_inconsistent_bounds_rejected(self):
        with pytest.raises(ValueError):
            RateOfChangeStrategy(max_rate_decrease=1.0, max_rate_increase=-1.0)

    def test_negative_order_rejected(self):
        with pytest.raises(ValueError):
            RateOfChangeStrategy(max_rate_increase=1.0, order=-1)

    def test_second_order_differences(self):
        # linear growth has zero 2nd difference; the jump breaks it
        s = RateOfChangeStrategy(
            max_rate_decrease=-0.1, max_rate_increase=0.1, order=2
        )
        series = [1.0, 2.0, 3.0, 4.0, 50.0]
        found = s.detect(series, (0, len(series)))
        assert 4 in [i for i, _ in found]

    def test_interval_start_looks_back_for_differences(self):
        # detecting inside (3, 4) still needs series[2] for the diff
        s = RateOfChangeStrategy(max_rate_increase=1.0)
        series = [0.0, 0.0, 0.0, 10.0]
        found = s.detect(series, (3, 4))
        assert [i for i, _ in found] == [3]

    def test_anomaly_carries_value_not_change(self):
        s = RateOfChangeStrategy(max_rate_increase=1.0)
        ((_, anomaly),) = s.detect([0.0, 5.0], (0, 2))
        assert anomaly.value == 5.0
        assert "Change of" in anomaly.detail


class TestOnlineNormalBoundaries:
    def _series(self):
        rng = np.random.default_rng(7)
        series = list(rng.normal(10.0, 1.0, 60))
        series[40] = 30.0
        return series

    def test_detects_spike(self):
        s = OnlineNormalStrategy()
        found = s.detect(self._series(), (0, 60))
        assert 40 in [i for i, _ in found]

    def test_upper_only_ignores_dips(self):
        series = self._series()
        series[50] = -20.0
        s = OnlineNormalStrategy(lower_deviation_factor=None)
        found = [i for i, _ in s.detect(series, (0, 60))]
        assert 40 in found and 50 not in found

    def test_lower_only_ignores_spikes(self):
        series = self._series()
        series[50] = -20.0
        s = OnlineNormalStrategy(upper_deviation_factor=None)
        found = [i for i, _ in s.detect(series, (0, 60))]
        assert 50 in found and 40 not in found

    def test_warmup_fraction_skipped(self):
        s = OnlineNormalStrategy(ignore_start_percentage=0.5)
        series = self._series()
        found = [i for i, _ in s.detect(series, (0, 60)) if i < 30]
        assert found == []

    def test_search_interval_limits_reported_indexes(self):
        s = OnlineNormalStrategy()
        found = [i for i, _ in s.detect(self._series(), (45, 60))]
        assert 40 not in found

    def test_one_sided_constant_series_not_flagged(self):
        # zero variance + a one-sided factor: the missing side's bound
        # is mean ± MaxValue·0 = mean, so an unchanged value stays in
        # bounds (regression: math.inf · 0 = nan flagged every point)
        series = [5.0] * 20
        for s in (
            OnlineNormalStrategy(lower_deviation_factor=None),
            OnlineNormalStrategy(upper_deviation_factor=None),
            OnlineNormalStrategy(),
        ):
            assert s.detect(series, (0, 20)) == []


class TestBatchNormalBoundaries:
    def test_interval_excluded_from_stats(self):
        rng = np.random.default_rng(3)
        series = list(rng.normal(0.0, 1.0, 50)) + [100.0, 101.0]
        s = BatchNormalStrategy()
        found = [i for i, _ in s.detect(series, (50, 52))]
        assert found == [50, 51]

    def test_include_interval_pollutes_stats(self):
        series = [1.0] * 10 + [1000.0] * 40
        s = BatchNormalStrategy(include_interval=True)
        # the outliers dominate mean/stddev when included
        found = s.detect(series, (10, 50))
        assert len(found) < 40

    def test_empty_series_rejected(self):
        with pytest.raises(ValueError):
            BatchNormalStrategy().detect([], (0, 0))

    def test_interval_covering_everything_rejected(self):
        with pytest.raises(ValueError):
            BatchNormalStrategy().detect([1.0, 2.0], (0, 2))

    def test_needs_one_factor(self):
        with pytest.raises(ValueError):
            BatchNormalStrategy(
                lower_deviation_factor=None, upper_deviation_factor=None
            )

    def test_negative_factors_rejected(self):
        with pytest.raises(ValueError):
            BatchNormalStrategy(upper_deviation_factor=-1.0)


class TestAnomalyDetectorPreprocessing:
    """reference: AnomalyDetector.scala:29-102."""

    def test_sorts_by_time_before_detection(self):
        detector = AnomalyDetector(SimpleThresholdStrategy(upper_bound=5.0))
        points = [
            DataPoint(3, 10.0),
            DataPoint(1, 1.0),
            DataPoint(2, 2.0),
        ]
        result = detector.detect_anomalies_in_history(points, (0, 4))
        assert [t for t, _ in result.anomalies] == [3]

    def test_drops_missing_values(self):
        detector = AnomalyDetector(SimpleThresholdStrategy(upper_bound=5.0))
        points = [DataPoint(1, 1.0), DataPoint(2, None), DataPoint(3, 10.0)]
        result = detector.detect_anomalies_in_history(points, (0, 4))
        assert [t for t, _ in result.anomalies] == [3]

    def test_interval_is_time_based(self):
        detector = AnomalyDetector(SimpleThresholdStrategy(upper_bound=5.0))
        points = [DataPoint(t, 10.0) for t in (1, 2, 3)]
        result = detector.detect_anomalies_in_history(points, (2, 3))
        assert [t for t, _ in result.anomalies] == [2]

    def test_is_new_point_anomalous_appends_and_searches_tail(self):
        detector = AnomalyDetector(BatchNormalStrategy())
        history = [DataPoint(t, float(np.sin(t))) for t in range(20)]
        verdict = detector.is_new_point_anomalous(history, DataPoint(20, 50.0))
        assert verdict.anomalies
        ok = detector.is_new_point_anomalous(history, DataPoint(20, 0.5))
        assert not ok.anomalies


class TestDegenerateSeriesRobustness:
    """No strategy may crash (beyond documented ValueErrors) or hang on
    degenerate input: empty, single-point, constant, inf-scaled."""

    SERIES = [
        [],
        [1.0],
        [1.0, 1.0],
        [float("inf")],
        [0.0] * 5,
    ]
    INTERVALS = [(0, 0), (0, 100), (1, 2)]

    @pytest.mark.parametrize(
        "make",
        [
            lambda: SimpleThresholdStrategy(lower_bound=-1.0, upper_bound=1.0),
            lambda: RateOfChangeStrategy(max_rate_increase=1.0, order=1),
            lambda: RateOfChangeStrategy(max_rate_increase=1.0, order=3),
            lambda: OnlineNormalStrategy(),
            lambda: BatchNormalStrategy(),
        ],
        ids=["threshold", "rate1", "rate3", "online", "batch"],
    )
    def test_no_unexpected_exception(self, make):
        for series in self.SERIES:
            for interval in self.INTERVALS:
                try:
                    out = make().detect(list(series), interval)
                except ValueError:
                    continue  # documented parameter/empty errors
                assert isinstance(out, list)


class TestHoltWintersBoundaries:
    """reference: seasonal/HoltWintersTest.scala (224 LoC)."""

    def _weekly_series(self, weeks: int, breakpoint: int = -1):
        # exactly linear trend + additive weekly pattern: ETS(A,A) fits
        # this perfectly, so residual-based thresholds are deterministic
        base = np.array([10, 11, 12, 13, 14, 20, 22], dtype=float)
        series = np.tile(base, weeks) + np.arange(7 * weeks) * 0.1
        if breakpoint >= 0:
            series[breakpoint] += 25
        return list(series)

    def test_clean_continuation_no_anomaly(self):
        s = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cpu")
        series = self._weekly_series(5)
        found = s.detect(series, (28, 35))
        assert found == []

    def test_seasonal_break_detected(self):
        s = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cpu")
        series = self._weekly_series(5, breakpoint=31)
        found = [i for i, _ in s.detect(series, (28, 35))]
        assert 31 in found

    def test_two_full_cycles_required(self):
        s = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cpu")
        with pytest.raises(ValueError):
            s.detect(self._weekly_series(1), (0, 7))

    def test_interval_before_any_training_data_rejected(self):
        s = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cpu")
        # searching from index 0 leaves no training prefix
        with pytest.raises(ValueError):
            s.detect(self._weekly_series(3), (0, 21))


# -- tests/test_check_dsl_full.py::TestAnomalyHistoryFiltering ------------------


class TestAnomalyHistoryFiltering:
    """reference: CheckTest.scala:647-714 — only history inside the
    configured window / tags feeds the detector."""

    def _repo_with_history(self):
        from deequ_tpu_torch.analyzers import Size
        from deequ_tpu_torch.core.maybe import Success
        from deequ_tpu_torch.core.metrics import DoubleMetric, Entity
        from deequ_tpu_torch.repository.base import ResultKey
        from deequ_tpu_torch.repository.memory import InMemoryMetricsRepository
        from deequ_tpu_torch.runners.context import AnalyzerContext

        repo = InMemoryMetricsRepository()
        for ts, value, tags in [
            (1000, 11.0, {"env": "prod"}),
            (2000, 12.0, {"env": "prod"}),
            (3000, 50.0, {"env": "test"}),  # outlier under a different tag
        ]:
            repo.save(
                ResultKey(ts, tags),
                AnalyzerContext(
                    {
                        Size(): DoubleMetric(
                            Entity.DATASET, "Size", "*", Success(value)
                        )
                    }
                ),
            )
        return repo

    def test_tag_filter_excludes_other_environments(self):
        from deequ_tpu_torch.analyzers import Size
        from deequ_tpu_torch.anomaly.strategies import SimpleThresholdStrategy

        repo = self._repo_with_history()
        table = Table.from_numpy({"x": np.arange(13.0)})  # size 13
        # with the prod tag filter, history is [11, 12] and 13 is fine;
        # without it, the test outlier (50) would not change simple
        # threshold semantics, so use a rate bound instead
        check = Check(CheckLevel.WARNING, "anomaly").is_newest_point_non_anomalous(
            repo,
            SimpleThresholdStrategy(lower_bound=0.0, upper_bound=20.0),
            Size(),
            {"env": "prod"},
            None,
            None,
        )
        context = run_checks(table, check)
        assert check.evaluate(context).status == CheckStatus.SUCCESS

    def test_before_after_window(self):
        from deequ_tpu_torch.analyzers import Size
        from deequ_tpu_torch.anomaly.strategies import RateOfChangeStrategy

        repo = self._repo_with_history()
        table = Table.from_numpy({"x": np.arange(13.0)})  # size 13
        # window [0, 2500]: history [11, 12] -> 13 is a +1 step: fine
        ok = Check(CheckLevel.WARNING, "anomaly").is_newest_point_non_anomalous(
            repo,
            RateOfChangeStrategy(max_rate_increase=2.0),
            Size(),
            None,
            0,
            2500,
        )
        context = run_checks(table, ok)
        assert ok.evaluate(context).status == CheckStatus.SUCCESS
        # full window: the tagged outlier 50 enters history -> 50 -> 13
        # is a huge negative step; with a decrease bound it is anomalous
        bad = Check(CheckLevel.WARNING, "anomaly").is_newest_point_non_anomalous(
            repo,
            RateOfChangeStrategy(max_rate_decrease=-5.0, max_rate_increase=40.0),
            Size(),
            None,
            None,
            None,
        )
        context = run_checks(table, bad)
        assert bad.evaluate(context).status == CheckStatus.WARNING


# -- parity with the JAX package --------------------------------------------------

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from deequ_tpu.anomaly import holt_winters as jax_hw  # noqa: E402
from deequ_tpu_torch.anomaly import holt_winters as port_hw  # noqa: E402


def _weekly(seed: int, weeks: int = 8, breaks=()):
    rng = np.random.default_rng(seed)
    pattern = np.array([10.0, 12, 14, 16, 14, 12, 10])
    series = np.tile(pattern, weeks) + np.arange(7 * weeks) * 0.1 + rng.normal(0, 0.4, 7 * weeks)
    for i in breaks:
        series[i] += 15.0
    return series


def _yearly(seed: int, years: int = 4, breaks=()):
    rng = np.random.default_rng(seed)
    pattern = np.array([5.0, 6, 8, 12, 15, 18, 20, 19, 15, 11, 7, 5])
    series = np.tile(pattern, years) + rng.normal(0, 0.3, 12 * years)
    for i in breaks:
        series[i] += 12.0
    return series


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-300)))


@pytest.mark.parametrize("periodicity,seed", [(7, 0), (7, 1), (12, 2)])
@pytest.mark.parametrize("params", [(0.3, 0.1, 0.1), (0.9, 0.0, 1.0), (0.05, 0.7, 0.4)])
def test_holt_winters_fit_equals_jax_at_fixed_params(periodicity, seed, params):
    series = _weekly(seed) if periodicity == 7 else _yearly(seed)
    p = np.asarray(params)
    jax_f, jax_r = jax_hw._holt_winters_fit(jnp.asarray(series), periodicity, 9, jnp.asarray(p))
    f, r = port_hw._holt_winters_fit(torch.tensor(series), periodicity, 9, torch.tensor(p))
    assert _rel(f.numpy(), np.asarray(jax_f)) <= 1e-12
    # residuals of an exact fit are near zero: hold them to the series' scale
    assert np.max(np.abs(r.numpy() - np.asarray(jax_r))) <= 1e-12 * np.max(np.abs(series))

    def jax_rss(q):
        return jnp.sum(jax_hw._holt_winters_fit(jnp.asarray(series), periodicity, 9, q)[1] ** 2)

    jax_value, jax_grad = jax.value_and_grad(jax_rss)(jnp.asarray(p))
    q = torch.tensor(p, requires_grad=True)
    rss = torch.sum(port_hw._holt_winters_fit(torch.tensor(series), periodicity, 9, q)[1] ** 2)
    (grad,) = torch.autograd.grad(rss, q)
    assert _rel(float(rss.detach()), float(jax_value)) <= 1e-10
    assert _rel(grad.numpy(), np.asarray(jax_grad)) <= 1e-10


@pytest.mark.parametrize(
    "kind,seed,breaks,interval",
    [
        ("weekly", 3, (), (42, 56)),
        ("weekly", 4, (45, 50), (42, 56)),
        ("weekly", 5, (30,), (28, 35)),
        ("yearly", 6, (40,), (36, 48)),
        ("yearly", 7, (), (24, 36)),
    ],
)
def test_detect_equals_jax(kind, seed, breaks, interval):
    """Anomaly indices and values exact; the fitted (alpha, beta, gamma)
    within 1e-6 (L-BFGS-B may walk another path when the objective's last
    bits differ)."""
    if kind == "weekly":
        series = _weekly(seed, breaks=breaks)
        args = (jax_hw.MetricInterval.DAILY, jax_hw.SeriesSeasonality.WEEKLY)
        port_args = (MetricInterval.DAILY, SeriesSeasonality.WEEKLY)
    else:
        series = _yearly(seed, breaks=breaks)
        args = (jax_hw.MetricInterval.MONTHLY, jax_hw.SeriesSeasonality.YEARLY)
        port_args = (MetricInterval.MONTHLY, SeriesSeasonality.YEARLY)
    reference = jax_hw.HoltWinters(*args)
    want = reference.detect(list(series), interval)
    strategy = HoltWinters(*port_args, device="cpu")
    got = strategy.detect(list(series), interval)
    assert [(i, a.value) for i, a in got] == [(i, a.value) for i, a in want]
    for i in breaks:
        assert i in [j for j, _ in got]
    start, end = interval
    want_params = reference._fit_params(np.asarray(series[:start]), min(end, len(series)) - start)
    np.testing.assert_allclose(strategy.params, want_params, rtol=0, atol=1e-6)
    assert strategy.evaluations > 0


def test_holt_winters_runs_where_it_is_told():
    strategy = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cpu")
    assert strategy.device == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY)


def _history_tables(days: int, seed: int):
    """One small table a day: x around 10 with a weekly swing, the last
    day shifted up by 4.0, well outside three standard deviations of the
    swing."""
    rng = np.random.default_rng(seed)
    out = []
    for day in range(days):
        x = 10.0 + np.sin(2 * np.pi * day / 7) + rng.normal(0, 0.05, 200 + day % 3)
        if day == days - 1:
            x = x + 4.0
        out.append({"x": x})
    return out


def _strategies(package):
    if package == "jax":
        from deequ_tpu.anomaly import (
            HoltWinters as H, MetricInterval as MI, OnlineNormalStrategy as O,
            RateOfChangeStrategy as R, SeriesSeasonality as SS,
        )

        return [O(), H(MI.DAILY, SS.WEEKLY), R(max_rate_decrease=-10.0, max_rate_increase=10.0)]
    return [
        OnlineNormalStrategy(),
        HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY, device="cpu"),
        RateOfChangeStrategy(max_rate_decrease=-10.0, max_rate_increase=10.0),
    ]


def _anomaly_run(package, table_data, repository, key, with_checks):
    """One day's run of either package: Mean("x") and Size(), saved under
    `key` unless it is None; with the three anomaly checks when
    `with_checks`."""
    if package == "jax":
        from deequ_tpu import Table as T, VerificationSuite as V
        from deequ_tpu.analyzers import Mean as M, Size as S
        from deequ_tpu.repository import ResultKey as K

        builder = V.on_data(T.from_numpy(table_data)).with_engine("single")
    else:
        from deequ_tpu_torch import VerificationSuite as V
        from deequ_tpu_torch.analyzers import Mean as M, Size as S
        from deequ_tpu_torch.repository import ResultKey as K

        builder = V.on_data(Table.from_numpy(table_data), device="cpu")
    builder = builder.use_repository(repository)
    if key is not None:
        builder = builder.save_or_append_result(K(key, {"ds": "daily"}))
    builder = builder.add_required_analyzer(M("x")).add_required_analyzer(S())
    if with_checks:
        online, holt, rate = _strategies(package)
        builder = (builder.add_anomaly_check(online, M("x"))
                   .add_anomaly_check(holt, M("x"))
                   .add_anomaly_check(rate, S()))
    result = builder.run()
    return [(r.check.description, r.status.value) for r in result.check_results.values()]


@pytest.mark.parametrize("repository_kind", ["memory", "filesystem"])
def test_anomaly_check_over_a_repository_filled_by_both_packages(tmp_path, monkeypatch, repository_kind):
    """The history of 21 days, then a day shifted by +4.0 with three
    anomaly checks. In memory, each package fills its own repository with
    the same days; on the file system, the days alternate between the
    packages in one file that both read. The last day's verdicts are
    equal, and the shifted day is flagged by both strategies on
    Mean("x")."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    from deequ_tpu.repository import (
        FileSystemMetricsRepository as JaxFS, InMemoryMetricsRepository as JaxMemory,
    )
    from deequ_tpu_torch.repository import FileSystemMetricsRepository, InMemoryMetricsRepository

    days = _history_tables(22, seed=11)
    if repository_kind == "memory":
        repos = {"jax": JaxMemory(), "port": InMemoryMetricsRepository()}
    else:
        path = str(tmp_path / "metrics.json")
        repos = {"jax": JaxFS(path), "port": FileSystemMetricsRepository(path)}
    for day, data in enumerate(days[:-1]):
        if repository_kind == "memory":
            for package in ("jax", "port"):
                _anomaly_run(package, data, repos[package], day + 1, with_checks=False)
        else:
            writer = "jax" if day % 2 else "port"
            _anomaly_run(writer, data, repos[writer], day + 1, with_checks=False)
    # the day under test saves nothing: the other package must not see it
    got = {p: _anomaly_run(p, days[-1], repos[p], None, with_checks=True)
           for p in ("jax", "port")}
    assert got["jax"] == got["port"]
    statuses = [status for _, status in got["port"]]
    assert statuses[:2] == ["Warning", "Warning"] and statuses[2] == "Success", got
