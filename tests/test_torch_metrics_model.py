"""Metrics model + AnalyzerContext unit tests — the mirror of the
reference's MetricsTests.scala and AnalyzerContextTest.scala (132 LoC):
flatten() contracts for every composite metric, Distribution argmax,
context merge semantics and exporters.

Port-mapped from tests/test_metrics_model.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

import pytest
from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

from deequ_tpu_torch.analyzers import Completeness, Size
from deequ_tpu_torch.core.maybe import Failure, Success
from deequ_tpu_torch.core.metrics import (
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    HistogramMetric,
    KeyedDoubleMetric,
)
from deequ_tpu_torch.runners.context import AnalyzerContext

pytestmark = pytest.mark.usefixtures("cpu_default")


class TestDoubleMetric:
    def test_flatten_is_identity(self):
        m = DoubleMetric(Entity.COLUMN, "Completeness", "att1", Success(0.5))
        assert list(m.flatten()) == [m]

    def test_failure_flattens_to_itself(self):
        m = DoubleMetric(
            Entity.COLUMN, "Completeness", "att1", Failure(ValueError("x"))
        )
        assert list(m.flatten()) == [m]


class TestKeyedDoubleMetric:
    """reference: Metric.scala:45-68 — flatten emits `name-$key`."""

    def test_flatten_emits_per_key_metrics(self):
        m = KeyedDoubleMetric(
            Entity.COLUMN,
            "ApproxQuantiles",
            "x",
            Success({"0.25": 1.0, "0.5": 2.0, "0.75": 3.0}),
        )
        flat = list(m.flatten())
        assert {f.name for f in flat} == {
            "ApproxQuantiles-0.25",
            "ApproxQuantiles-0.5",
            "ApproxQuantiles-0.75",
        }
        assert {f.value.get() for f in flat} == {1.0, 2.0, 3.0}
        assert all(f.entity == Entity.COLUMN and f.instance == "x" for f in flat)

    def test_failed_keyed_metric_flattens_to_single_failure(self):
        m = KeyedDoubleMetric(
            Entity.COLUMN, "ApproxQuantiles", "x", Failure(ValueError("bad"))
        )
        flat = list(m.flatten())
        assert len(flat) == 1
        assert flat[0].value.is_failure


class TestDistribution:
    def test_argmax(self):
        d = Distribution(
            {
                "a": DistributionValue(5, 0.5),
                "b": DistributionValue(3, 0.3),
                "c": DistributionValue(2, 0.2),
            },
            3,
        )
        assert d.argmax() == "a"

    def test_getitem(self):
        d = Distribution({"a": DistributionValue(5, 1.0)}, 1)
        assert d["a"].absolute == 5


class TestHistogramMetric:
    """reference: HistogramMetric.scala:37-60 — flatten emits bins +
    abs/ratio per value."""

    def test_flatten_names(self):
        d = Distribution(
            {"a": DistributionValue(3, 0.75), "b": DistributionValue(1, 0.25)}, 2
        )
        m = HistogramMetric(Entity.COLUMN, "Histogram", "att1", Success(d))
        flat = list(m.flatten())
        names = {f.name for f in flat}
        assert names == {
            "Histogram.bins",
            "Histogram.abs.a",
            "Histogram.ratio.a",
            "Histogram.abs.b",
            "Histogram.ratio.b",
        }
        by_name = {f.name: f.value.get() for f in flat}
        assert by_name["Histogram.bins"] == 2.0
        assert by_name["Histogram.abs.a"] == 3.0
        assert by_name["Histogram.ratio.a"] == 0.75


class TestEntitySerialization:
    def test_multicolumn_typo_is_load_bearing(self):
        """reference: Metric.scala:19 — 'Mutlicolumn' (sic) is the
        serialized token; byte compatibility keeps it."""
        assert Entity.MULTICOLUMN.value == "Mutlicolumn"


class TestAnalyzerContext:
    """reference: AnalyzerContextTest.scala."""

    def _ctx(self, value: float) -> AnalyzerContext:
        return AnalyzerContext(
            {
                Size(): DoubleMetric(Entity.DATASET, "Size", "*", Success(value)),
            }
        )

    def test_merge_right_side_wins(self):
        merged = self._ctx(1.0) + self._ctx(2.0)
        assert merged.metric(Size()).value.get() == 2.0

    def test_merge_unions_disjoint_analyzers(self):
        left = self._ctx(1.0)
        right = AnalyzerContext(
            {
                Completeness("a"): DoubleMetric(
                    Entity.COLUMN, "Completeness", "a", Success(0.5)
                )
            }
        )
        merged = left + right
        assert len(merged.all_metrics()) == 2

    def test_empty(self):
        assert AnalyzerContext.empty().all_metrics() == []

    def test_equality_by_metric_map(self):
        assert self._ctx(1.0) == self._ctx(1.0)
        assert self._ctx(1.0) != self._ctx(2.0)

    def test_missing_metric_is_none(self):
        assert self._ctx(1.0).metric(Completeness("zzz")) is None

    def test_success_metrics_rows_skip_failures(self):
        ctx = AnalyzerContext(
            {
                Size(): DoubleMetric(Entity.DATASET, "Size", "*", Success(4.0)),
                Completeness("a"): DoubleMetric(
                    Entity.COLUMN, "Completeness", "a", Failure(ValueError("x"))
                ),
            }
        )
        rows = ctx.success_metrics_as_rows()
        assert len(rows) == 1
        assert rows[0]["name"] == "Size"

    def test_composite_metrics_flatten_in_rows(self):
        quantiles = KeyedDoubleMetric(
            Entity.COLUMN, "ApproxQuantiles", "x", Success({"0.5": 2.0})
        )
        from deequ_tpu_torch.analyzers.sketch import ApproxQuantiles

        ctx = AnalyzerContext({ApproxQuantiles("x", (0.5,)): quantiles})
        rows = ctx.success_metrics_as_rows()
        assert rows[0]["name"] == "ApproxQuantiles-0.5"
        assert rows[0]["value"] == 2.0
