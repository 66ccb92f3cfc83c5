"""Full AnalysisResult serde: real computed metrics for every analyzer
type round-trip through the Gson-compatible JSON — the equivalent of the
reference's AnalysisResultSerdeTest.scala (240 LoC): serialize ->
deserialize -> every metric value, entity, and composite structure
(Distribution, keyed quantiles) survives, including failure metrics.

Port-mapped from tests/test_serde_full.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import json

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    Histogram,
    Maximum,
    Mean,
    Minimum,
    MutualInformation,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
    UniqueValueRatio,
)
from deequ_tpu_torch.analyzers.sketch import ApproxQuantile, ApproxQuantiles
from deequ_tpu_torch.core.metrics import HistogramMetric, KeyedDoubleMetric
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.repository.base import ResultKey
from deequ_tpu_torch.repository.serde import (
    deserialize_analysis_results,
    serialize_analysis_results,
)
from deequ_tpu_torch.repository.base import AnalysisResult
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

pytestmark = pytest.mark.usefixtures("cpu_default")

ALL_ANALYZERS = [
    Size(),
    Size(where="x > 0"),
    Completeness("x"),
    Compliance("x positive", "x > 0"),
    PatternMatch("s", r"^\d+$"),
    Mean("x"),
    Minimum("x"),
    Maximum("x"),
    Sum("x"),
    StandardDeviation("x"),
    Correlation("x", "y"),
    DataType("s"),
    ApproxCountDistinct("g"),
    ApproxQuantile("x", 0.5),
    ApproxQuantiles("x", (0.25, 0.5, 0.75)),
    Uniqueness(("g",)),
    Distinctness(("g",)),
    UniqueValueRatio(("g",)),
    CountDistinct(("g",)),
    Entropy("g"),
    MutualInformation(("g", "h")),
    Histogram("s"),
]


@pytest.fixture(scope="module")
def computed_context():
    rng = np.random.default_rng(17)
    n = 500
    x = rng.normal(3.0, 2.0, n)
    x[::11] = np.nan
    table = Table.from_numpy(
        {
            "x": x,
            "y": rng.normal(size=n),
            "g": rng.integers(0, 12, n),
            "h": rng.integers(0, 5, n),
            "s": np.array(
                [["7", "abc", "2.5", "true"][i % 4] for i in range(n)], dtype=object
            ),
        }
    )
    return AnalysisRunner.do_analysis_run(table, ALL_ANALYZERS)


def test_full_round_trip_every_analyzer(computed_context):
    key = ResultKey(123456789, {"dataset": "unit", "env": "ci"})
    results = [AnalysisResult(key, computed_context)]
    payload = serialize_analysis_results(results)
    # the payload must be plain JSON
    parsed = json.loads(payload)
    assert isinstance(parsed, list) and len(parsed) == 1

    restored = deserialize_analysis_results(payload)
    assert len(restored) == 1
    assert restored[0].result_key == key
    restored_map = restored[0].analyzer_context.metric_map

    assert set(restored_map) == set(computed_context.metric_map)
    for analyzer, metric in computed_context.metric_map.items():
        other = restored_map[analyzer]
        assert metric.name == other.name and metric.instance == other.instance
        assert metric.entity == other.entity
        if isinstance(metric, HistogramMetric):
            a, b = metric.value.get(), other.value.get()
            assert a.number_of_bins == b.number_of_bins
            assert set(a.values) == set(b.values)
            for k in a.values:
                assert a.values[k].absolute == b.values[k].absolute
                assert a.values[k].ratio == pytest.approx(b.values[k].ratio)
        elif isinstance(metric, KeyedDoubleMetric):
            assert metric.value.get() == pytest.approx(other.value.get())
        else:
            assert metric.value.get() == pytest.approx(other.value.get(), rel=1e-12)


def test_failure_metrics_are_skipped_like_gson(computed_context):
    """Non-finite / failed metrics: the reference's Gson writer refuses
    them; our serializer mirrors that by skipping failures on save (see
    repository/serde.py docstring note)."""
    table = Table.from_numpy({"x": np.array([np.nan, np.nan])})
    ctx = AnalysisRunner.do_analysis_run(table, [Mean("x"), Size()])
    assert ctx.metric_map[Mean("x")].value.is_failure  # empty state
    payload = serialize_analysis_results(
        [AnalysisResult(ResultKey(1, {}), ctx)]
    )
    restored = deserialize_analysis_results(payload)
    restored_map = restored[0].analyzer_context.metric_map
    assert Size() in restored_map
    assert Mean("x") not in restored_map  # failure not persisted


def test_multiple_results_with_distinct_tags(computed_context):
    keys = [ResultKey(t, {"run": str(t)}) for t in (1, 2, 3)]
    results = [AnalysisResult(k, computed_context) for k in keys]
    restored = deserialize_analysis_results(serialize_analysis_results(results))
    assert [r.result_key for r in restored] == keys
