"""Incremental/partitioned state algebra, analyzer by analyzer — the
mirror of the reference's IncrementalAnalysisTest (incremental ==
from-scratch), IncrementalAnalyzerTest (270 LoC),
StateAggregationTests/StateAggregationIntegrationTest (245 LoC:
partitioned state merge == whole table through the runner AND the suite)
and PartitionedTableIntegrationTest (169 LoC).

Port-mapped from tests/test_incremental_analysis.py: the same cases
against deequ_tpu_torch, with every run on device="cpu" and the toy
tables of tests/fixtures.py as the port's tables
(tests/torch_fixtures.py). `TestAnalyzersExact` adds the incremental
case of tests/test_analyzers_exact.py.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from deequ_tpu_torch import Check, CheckLevel, CheckStatus, Table, VerificationSuite
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
from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner


def make_partition(seed: int, n: int = 4000) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.normal(5.0, 3.0, n)
    x[:: max(7, seed + 7)] = np.nan
    return {
        "x": x,
        "y": rng.normal(size=n),
        "g": rng.integers(0, 25, n),
        "s": np.array(
            [["42", "word", "3.14", None, "true"][i % 5] for i in range(n)],
            dtype=object,
        ),
    }


PARTS = [make_partition(seed) for seed in (0, 1, 2)]
WHOLE = Table.from_numpy(
    {k: np.concatenate([p[k] for p in PARTS]) for k in ("x", "y", "g", "s")}
)

ALL_ANALYZERS = [
    Size(),
    Size(where="x > 5"),
    Completeness("x"),
    Completeness("s", where="g < 10"),
    Compliance("pos", "x > 0"),
    PatternMatch("s", r"^\d+$"),
    Mean("x"),
    Minimum("x"),
    Maximum("x"),
    Sum("x"),
    StandardDeviation("x"),
    Correlation("x", "y"),
    DataType("s"),
    ApproxCountDistinct("g"),
    ApproxQuantile("x", 0.25),
    ApproxQuantiles("x", (0.1, 0.5, 0.9)),
    Uniqueness(("g",)),
    Distinctness(("g",)),
    UniqueValueRatio(("g",)),
    CountDistinct(("g",)),
    Entropy("g"),
    Histogram("g"),
    MutualInformation("g", "s"),
]


@pytest.fixture(scope="module")
def partition_states():
    providers = []
    for part in PARTS:
        provider = InMemoryStateProvider()
        AnalysisRunner.do_analysis_run(
            Table.from_numpy(part), ALL_ANALYZERS, save_states_with=provider, device="cpu"
        )
        providers.append(provider)
    return providers


@pytest.fixture(scope="module")
def whole_table_context():
    return AnalysisRunner.do_analysis_run(WHOLE, ALL_ANALYZERS, device="cpu")


@pytest.fixture(scope="module")
def aggregated_context(partition_states):
    return AnalysisRunner.run_on_aggregated_states(
        WHOLE, ALL_ANALYZERS, partition_states, device="cpu"
    )


@pytest.mark.parametrize("analyzer", ALL_ANALYZERS, ids=repr)
def test_partition_merge_equals_whole_table(
    analyzer, aggregated_context, whole_table_context
):
    """State semigroup: fold(partition states) == whole-table run, for
    EVERY analyzer (reference: StateAggregationIntegrationTest)."""
    merged = aggregated_context.metric_map[analyzer].value
    whole = whole_table_context.metric_map[analyzer].value
    assert merged.is_success == whole.is_success, analyzer
    got, want = merged.get(), whole.get()
    if isinstance(analyzer, (ApproxQuantile, ApproxQuantiles)):
        # sketches merged in a different order agree within RANK error —
        # the sketch's actual contract (value-space tolerances break down
        # in distribution tails where the density is low)
        xs = np.sort(WHOLE.column("x").values[WHOLE.column("x").valid])

        def rank_of(v: float) -> float:
            return float(np.searchsorted(xs, v, side="right")) / len(xs)

        def assert_rank_close(g: float, w: float, q: float) -> None:
            # each sketch answers within ~eps of q; allow both errors
            budget = 3 * 0.01
            assert abs(rank_of(g) - q) <= budget, (q, g, rank_of(g))
            assert abs(rank_of(w) - q) <= budget, (q, w, rank_of(w))

        if isinstance(got, dict):
            for key in want:
                assert_rank_close(got[key], want[key], float(key))
        else:
            assert_rank_close(got, want, analyzer.quantile)
    elif hasattr(want, "values"):  # Distribution
        assert {k: v.absolute for k, v in got.values.items()} == {
            k: v.absolute for k, v in want.values.items()
        }
    else:
        assert got == pytest.approx(want, rel=1e-9), analyzer


def test_incremental_update_recomputes_only_new_partition(partition_states):
    """Add a partition: only its state is computed; the merge then covers
    all four (reference: UpdateMetricsOnPartitionedDataExample.scala:63-86)."""
    new_part = make_partition(9)
    new_provider = InMemoryStateProvider()
    AnalysisRunner.do_analysis_run(
        Table.from_numpy(new_part), [Size(), Mean("x")], save_states_with=new_provider, device="cpu"
    )
    ctx = AnalysisRunner.run_on_aggregated_states(
        WHOLE, [Size(), Mean("x")], list(partition_states) + [new_provider], device="cpu"
    )
    assert ctx.metric_map[Size()].value.get() == float(
        WHOLE.num_rows + len(new_part["x"])
    )

    all_x = np.concatenate([p["x"] for p in PARTS] + [new_part["x"]])
    expected_mean = float(np.nanmean(all_x))
    assert ctx.metric_map[Mean("x")].value.get() == pytest.approx(
        expected_mean, rel=1e-12
    )


def test_aggregated_states_through_verification_suite(partition_states):
    """reference: VerificationSuite.runOnAggregatedStates
    (VerificationSuite.scala:208-229)."""
    result = VerificationSuite.run_on_aggregated_states(
        WHOLE,
        [
            Check(CheckLevel.ERROR, "aggregated")
            .has_size(lambda n: n == WHOLE.num_rows)
            .has_completeness("x", lambda v: 0.7 < v < 1.0)
            .has_uniqueness(("g",), lambda v: v < 0.1)
        ],
        partition_states,
        device="cpu",
    )
    assert result.status == CheckStatus.SUCCESS


def test_aggregation_persists_merged_state(partition_states):
    target = InMemoryStateProvider()
    AnalysisRunner.run_on_aggregated_states(
        WHOLE, [Sum("x")], partition_states, save_states_with=target, device="cpu"
    )
    merged_state = target.load(Sum("x"))
    assert merged_state is not None
    expected = float(np.nansum(np.concatenate([p["x"] for p in PARTS])))
    assert merged_state.metric_value() == pytest.approx(expected, rel=1e-12)


def test_no_data_scan_during_aggregation(partition_states):
    """Aggregating states must not launch scans over the data
    (reference: 'metrics purely from merged states')."""
    from deequ_tpu_torch.ops import runtime

    with runtime.monitored() as stats:
        AnalysisRunner.run_on_aggregated_states(
            WHOLE, [Size(), Mean("x"), StandardDeviation("x")], partition_states, device="cpu"
        )
    assert stats.device_passes == 0
    assert stats.device_launches == 0


def test_empty_loaders_give_empty_state_failures():
    empty = InMemoryStateProvider()
    ctx = AnalysisRunner.run_on_aggregated_states(WHOLE, [Mean("x")], [empty], device="cpu")
    assert ctx.metric_map[Mean("x")].value.is_failure


def test_two_dataset_merge_mean_exact():
    """The reference's IncrementalAnalysisTest headline: metrics from
    merged states equal metrics over the union, exactly."""
    a = Table.from_pydict({"v": [1.0, 2.0, 3.0]})
    b = Table.from_pydict({"v": [10.0, 20.0]})
    pa_, pb = InMemoryStateProvider(), InMemoryStateProvider()
    AnalysisRunner.do_analysis_run(a, [Mean("v"), Maximum("v")], save_states_with=pa_, device="cpu")
    AnalysisRunner.do_analysis_run(b, [Mean("v"), Maximum("v")], save_states_with=pb, device="cpu")
    from deequ_tpu_torch.data.table import ColumnType

    union_schema = Table.from_pydict({"v": []}, types={"v": ColumnType.DOUBLE})
    ctx = AnalysisRunner.run_on_aggregated_states(
        union_schema, [Mean("v"), Maximum("v")], [pa_, pb], device="cpu"
    )
    assert ctx.metric_map[Mean("v")].value.get() == pytest.approx(36.0 / 5)
    assert ctx.metric_map[Maximum("v")].value.get() == 20.0


class TestAnalyzersExact:
    """Port-mapped from tests/test_analyzers_exact.py."""

    def test_incremental_merge_with_all_null_partition(self):
        from deequ_tpu_torch.data.table import ColumnType
        from torch_fixtures import get_df_with_numeric_values

        full = get_df_with_numeric_values()
        nulls = Table.from_pydict(
            {"item": ["7"], "att1": [None], "att2": [None]},
            types={"att1": ColumnType.LONG, "att2": ColumnType.LONG},
        )
        p1, p2 = InMemoryStateProvider(), InMemoryStateProvider()
        AnalysisRunner.do_analysis_run(full, [Mean("att1")], save_states_with=p1, device="cpu")
        AnalysisRunner.do_analysis_run(nulls, [Mean("att1")], save_states_with=p2, device="cpu")
        analyzer = Mean("att1")
        state1 = p1.load(analyzer)
        assert p2.load(analyzer) is None  # empty contribution
        assert analyzer.compute_metric_from(state1).value.get() == 3.5


class TestMergedStatesDevice:
    """Metrics from merged states reduce on the caller's device: every
    frequency analyzer's shared aggregation gets the device the entry
    point resolved, and with no device the entry point asks for CUDA."""

    FREQUENCY = [Uniqueness(("g",)), Entropy("g"), CountDistinct(("g",))]

    @pytest.fixture
    def devices(self, monkeypatch):
        from deequ_tpu_torch.ops import freq_agg

        seen = []
        original = freq_agg.run_shared_freq_agg

        def recording(state, analyzers, device):
            seen.append(device)
            return original(state, analyzers, device)

        monkeypatch.setattr(freq_agg, "run_shared_freq_agg", recording)
        return seen

    def _entry_points(self, partition_states):
        check = Check(CheckLevel.ERROR, "aggregated").has_uniqueness(("g",), lambda v: v < 0.1)
        return {
            "analysis": lambda device: AnalysisRunner.run_on_aggregated_states(
                WHOLE, self.FREQUENCY, partition_states, device=device
            ),
            "verification": lambda device: VerificationSuite.run_on_aggregated_states(
                WHOLE, [check], partition_states, device=device
            ),
            "load_state": lambda device: Uniqueness(("g",)).load_state_and_compute_metric(
                partition_states[0], device=device
            ),
            "calculate_metric": lambda device: Uniqueness(("g",)).calculate_metric(
                None, aggregate_with=partition_states[0], device=device
            ),
        }

    @pytest.mark.parametrize("entry", ["analysis", "verification", "load_state", "calculate_metric"])
    def test_frequency_aggregation_runs_on_the_given_device(self, entry, partition_states, devices):
        self._entry_points(partition_states)[entry]("cpu")
        assert devices and all(d == torch.device("cpu") for d in devices)

    @pytest.mark.parametrize("entry", ["analysis", "verification", "load_state", "calculate_metric"])
    def test_no_device_asks_for_the_card(self, entry, partition_states, devices, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            self._entry_points(partition_states)[entry](None)
        assert devices == []

    def test_frequency_metrics_equal_the_whole_table(self, partition_states, whole_table_context):
        """The frequency metrics of merged states equal the whole table's."""
        ctx = AnalysisRunner.run_on_aggregated_states(
            WHOLE, self.FREQUENCY, partition_states, device="cpu"
        )
        for analyzer in self.FREQUENCY:
            assert ctx.metric_map[analyzer].value.get() == pytest.approx(
                whole_table_context.metric_map[analyzer].value.get(), rel=1e-12
            )
