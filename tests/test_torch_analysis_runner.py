"""Runner tests: scan-sharing as an asserted property (mirrors reference
analyzers/runners/AnalysisRunnerTests.scala job-count assertions) plus
context merge/export semantics.

Port-mapped from tests/test_analysis_runner.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py). Its last case,
`test_deprecated_analysis_container`, is mapped in
tests/test_torch_verification.py.
"""

import pytest
from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

from deequ_tpu_torch.analyzers import (
    Completeness,
    Compliance,
    Correlation,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.core.exceptions import NoSuchColumnException
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.runners import AnalysisRunner

from torch_fixtures import get_df_with_numeric_values

pytestmark = pytest.mark.usefixtures("cpu_default")


class TestScanSharing:
    def test_six_analyzers_one_pass(self):
        df = get_df_with_numeric_values()
        analyzers = [
            Size(),
            Completeness("att1"),
            Mean("att1"),
            Minimum("att1"),
            Maximum("att1"),
            Sum("att1"),
        ]
        with runtime.monitored() as separate_stats:
            separate = [a.calculate(df) for a in analyzers]
        assert separate_stats.device_passes == 6

        with runtime.monitored() as fused_stats:
            context = AnalysisRunner.on_data(df).add_analyzers(analyzers).run()
        assert fused_stats.device_passes == 1

        # fused results == separate results (reference: AnalysisRunnerTests.scala:60-75)
        for analyzer, sep_metric in zip(analyzers, separate):
            assert context.metric(analyzer).value.get() == sep_metric.value.get()

    def test_mixed_columns_still_one_pass(self):
        df = get_df_with_numeric_values()
        analyzers = [
            Mean("att1"),
            Mean("att2"),
            StandardDeviation("att1"),
            Correlation("att1", "att2"),
            Compliance("rule", "att2 > att1"),
        ]
        with runtime.monitored() as stats:
            context = AnalysisRunner.on_data(df).add_analyzers(analyzers).run()
        assert stats.device_passes == 1
        assert len(context.metric_map) == 5
        assert all(m.value.is_success for m in context.all_metrics())

    def test_preconditions_fail_without_running_jobs(self):
        df = get_df_with_numeric_values()
        with runtime.monitored() as stats:
            context = (
                AnalysisRunner.on_data(df)
                .add_analyzer(Completeness("nope"))
                .run()
            )
        assert stats.device_passes == 0
        metric = context.metric(Completeness("nope"))
        assert metric.value.is_failure
        assert isinstance(metric.value.exception, NoSuchColumnException)

    def test_failure_does_not_poison_pass(self):
        df = get_df_with_numeric_values()
        context = (
            AnalysisRunner.on_data(df)
            .add_analyzer(Mean("att1"))
            .add_analyzer(Mean("item"))  # string column -> precondition failure
            .run()
        )
        assert context.metric(Mean("att1")).value.is_success
        assert context.metric(Mean("item")).value.is_failure

    def test_duplicate_analyzers_deduped(self):
        df = get_df_with_numeric_values()
        context = (
            AnalysisRunner.on_data(df)
            .add_analyzers([Mean("att1"), Mean("att1"), Mean("att1")])
            .run()
        )
        assert len(context.metric_map) == 1


class TestAnalyzerContext:
    def test_export_rows(self):
        df = get_df_with_numeric_values()
        context = (
            AnalysisRunner.on_data(df)
            .add_analyzers([Size(), Mean("att1"), Completeness("nope")])
            .run()
        )
        rows = context.success_metrics_as_rows()
        assert {
            "entity": "Dataset",
            "instance": "*",
            "name": "Size",
            "value": 6.0,
        } in rows
        assert {
            "entity": "Column",
            "instance": "att1",
            "name": "Mean",
            "value": 3.5,
        } in rows
        assert len(rows) == 2  # failed metric excluded

    def test_context_merge(self):
        df = get_df_with_numeric_values()
        c1 = AnalysisRunner.on_data(df).add_analyzer(Size()).run()
        c2 = AnalysisRunner.on_data(df).add_analyzer(Mean("att1")).run()
        merged = c1 + c2
        assert len(merged.metric_map) == 2
