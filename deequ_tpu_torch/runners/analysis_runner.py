"""AnalysisRunner: the scheduler of the metrics engine.

Pipeline (reference: runners/AnalysisRunner.scala:98-193):
  1. deduplicate the analyzers,
  2. partition out analyzers with failing preconditions -> failure metrics,
  3. run every scan-shareable analyzer in ONE fused device pass; an
     analyzer that is not shareable (Histogram) computes alone,
  4. run one frequency pass per grouping-column set (grouping_runner),
  5. turn the folded states into metrics.

`data` is an in-memory Table or a streamed source (data/source.py).
Persisting or loading states (`aggregate_with`, `save_states_with`) is
not ported yet: a run given either raises NotImplementedError.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer, Preconditions, ScanShareableAnalyzer
from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer
from deequ_tpu_torch.core.metrics import Metric
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.ops.fused import FusedScanPass
from deequ_tpu_torch.runners.context import AnalyzerContext
from deequ_tpu_torch.runners.grouping_runner import run_grouping_analyzers


class AnalysisRunner:
    @staticmethod
    def on_data(table: Table, device: runtime.DeviceLike = None) -> "AnalysisRunBuilder":
        """A run over `table` (a Table or a streamed source) on `device`
        (CUDA unless the caller asks for the CPU with ``device="cpu"``)."""
        from deequ_tpu_torch.runners.analysis_run_builder import AnalysisRunBuilder

        return AnalysisRunBuilder(table, device)

    @staticmethod
    def do_analysis_run(
        data: Table,
        analyzers: Sequence[Analyzer],
        device: runtime.DeviceLike = None,
        aggregate_with=None,
        save_states_with=None,
        controller=None,
    ) -> AnalyzerContext:
        """`controller` (core/controller.RunController) is checked at every
        batch and partition boundary of the fused pass."""
        if aggregate_with is not None or save_states_with is not None:
            raise NotImplementedError(
                "aggregate_with / save_states_with: state persistence is not ported yet"
            )
        if not analyzers:
            return AnalyzerContext.empty()
        device = runtime.resolve_device(device)

        seen = set()
        unique: List[Analyzer] = []
        for a in analyzers:
            if a not in seen:
                seen.add(a)
                unique.append(a)

        # preconditions (reference: AnalysisRunner.scala:137-147)
        passed: List[Analyzer] = []
        metrics: Dict[Analyzer, Metric] = {}
        for a in unique:
            err = Preconditions.find_first_failing(data, a.preconditions())
            if err is None:
                passed.append(a)
            else:
                metrics[a] = a.to_failure_metric(err)

        # grouping vs scanning (reference: AnalysisRunner.scala:148-150)
        grouping = [a for a in passed if isinstance(a, GroupingAnalyzer)]
        scanning = [a for a in passed if not isinstance(a, GroupingAnalyzer)]
        shareable = [a for a in scanning if isinstance(a, ScanShareableAnalyzer)]

        # the fused scan pass (reference: AnalysisRunner.scala:279-326)
        if shareable:
            for result in FusedScanPass(shareable, device=device, controller=controller).run(data):
                analyzer = result.analyzer
                if result.error is not None:
                    metrics[analyzer] = analyzer.to_failure_metric(result.error)
                else:
                    metrics[analyzer] = analyzer.compute_metric_from(result.state)
        for analyzer in scanning:
            if not isinstance(analyzer, ScanShareableAnalyzer):
                metrics[analyzer] = analyzer.calculate(data, device)

        # one frequency pass per grouping-column set
        # (reference: AnalysisRunner.scala:164-180, 249-277)
        context = AnalyzerContext(metrics)
        if grouping:
            context = context + run_grouping_analyzers(data, grouping, device)
        return context
