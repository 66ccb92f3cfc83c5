"""AnalysisRunner: the scheduler of the metrics engine.

Pipeline (reference: runners/AnalysisRunner.scala:98-193):
  1. deduplicate the analyzers,
  2. partition out analyzers with failing preconditions -> failure metrics,
  3. run every scan-shareable analyzer in ONE fused device pass,
  4. turn the folded states into metrics.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer, Preconditions
from deequ_tpu_torch.core.metrics import Metric
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.ops.fused import FusedScanPass
from deequ_tpu_torch.runners.context import AnalyzerContext


class AnalysisRunner:
    @staticmethod
    def on_data(table: Table, device: runtime.DeviceLike = None) -> "AnalysisRunBuilder":
        """A run over `table` on `device` (CUDA unless the caller asks for
        the CPU with ``device="cpu"``)."""
        from deequ_tpu_torch.runners.analysis_run_builder import AnalysisRunBuilder

        return AnalysisRunBuilder(table, device)

    @staticmethod
    def do_analysis_run(
        data: Table,
        analyzers: Sequence[Analyzer],
        device: runtime.DeviceLike = None,
    ) -> AnalyzerContext:
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

        # the fused scan pass (reference: AnalysisRunner.scala:279-326)
        if passed:
            for result in FusedScanPass(passed, device=device).run(data):
                analyzer = result.analyzer
                if result.error is not None:
                    metrics[analyzer] = analyzer.to_failure_metric(result.error)
                else:
                    metrics[analyzer] = analyzer.compute_metric_from(result.state)
        return AnalyzerContext(metrics)
