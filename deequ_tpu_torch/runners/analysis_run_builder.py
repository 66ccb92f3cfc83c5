"""Fluent builder for analysis runs.

reference: runners/AnalysisRunBuilder.scala:26-186.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.runners.context import AnalyzerContext


class AnalysisRunBuilder:
    def __init__(self, data: Table, device: runtime.DeviceLike = None):
        self._data = data
        self._device = device
        self._analyzers: List[Analyzer] = []
        self._controller = None
        self._deadline_s: Optional[float] = None

    def with_controller(self, controller) -> "AnalysisRunBuilder":
        """Attach a `RunController` (core/controller.py) whose `cancel()`
        any thread may call: the run raises `RunCancelled` at its next
        batch or partition boundary, after every stage thread joined."""
        self._controller = controller
        return self

    def with_deadline(self, seconds: float) -> "AnalysisRunBuilder":
        """Bound the run's wall time: past `seconds` the next batch check
        raises `RunCancelled` (DQ402)."""
        self._deadline_s = float(seconds)
        return self

    def add_analyzer(self, analyzer: Analyzer) -> "AnalysisRunBuilder":
        self._analyzers.append(analyzer)
        return self

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "AnalysisRunBuilder":
        self._analyzers.extend(analyzers)
        return self

    def run(self) -> AnalyzerContext:
        from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

        controller = self._controller
        if controller is None and self._deadline_s is not None:
            from deequ_tpu_torch.core.controller import RunController

            controller = RunController(deadline_s=self._deadline_s)
        return AnalysisRunner.do_analysis_run(
            self._data, self._analyzers, self._device, controller=controller
        )
