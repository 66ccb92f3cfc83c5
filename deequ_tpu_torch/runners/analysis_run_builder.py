"""Fluent builder for analysis runs.

reference: runners/AnalysisRunBuilder.scala:26-186.
"""

from __future__ import annotations

from typing import List, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.runners.context import AnalyzerContext


class AnalysisRunBuilder:
    def __init__(self, data: Table, device: runtime.DeviceLike = None):
        self._data = data
        self._device = device
        self._analyzers: List[Analyzer] = []

    def add_analyzer(self, analyzer: Analyzer) -> "AnalysisRunBuilder":
        self._analyzers.append(analyzer)
        return self

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "AnalysisRunBuilder":
        self._analyzers.extend(analyzers)
        return self

    def run(self) -> AnalyzerContext:
        from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

        return AnalysisRunner.do_analysis_run(self._data, self._analyzers, self._device)
