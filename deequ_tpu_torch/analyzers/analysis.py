"""Deprecated `Analysis` container — kept for API-surface parity with
the reference (reference: analyzers/Analysis.scala:29-63, deprecated
there since 2019 in favor of AnalysisRunner.onData)."""

from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Sequence, Tuple

from deequ_tpu_torch.analyzers.base import Analyzer


@dataclass(frozen=True)
class Analysis:
    """Immutable bag of analyzers with a deprecated `run`.

    Prefer `AnalysisRunner.on_data(table).add_analyzers(...).run()`."""

    analyzers: Tuple[Analyzer, ...] = ()

    def add_analyzer(self, analyzer: Analyzer) -> "Analysis":
        return Analysis(tuple(self.analyzers) + (analyzer,))

    def add_analyzers(self, other_analyzers: Sequence[Analyzer]) -> "Analysis":
        return Analysis(tuple(self.analyzers) + tuple(other_analyzers))

    def run(
        self,
        data,
        aggregate_with=None,
        save_states_with=None,
        device=None,
    ):
        """Deprecated: use AnalysisRunner.on_data instead
        (reference: Analysis.scala:52 carries the same deprecation)."""
        warnings.warn(
            "Analysis.run is deprecated; use AnalysisRunner.on_data "
            "(the on_data method there)",
            DeprecationWarning,
            stacklevel=2,
        )
        from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

        return AnalysisRunner.do_analysis_run(
            data,
            list(self.analyzers),
            device,
            aggregate_with=aggregate_with,
            save_states_with=save_states_with,
        )
