"""Grouping (frequency-based) analyzers: the marker the runner partitions
on (reference: analyzers/GroupingAnalyzers.scala,
analyzers/Analyzer.scala:263-272)."""

from __future__ import annotations

from typing import List

from deequ_tpu_torch.analyzers.base import Analyzer


class GroupingAnalyzer(Analyzer):
    """Analyzers that need a group-by over some column set. Analyzers with
    the same (sorted) grouping columns share one frequency computation
    (reference: AnalysisRunner.scala:164-180)."""

    def grouping_columns(self) -> List[str]:
        raise NotImplementedError
