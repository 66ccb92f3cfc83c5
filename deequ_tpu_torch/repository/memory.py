"""In-memory metrics repository.

reference: repository/memory/InMemoryMetricsRepository.scala:28-136 —
failed metrics are filtered on save (:34-40).
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional

from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)
from deequ_tpu_torch.runners.context import AnalyzerContext


class InMemoryMetricsRepository(MetricsRepository):
    def __init__(self) -> None:
        self._results: Dict[ResultKey, AnalysisResult] = {}
        self._lock = threading.Lock()

    def save(self, result_key: ResultKey, analyzer_context: AnalyzerContext) -> None:
        successful = AnalyzerContext(
            {
                analyzer: metric
                for analyzer, metric in analyzer_context.metric_map.items()
                if metric.value.is_success
            }
        )
        with self._lock:
            self._results[result_key] = AnalysisResult(result_key, successful)

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalyzerContext]:
        with self._lock:
            result = self._results.get(result_key)
        return result.analyzer_context if result is not None else None

    def load(self) -> "InMemoryMetricsRepositoryMultipleResultsLoader":
        return InMemoryMetricsRepositoryMultipleResultsLoader(self)

    def _all_results(self) -> List[AnalysisResult]:
        with self._lock:
            return list(self._results.values())


class InMemoryMetricsRepositoryMultipleResultsLoader(
    MetricsRepositoryMultipleResultsLoader
):
    def __init__(self, repository: InMemoryMetricsRepository):
        super().__init__()
        self._repository = repository

    def get(self) -> List[AnalysisResult]:
        return self._apply_filters(self._repository._all_results())
