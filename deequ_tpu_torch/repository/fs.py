"""Filesystem metrics repository: whole history in a single JSON file with
atomic tmp+rename writes.

reference: repository/fs/FileSystemMetricsRepository.scala:32-226.
"""

from __future__ import annotations

from typing import List, Optional

from deequ_tpu_torch.core.fsio import FileSystem, resolve_filesystem

from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)
from deequ_tpu_torch.repository.serde import (
    deserialize_analysis_results,
    serialize_analysis_results,
)
from deequ_tpu_torch.runners.context import AnalyzerContext


class FileSystemMetricsRepository(MetricsRepository):
    """`filesystem` selects the storage backend (core/fsio.py): local
    disk by default, MemoryFileSystem for object-store-style semantics,
    FsspecFileSystem for real object stores — the role of the
    reference's Hadoop FileSystem qualification (DfsUtils.scala:24-84)."""

    def __init__(self, path: str, filesystem: FileSystem = None):
        self.path = path
        self.filesystem = resolve_filesystem(filesystem)

    def save(self, result_key: ResultKey, analyzer_context: AnalyzerContext) -> None:
        successful = AnalyzerContext(
            {
                analyzer: metric
                for analyzer, metric in analyzer_context.metric_map.items()
                if metric.value.is_success
            }
        )
        history = self._load_all()
        history = [r for r in history if r.result_key != result_key]
        history.append(AnalysisResult(result_key, successful))
        self._write_atomically(serialize_analysis_results(history))

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalyzerContext]:
        for result in self._load_all():
            if result.result_key == result_key:
                return result.analyzer_context
        return None

    def load(self) -> "FileSystemMetricsRepositoryMultipleResultsLoader":
        return FileSystemMetricsRepositoryMultipleResultsLoader(self)

    # -- internals -----------------------------------------------------------

    def _load_all(self) -> List[AnalysisResult]:
        if not self.filesystem.exists(self.path):
            return []
        payload = self.filesystem.read_bytes(self.path).decode("utf-8")
        if not payload.strip():
            return []
        return deserialize_analysis_results(payload)

    def _write_atomically(self, payload: str) -> None:
        """Atomic publish through the fs seam (local: tmp + rename —
        reference: FileSystemMetricsRepository.scala:167-195)."""
        self.filesystem.write_bytes(self.path, payload.encode("utf-8"))


class FileSystemMetricsRepositoryMultipleResultsLoader(
    MetricsRepositoryMultipleResultsLoader
):
    def __init__(self, repository: FileSystemMetricsRepository):
        super().__init__()
        self._repository = repository

    def get(self) -> List[AnalysisResult]:
        return self._apply_filters(self._repository._load_all())
