from deequ_tpu_torch.repository.base import (
    AnalysisResult,
    MetricsRepository,
    MetricsRepositoryMultipleResultsLoader,
    ResultKey,
)
from deequ_tpu_torch.repository.memory import InMemoryMetricsRepository
from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository
from deequ_tpu_torch.repository.states import (
    FileSystemStateRepository,
    InMemoryStateRepository,
    StateCacheContext,
    StateRepository,
)

__all__ = [
    "AnalysisResult",
    "MetricsRepository",
    "MetricsRepositoryMultipleResultsLoader",
    "ResultKey",
    "InMemoryMetricsRepository",
    "FileSystemMetricsRepository",
    "FileSystemStateRepository",
    "InMemoryStateRepository",
    "StateCacheContext",
    "StateRepository",
]
