"""Metrics repository: keyed store of analysis results with history.

reference: repository/MetricsRepository.scala:25-51,
repository/AnalysisResult.scala:25-137,
repository/MetricsRepositoryMultipleResultsLoader.scala:26-139.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from deequ_tpu_torch.runners.context import AnalyzerContext, sanitize_json_values

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.base import Analyzer


@dataclass(frozen=True)
class ResultKey:
    """reference: MetricsRepository.scala:51."""

    data_set_date: int
    tags: Dict[str, str] = field(default_factory=dict)

    def __hash__(self):
        return hash((self.data_set_date, tuple(sorted(self.tags.items()))))

    def __eq__(self, other):
        return (
            isinstance(other, ResultKey)
            and self.data_set_date == other.data_set_date
            and self.tags == other.tags
        )


@dataclass
class AnalysisResult:
    """(ResultKey, AnalyzerContext) (reference: AnalysisResult.scala:25)."""

    result_key: ResultKey
    analyzer_context: AnalyzerContext

    def get_success_metrics_as_rows(
        self, for_analyzers=None, with_tags: Optional[Sequence[str]] = None
    ) -> List[Dict[str, object]]:
        """Metric rows + dataset_date + (sanitized) tag columns
        (reference: AnalysisResult.scala:35-137)."""
        rows = self.analyzer_context.success_metrics_as_rows(for_analyzers)
        tags = self.result_key.tags
        if with_tags is not None:
            tags = {k: v for k, v in tags.items() if k in with_tags}
        out = []
        for row in rows:
            row = dict(row)
            row["dataset_date"] = self.result_key.data_set_date
            for key, value in tags.items():
                column = _sanitize_tag_column(key, row)
                row[column] = value
            out.append(row)
        return out

    def get_success_metrics_as_json(self, for_analyzers=None, with_tags=None) -> str:
        return json.dumps(
            sanitize_json_values(
                self.get_success_metrics_as_rows(for_analyzers, with_tags)
            )
        )


def _sanitize_tag_column(tag: str, existing_row: Dict[str, object]) -> str:
    """Sanitize tag names for column use; on collision with a column the
    row already has, suffix `_2`, `_3`, ... until free (a fixed `_2`
    suffix can itself collide — e.g. tags `a b` and `a.b` with a metric
    column `a_b_2` — and would silently overwrite a value).
    (reference: AnalysisResult.scala tag handling)."""
    sanitized = re.sub(r"[^A-Za-z0-9_]", "_", tag)
    if sanitized not in existing_row:
        return sanitized
    n = 2
    while f"{sanitized}_{n}" in existing_row:
        n += 1
    return f"{sanitized}_{n}"


class MetricsRepository:
    """reference: MetricsRepository.scala:25-35."""

    def save(self, result_key: ResultKey, analyzer_context: AnalyzerContext) -> None:
        raise NotImplementedError

    def load_by_key(self, result_key: ResultKey) -> Optional[AnalyzerContext]:
        raise NotImplementedError

    def load(self) -> "MetricsRepositoryMultipleResultsLoader":
        raise NotImplementedError


class MetricsRepositoryMultipleResultsLoader:
    """Query builder over the whole history
    (reference: MetricsRepositoryMultipleResultsLoader.scala:26-139)."""

    def __init__(self):
        self._tag_values: Optional[Dict[str, str]] = None
        self._analyzers: Optional[List["Analyzer"]] = None
        self._after: Optional[int] = None
        self._before: Optional[int] = None

    def with_tag_values(self, tag_values: Dict[str, str]):
        self._tag_values = dict(tag_values)
        return self

    def for_analyzers(self, analyzers: Sequence["Analyzer"]):
        self._analyzers = list(analyzers)
        return self

    def after(self, date_time: int):
        self._after = date_time
        return self

    def before(self, date_time: int):
        self._before = date_time
        return self

    def get(self) -> List[AnalysisResult]:
        raise NotImplementedError

    # -- shared filtering/union helpers --------------------------------------

    def _apply_filters(self, results: List[AnalysisResult]) -> List[AnalysisResult]:
        out = []
        for result in results:
            key = result.result_key
            if self._after is not None and key.data_set_date < self._after:
                continue
            if self._before is not None and key.data_set_date > self._before:
                continue
            if self._tag_values is not None and not all(
                key.tags.get(k) == v for k, v in self._tag_values.items()
            ):
                continue
            context = result.analyzer_context
            if self._analyzers is not None:
                context = AnalyzerContext(
                    {
                        a: m
                        for a, m in context.metric_map.items()
                        if a in self._analyzers
                    }
                )
            out.append(AnalysisResult(key, context))
        return out

    def get_success_metrics_as_rows(self, with_tags=None) -> List[Dict[str, object]]:
        rows: List[Dict[str, object]] = []
        for result in self.get():
            rows.extend(result.get_success_metrics_as_rows(with_tags=with_tags))
        return rows

    def get_success_metrics_as_json(self, with_tags=None) -> str:
        """Union with schema alignment: every row carries every column
        (reference: MetricsRepositoryMultipleResultsLoader.scala:100+)."""
        rows = self.get_success_metrics_as_rows(with_tags)
        all_columns = sorted({k for row in rows for k in row})
        aligned = [
            {col: row.get(col) for col in all_columns} for row in rows
        ]
        return json.dumps(sanitize_json_values(aligned))

    def get_success_metrics_as_table(self, with_tags=None):
        from deequ_tpu_torch.data.table import Table

        rows = self.get_success_metrics_as_rows(with_tags)
        all_columns = sorted({k for row in rows for k in row})
        return Table.from_pydict(
            {col: [row.get(col) for row in rows] for col in all_columns}
        )
