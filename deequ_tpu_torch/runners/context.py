"""AnalyzerContext: Map[Analyzer -> Metric] with merge + exporters.

reference: analyzers/runners/AnalyzerContext.scala:30-105.
"""

from __future__ import annotations

import json
import math
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from deequ_tpu_torch.core.metrics import Metric

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.base import Analyzer


def sanitize_json_values(rows):
    """NaN/Inf are not RFC-8259 JSON — export them as null."""
    out = []
    for row in rows:
        row = dict(row)
        v = row.get("value")
        if isinstance(v, float) and not math.isfinite(v):
            row["value"] = None
        out.append(row)
    return out


class AnalyzerContext:
    def __init__(self, metric_map: Optional[Dict["Analyzer", Metric]] = None):
        self.metric_map: Dict["Analyzer", Metric] = dict(metric_map or {})
        # the static pass's diagnostics (lint.Diagnostic items) in lenient
        # mode, and its cost prediction (lint/cost.PlanCost; None when
        # validation is off): attached by AnalysisRunner, not part of
        # equality — two contexts with the same metrics are the same
        self.validation_warnings: List = []
        self.plan_cost = None
        # the run's RunTrace (observe/) when tracing was on, else None
        self.run_trace = None

    @staticmethod
    def empty() -> "AnalyzerContext":
        return AnalyzerContext()

    def all_metrics(self) -> List[Metric]:
        return list(self.metric_map.values())

    def __add__(self, other: "AnalyzerContext") -> "AnalyzerContext":
        merged = dict(self.metric_map)
        merged.update(other.metric_map)
        return AnalyzerContext(merged)

    def metric(self, analyzer: "Analyzer") -> Optional[Metric]:
        return self.metric_map.get(analyzer)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, AnalyzerContext) and self.metric_map == other.metric_map
        )

    def __repr__(self) -> str:
        entries = ", ".join(f"{a!r} -> {m!r}" for a, m in self.metric_map.items())
        return f"AnalyzerContext({entries})"

    # -- exporters (reference: AnalyzerContext.scala:48-90) ------------------

    def success_metrics_as_rows(
        self, for_analyzers: Optional[Sequence["Analyzer"]] = None
    ) -> List[Dict[str, object]]:
        include = set(for_analyzers) if for_analyzers else None
        rows: List[Dict[str, object]] = []
        for analyzer, metric in self.metric_map.items():
            if include is not None and analyzer not in include:
                continue
            if not metric.value.is_success:
                continue
            for flattened in metric.flatten():
                rows.append(
                    {
                        "entity": flattened.entity.value,
                        "instance": flattened.instance,
                        "name": flattened.name,
                        "value": flattened.value.get(),
                    }
                )
        return rows

    def success_metrics_as_json(
        self, for_analyzers: Optional[Sequence["Analyzer"]] = None
    ) -> str:
        return json.dumps(
            sanitize_json_values(self.success_metrics_as_rows(for_analyzers))
        )

    def success_metrics_as_table(self, for_analyzers=None):
        """Rows as a Table (the DataFrame exporter analogue)."""
        from deequ_tpu_torch.data.table import Table

        rows = self.success_metrics_as_rows(for_analyzers)
        return Table.from_pydict(
            {
                "entity": [r["entity"] for r in rows],
                "instance": [r["instance"] for r in rows],
                "name": [r["name"] for r in rows],
                "value": [float(r["value"]) for r in rows],
            }
        )


def success_metrics_as_data_frame(context: AnalyzerContext, for_analyzers=None):
    return context.success_metrics_as_table(for_analyzers)
