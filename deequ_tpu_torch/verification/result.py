"""VerificationResult: status + per-check constraint results + metrics,
with JSON exporters.

reference: VerificationResult.scala:33-119.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Dict, List

from deequ_tpu_torch.checks.check import Check, CheckResult, CheckStatus
from deequ_tpu_torch.core.metrics import Metric
from deequ_tpu_torch.runners.context import AnalyzerContext

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.base import Analyzer


@dataclass
class VerificationResult:
    status: CheckStatus
    check_results: Dict[Check, CheckResult]
    metrics: Dict["Analyzer", Metric]
    # the static pass's diagnostics (lint.Diagnostic items) in lenient
    # mode, and its cost prediction (lint/cost.PlanCost); empty and None
    # when validation is off
    validation_warnings: List = field(default_factory=list)
    # the run's RunTrace (observe/) when tracing was on (with_tracing or
    # DEEQU_TPU_TRACE), else None
    run_trace: object = None
    plan_cost: object = None
    # failure forensics (observe/forensics.ForensicsReport) when capture
    # was on (with_forensics or DEEQU_TPU_FORENSICS), else None
    forensics_report: object = None

    def forensics(self):
        """The run's ForensicsReport (sampled violating rows with their
        partition, row group, row index and values, and the plan's
        provenance), or None when capture was off (the default)."""
        return self.forensics_report

    # -- metric exporters (reference: VerificationResult.scala:40-72) --------

    def success_metrics_as_rows(self, for_analyzers=None) -> List[Dict[str, object]]:
        return AnalyzerContext(self.metrics).success_metrics_as_rows(for_analyzers)

    def success_metrics_as_table(self, for_analyzers=None):
        return AnalyzerContext(self.metrics).success_metrics_as_table(for_analyzers)

    def success_metrics_as_json(self, for_analyzers=None) -> str:
        return AnalyzerContext(self.metrics).success_metrics_as_json(for_analyzers)

    # -- check exporters (reference: VerificationResult.scala:74-117) --------

    def check_results_as_rows(self, for_checks=None) -> List[Dict[str, object]]:
        include = set(id(c) for c in for_checks) if for_checks else None
        rows: List[Dict[str, object]] = []
        for check, result in self.check_results.items():
            if include is not None and id(check) not in include:
                continue
            for cr in result.constraint_results:
                rows.append(
                    {
                        "check": check.description,
                        "check_level": check.level.value,
                        "check_status": result.status.value,
                        "constraint": repr(cr.constraint),
                        "constraint_status": cr.status.value,
                        "constraint_message": cr.message or "",
                    }
                )
        return rows

    def check_results_as_table(self, for_checks=None):
        from deequ_tpu_torch.data.table import Table

        rows = self.check_results_as_rows(for_checks)
        return Table.from_pydict(
            {
                "check": [r["check"] for r in rows],
                "check_level": [r["check_level"] for r in rows],
                "check_status": [r["check_status"] for r in rows],
                "constraint": [r["constraint"] for r in rows],
                "constraint_status": [r["constraint_status"] for r in rows],
                "constraint_message": [r["constraint_message"] for r in rows],
            }
        )

    def check_results_as_json(self, for_checks=None) -> str:
        return json.dumps(self.check_results_as_rows(for_checks))
