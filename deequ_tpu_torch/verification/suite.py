"""VerificationSuite: orchestrates a verification run.

reference: VerificationSuite.scala:49-281. Collects the checks' analyzers,
runs one fused analysis on the run's device, evaluates the checks.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.checks.check import Check, CheckResult, CheckStatus
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from deequ_tpu_torch.runners.context import AnalyzerContext
from deequ_tpu_torch.verification.result import VerificationResult

if TYPE_CHECKING:
    from deequ_tpu_torch.data.table import Table


class VerificationSuite:
    @staticmethod
    def on_data(data: "Table", device: runtime.DeviceLike = None):
        """A verification run over `data` (a Table or a streamed source) on
        `device` (CUDA unless the caller asks for the CPU with
        ``device="cpu"``)."""
        from deequ_tpu_torch.verification.run_builder import VerificationRunBuilder

        return VerificationRunBuilder(data, device)

    @staticmethod
    def do_verification_run(
        data: "Table",
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        device: runtime.DeviceLike = None,
        controller=None,
        deadline_s: Optional[float] = None,
    ) -> VerificationResult:
        """reference: VerificationSuite.scala:107-144. A `controller`
        (core/controller.RunController) is checked at every batch and
        partition boundary; `deadline_s` without one makes one."""
        if controller is None and deadline_s is not None:
            from deequ_tpu_torch.core.controller import RunController

            controller = RunController(deadline_s=deadline_s)
        analyzers: List[Analyzer] = list(required_analyzers)
        for check in checks:
            analyzers.extend(check.required_analyzers())
        analysis_results = AnalysisRunner.do_analysis_run(
            data, analyzers, device, controller=controller
        )
        return VerificationSuite.evaluate(checks, analysis_results)

    @staticmethod
    def evaluate(
        checks: Sequence[Check], analysis_context: AnalyzerContext
    ) -> VerificationResult:
        """reference: VerificationSuite.scala:263-281 — overall status is
        the max severity over check statuses."""
        check_results: Dict[Check, CheckResult] = {
            check: check.evaluate(analysis_context) for check in checks
        }
        if check_results:
            status = max(
                (r.status for r in check_results.values()), key=lambda s: s.severity
            )
        else:
            status = CheckStatus.SUCCESS
        return VerificationResult(status, check_results, dict(analysis_context.metric_map))
