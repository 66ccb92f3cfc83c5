"""VerificationSuite: orchestrates a verification run.

reference: VerificationSuite.scala:49-281. Collects the checks' analyzers,
runs one fused analysis on the run's device, evaluates the checks and
persists the results.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.checks.check import Check, CheckResult, CheckStatus
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner, validate_run_plan
from deequ_tpu_torch.runners.context import AnalyzerContext
from deequ_tpu_torch.verification.result import VerificationResult

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.state_provider import StateLoader, StatePersister
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.repository.base import MetricsRepository, ResultKey


class VerificationSuite:
    @staticmethod
    def on_data(data: "Table", device: runtime.DeviceLike = None):
        """A verification run over `data` (a Table or a streamed source) on
        `device` (CUDA unless the caller asks for the CPU with
        ``device="cpu"``)."""
        from deequ_tpu_torch.verification.run_builder import VerificationRunBuilder

        return VerificationRunBuilder(data, device)

    # reference: VerificationSuite.scala:80-104 (deprecated run shortcut)
    def run(
        self,
        data: "Table",
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        device: runtime.DeviceLike = None,
    ) -> VerificationResult:
        return self.do_verification_run(data, checks, required_analyzers, device)

    @staticmethod
    def do_verification_run(
        data: "Table",
        checks: Sequence[Check],
        required_analyzers: Sequence[Analyzer] = (),
        device: runtime.DeviceLike = None,
        aggregate_with: Optional["StateLoader"] = None,
        save_states_with: Optional["StatePersister"] = None,
        metrics_repository: Optional["MetricsRepository"] = None,
        reuse_existing_results_for_key: Optional["ResultKey"] = None,
        fail_if_results_missing: bool = False,
        save_or_append_results_with_key: Optional["ResultKey"] = None,
        state_repository=None,
        dataset_name: str = "default",
        controller=None,
        deadline_s: Optional[float] = None,
        engine: str = "auto",
        mesh=None,
        validation: Optional[str] = None,
        tracing=None,
        forensics: Optional[bool] = None,
        forensics_max_samples: int = 10,
    ) -> VerificationResult:
        """reference: VerificationSuite.scala:107-144. A `controller`
        (core/controller.RunController) is checked at every batch and
        partition boundary; `deadline_s` without one makes one. With a
        `state_repository` and a partitioned source, unchanged partitions
        load their states instead of being scanned. `engine` and `mesh`
        pick the single-device or the mesh-sharded pass
        (runners/engine.py). `validation` is the static pass's mode over
        the whole plan, checks included (`_validate_plan`).

        `tracing` (observe/): True records the run's span tree, a path
        also names its Chrome-trace file, None defers to
        ``DEEQU_TPU_TRACE``, False turns it off; the trace attaches as
        `result.run_trace`. `forensics` (observe/forensics.py): True
        samples up to `forensics_max_samples` violating rows of each
        row-level-capable constraint from the decoded host batches, with
        the run's provenance, as `result.forensics()`, and saves it as an
        audit trail beside the metrics when a repository and key are set;
        None defers to ``DEEQU_TPU_FORENSICS``; off under a mesh. The
        metrics are the same bits either way."""
        if controller is None and deadline_s is not None:
            from deequ_tpu_torch.core.controller import RunController

            controller = RunController(deadline_s=deadline_s)
        with observe.traced_run("verification_suite", enable=tracing, checks=len(checks)) as run:
            result = VerificationSuite._do_verification_run(
                data, checks, required_analyzers, device, aggregate_with, save_states_with,
                metrics_repository, reuse_existing_results_for_key, fail_if_results_missing,
                save_or_append_results_with_key, state_repository, dataset_name, controller,
                deadline_s, engine, mesh, validation, forensics, forensics_max_samples,
            )
        if run:
            result.run_trace = run.trace
        return result

    @staticmethod
    def _do_verification_run(
        data, checks, required_analyzers, device, aggregate_with, save_states_with,
        metrics_repository, reuse_existing_results_for_key, fail_if_results_missing,
        save_or_append_results_with_key, state_repository, dataset_name, controller,
        deadline_s, engine, mesh, validation, forensics, forensics_max_samples,
    ) -> VerificationResult:
        analyzers: List[Analyzer] = list(required_analyzers)
        for check in checks:
            analyzers.extend(check.required_analyzers())
        capture = None
        enable_forensics = forensics if forensics is not None else runtime.forensics_enabled()
        if enable_forensics and mesh is None:
            # a mesh shards each batch over its devices: there is no
            # ordered host batch to hook, so capture is off there
            from deequ_tpu_torch.observe.forensics import ForensicsCapture

            capture = ForensicsCapture(checks, max_samples=forensics_max_samples)
        with observe.span("plan_validate", cat="plan"):
            validation_diagnostics, plan_cost = VerificationSuite._validate_plan(
                data, checks, required_analyzers, validation, device,
                state_repository=state_repository, dataset_name=dataset_name,
                deadline_s=deadline_s,
            )
        analysis_results = AnalysisRunner.do_analysis_run(
            data,
            analyzers,
            device,
            aggregate_with=aggregate_with,
            save_states_with=save_states_with,
            metrics_repository=metrics_repository,
            reuse_existing_results_for_key=reuse_existing_results_for_key,
            fail_if_results_missing=fail_if_results_missing,
            # saved after the checks are evaluated, so that a check that
            # reads the repository sees only earlier runs
            # (reference: VerificationSuite.scala:121-139)
            save_or_append_results_with_key=None,
            state_repository=state_repository,
            dataset_name=dataset_name,
            controller=controller,
            engine=engine,
            mesh=mesh,
            # the suite validated the whole plan, checks included
            validation="off",
            forensics=capture,
        )
        result = VerificationSuite.evaluate(checks, analysis_results)
        result.validation_warnings = validation_diagnostics
        result.plan_cost = plan_cost
        save_context = analysis_results
        if capture is not None:
            report = capture.finalize(result.check_results)
            result.forensics_report = report
            if metrics_repository is not None and save_or_append_results_with_key is not None:
                # the audit trail saves with the metrics it explains
                # (repository/audit.py)
                from deequ_tpu_torch.repository.audit import audit_entry_for

                record, metric = audit_entry_for(report)
                save_context = analysis_results + AnalyzerContext({record: metric})
        if metrics_repository is not None and save_or_append_results_with_key is not None:
            AnalysisRunner._save_or_append(
                metrics_repository, save_or_append_results_with_key, save_context
            )
        return result

    @staticmethod
    def _validate_plan(
        data, checks, required_analyzers, validation, device=None,
        state_repository=None, dataset_name: str = "default", deadline_s=None,
    ):
        """The static pass over the whole plan before any scan ->
        (diagnostics, PlanCost | None): `validate_run_plan` with the
        checks. Strict mode raises the aggregated PlanValidationError."""
        cache = None
        if state_repository is not None and getattr(data, "partitions", None) is not None:
            from deequ_tpu_torch.repository.states import StateCacheContext

            cache = StateCacheContext(state_repository, dataset_name)
        return validate_run_plan(
            data, list(required_analyzers), validation, cache,
            runtime.resolve_device(device), checks=checks, deadline_s=deadline_s,
        )

    @staticmethod
    def run_on_aggregated_states(
        schema_table: "Table",
        checks: Sequence[Check],
        state_loaders: Sequence["StateLoader"],
        required_analyzers: Sequence[Analyzer] = (),
        save_states_with: Optional["StatePersister"] = None,
        metrics_repository: Optional["MetricsRepository"] = None,
        save_or_append_results_with_key: Optional["ResultKey"] = None,
        device: runtime.DeviceLike = None,
    ) -> VerificationResult:
        """reference: VerificationSuite.scala:208-229, on the resolved
        `device`."""
        analyzers: List[Analyzer] = list(required_analyzers)
        for check in checks:
            analyzers.extend(check.required_analyzers())
        analysis_results = AnalysisRunner.run_on_aggregated_states(
            schema_table,
            analyzers,
            state_loaders,
            save_states_with=save_states_with,
            metrics_repository=metrics_repository,
            save_or_append_results_with_key=None,
            device=device,
        )
        result = VerificationSuite.evaluate(checks, analysis_results)
        if metrics_repository is not None and save_or_append_results_with_key is not None:
            AnalysisRunner._save_or_append(
                metrics_repository, save_or_append_results_with_key, analysis_results
            )
        return result

    @staticmethod
    def is_check_applicable_to_data(
        check: Check, schema, num_records: int = 1000, device: runtime.DeviceLike = None
    ):
        """Dry-run the check's analyzers on generated data matching the
        schema (reference: VerificationSuite.scala:238-261)."""
        from deequ_tpu_torch.applicability.applicability import Applicability

        return Applicability(device=device).is_applicable(check, schema, num_records)

    @staticmethod
    def evaluate(
        checks: Sequence[Check], analysis_context: AnalyzerContext
    ) -> VerificationResult:
        """reference: VerificationSuite.scala:263-281 — overall status is
        the max severity over check statuses."""
        with observe.span("constraint_eval", cat="constraint", checks=len(checks)):
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
