"""Fluent builder for verification runs.

reference: VerificationRunBuilder.scala:28-308 (incl. the repository
variant's options and addAnomalyCheck).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.checks.check import Check, CheckLevel
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.verification.result import VerificationResult
from deequ_tpu_torch.verification.suite import VerificationSuite

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.state_provider import StateLoader, StatePersister
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.repository.base import MetricsRepository, ResultKey


@dataclass
class AnomalyCheckConfig:
    """reference: VerificationRunBuilder.scala:303."""

    level: CheckLevel
    description: str
    with_tag_values: Optional[Dict[str, str]] = None
    after_date: Optional[int] = None
    before_date: Optional[int] = None


class VerificationRunBuilder:
    def __init__(self, data: "Table", device: runtime.DeviceLike = None):
        self._data = data
        self._device = device
        self._checks: List[Check] = []
        self._required_analyzers: List[Analyzer] = []
        self._controller = None
        self._deadline_s: Optional[float] = None
        self._metrics_repository: Optional["MetricsRepository"] = None
        self._reuse_key: Optional["ResultKey"] = None
        self._fail_if_results_missing = False
        self._save_key: Optional["ResultKey"] = None
        self._aggregate_with: Optional["StateLoader"] = None
        self._save_states_with: Optional["StatePersister"] = None
        self._state_repository = None
        self._dataset_name = "default"
        self._save_check_results_json_path: Optional[str] = None
        self._save_success_metrics_json_path: Optional[str] = None
        self._overwrite_output_files = False
        self._engine = "auto"
        self._mesh = None
        self._validation: Optional[str] = None
        self._tracing = None
        self._forensics: Optional[bool] = None
        self._forensics_max_samples: int = 10

    def with_engine(self, engine: str, mesh=None) -> "VerificationRunBuilder":
        """"auto" (a mesh over every CUDA device when there are two or
        more and the table is large), "single", or "distributed" (over
        `mesh`, parallel/distributed.data_mesh), runners/engine.py."""
        self._engine = engine
        self._mesh = mesh
        return self

    def explain(self, **kwargs):
        """EXPLAIN the planned verification without scanning a row: the
        static cost/effect prediction plus DQ3xx performance
        diagnostics, as an `ExplainResult` (render with `str(...)`), on
        the run's device."""
        from deequ_tpu_torch.lint.explain import explain_plan

        if self._deadline_s is not None:
            kwargs.setdefault("deadline_s", self._deadline_s)
        kwargs.setdefault("device", self._device)
        return explain_plan(
            self._data, analyzers=self._required_analyzers, checks=self._checks, **kwargs
        )

    def with_plan_validation(self, mode: str) -> "VerificationRunBuilder":
        """Plan-time static analysis mode: "strict" raises one aggregated
        PlanValidationError before any scan, "lenient" (default) attaches
        diagnostics to the result, "off" skips the pass."""
        self._validation = mode
        return self

    def with_tracing(self, trace=True) -> "VerificationRunBuilder":
        """Run observability (observe/): True records the run's span tree
        (plan, dispatch, transfer, merge, constraint evaluation) as
        `result.run_trace`; a path also writes its Chrome-trace JSON there
        (load it in Perfetto); False turns tracing off whatever
        ``DEEQU_TPU_TRACE`` says."""
        self._tracing = trace
        return self

    def with_forensics(self, enabled: bool = True, max_samples: int = 10) -> "VerificationRunBuilder":
        """Failure forensics (observe/forensics.py): a bounded,
        deterministic sample of violating rows, with their (partition,
        row group, row index, values), for every row-level-capable
        constraint, and the run's provenance (plan signature, partitions
        scanned and cached, row groups pruned, decode routing), as
        `result.forensics()`; saved as an audit trail when a metrics
        repository and a key are set. Off by default (also
        ``DEEQU_TPU_FORENSICS=1``); metrics and verdicts are the same
        bits either way."""
        self._forensics = bool(enabled)
        self._forensics_max_samples = int(max_samples)
        return self

    def with_controller(self, controller) -> "VerificationRunBuilder":
        """Attach a `RunController` (core/controller.py) whose `cancel()`
        any thread may call: the run raises `RunCancelled` at its next
        batch or partition boundary, after every stage thread joined."""
        self._controller = controller
        return self

    def with_deadline(self, seconds: float) -> "VerificationRunBuilder":
        """Bound the run's wall time: past `seconds` the next batch check
        raises `RunCancelled` (DQ402)."""
        self._deadline_s = float(seconds)
        return self

    def add_check(self, check: Check) -> "VerificationRunBuilder":
        self._checks.append(check)
        return self

    def add_checks(self, checks: Sequence[Check]) -> "VerificationRunBuilder":
        self._checks.extend(checks)
        return self

    def add_required_analyzer(self, analyzer: Analyzer) -> "VerificationRunBuilder":
        self._required_analyzers.append(analyzer)
        return self

    def add_required_analyzers(self, analyzers: Sequence[Analyzer]) -> "VerificationRunBuilder":
        self._required_analyzers.extend(analyzers)
        return self

    def aggregate_with(self, loader: "StateLoader") -> "VerificationRunBuilder":
        self._aggregate_with = loader
        return self

    def save_states_with(self, persister: "StatePersister") -> "VerificationRunBuilder":
        self._save_states_with = persister
        return self

    def with_state_repository(self, repository, dataset: str = "default") -> "VerificationRunBuilder":
        """Persist and reuse per-partition analyzer states across runs:
        over a partitioned source (`Table.scan_parquet_dataset`) the scan
        loads the cached states of unchanged partitions and scans only new
        or changed ones, with the bits of a full rescan. `dataset`
        namespaces the entries."""
        self._state_repository = repository
        self._dataset_name = dataset
        return self

    def use_repository(self, repository: "MetricsRepository") -> "VerificationRunBuilder":
        """reference: VerificationRunBuilder.scala:114-117 — unlocks the
        repository-backed options below."""
        self._metrics_repository = repository
        return self

    def reuse_existing_results_for_key(
        self, key: "ResultKey", fail_if_results_missing: bool = False
    ) -> "VerificationRunBuilder":
        self._reuse_key = key
        self._fail_if_results_missing = fail_if_results_missing
        return self

    def save_or_append_result(self, key: "ResultKey") -> "VerificationRunBuilder":
        self._save_key = key
        return self

    def add_anomaly_check(
        self,
        anomaly_detection_strategy,
        analyzer: Analyzer,
        anomaly_check_config: Optional[AnomalyCheckConfig] = None,
    ) -> "VerificationRunBuilder":
        """reference: VerificationRunBuilder.scala:194-210. The check reads
        the metric's history from the repository of `use_repository`,
        which the run saves to only after evaluating its checks, so the
        history holds earlier runs alone."""
        if self._metrics_repository is None:
            raise ValueError(
                "addAnomalyCheck requires a repository — call use_repository first"
            )
        config = anomaly_check_config or AnomalyCheckConfig(
            CheckLevel.WARNING,
            f"Anomaly check for {analyzer!r}",
        )
        check = Check(config.level, config.description).is_newest_point_non_anomalous(
            self._metrics_repository,
            anomaly_detection_strategy,
            analyzer,
            config.with_tag_values,
            config.after_date,
            config.before_date,
        )
        self._checks.append(check)
        return self

    def save_check_results_json_to_path(self, path: str) -> "VerificationRunBuilder":
        """reference: VerificationRunBuilder.scala:226-231."""
        self._save_check_results_json_path = path
        return self

    def save_success_metrics_json_to_path(self, path: str) -> "VerificationRunBuilder":
        """reference: VerificationRunBuilder.scala:239-244."""
        self._save_success_metrics_json_path = path
        return self

    def overwrite_output_files(self, value: bool) -> "VerificationRunBuilder":
        """Whether previous files with identical names should be
        overwritten (reference: VerificationRunBuilder.scala:253-256 —
        where the reference's self-assignment bug makes the option a
        no-op; here it works)."""
        self._overwrite_output_files = value
        return self

    def run(self) -> VerificationResult:
        result = VerificationSuite.do_verification_run(
            self._data,
            self._checks,
            self._required_analyzers,
            self._device,
            aggregate_with=self._aggregate_with,
            save_states_with=self._save_states_with,
            metrics_repository=self._metrics_repository,
            reuse_existing_results_for_key=self._reuse_key,
            fail_if_results_missing=self._fail_if_results_missing,
            save_or_append_results_with_key=self._save_key,
            state_repository=self._state_repository,
            dataset_name=self._dataset_name,
            controller=self._controller,
            deadline_s=self._deadline_s,
            engine=self._engine,
            mesh=self._mesh,
            validation=self._validation,
            tracing=self._tracing,
            forensics=self._forensics,
            forensics_max_samples=self._forensics_max_samples,
        )
        # JSON file outputs (reference: VerificationSuite.scala:146-172)
        from deequ_tpu_torch.core.fileio import write_text_output

        if self._save_check_results_json_path is not None:
            write_text_output(
                self._save_check_results_json_path,
                result.check_results_as_json(),
                self._overwrite_output_files,
            )
        if self._save_success_metrics_json_path is not None:
            write_text_output(
                self._save_success_metrics_json_path,
                result.success_metrics_as_json(),
                self._overwrite_output_files,
            )
        return result
