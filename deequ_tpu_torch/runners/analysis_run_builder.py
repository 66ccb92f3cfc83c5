"""Fluent builder for analysis runs.

reference: runners/AnalysisRunBuilder.scala:26-186.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.runners.context import AnalyzerContext

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.state_provider import StateLoader, StatePersister
    from deequ_tpu_torch.repository.base import MetricsRepository, ResultKey


class AnalysisRunBuilder:
    def __init__(self, data: Table, device: runtime.DeviceLike = None):
        self._data = data
        self._device = device
        self._analyzers: List[Analyzer] = []
        self._controller = None
        self._deadline_s: Optional[float] = None
        self._aggregate_with = None
        self._save_states_with = None
        self._metrics_repository = None
        self._reuse_key = None
        self._fail_if_results_missing = False
        self._save_key = None
        self._state_repository = None
        self._dataset_name = "default"
        self._engine = "auto"
        self._mesh = None
        self._validation: Optional[str] = None
        self._tracing = None

    def with_engine(self, engine: str, mesh=None) -> "AnalysisRunBuilder":
        """"auto" (a mesh over every CUDA device when there are two or
        more and the table is large), "single", or "distributed" (over
        `mesh`, parallel/distributed.data_mesh), runners/engine.py."""
        self._engine = engine
        self._mesh = mesh
        return self

    def with_plan_validation(self, mode: str) -> "AnalysisRunBuilder":
        """Plan-time static analysis mode: "strict" raises one aggregated
        PlanValidationError before any scan, "lenient" (default) attaches
        diagnostics to the context, "off" skips the pass."""
        self._validation = mode
        return self

    def explain(self, **kwargs):
        """EXPLAIN the planned run without scanning a row: the static
        cost/effect prediction (passes, batches, wire bytes, family
        groups) plus DQ3xx performance diagnostics, as an
        `ExplainResult` (render with `str(...)`), on the run's device."""
        from deequ_tpu_torch.lint.explain import explain_plan

        if self._deadline_s is not None:
            kwargs.setdefault("deadline_s", self._deadline_s)
        kwargs.setdefault("device", self._device)
        return explain_plan(self._data, analyzers=self._analyzers, **kwargs)

    def with_tracing(self, trace=True) -> "AnalysisRunBuilder":
        """Run observability (observe/): True records the run's span tree
        as `context.run_trace`; a path also writes its Chrome-trace JSON
        there (load it in Perfetto); False turns tracing off whatever
        ``DEEQU_TPU_TRACE`` says."""
        self._tracing = trace
        return self

    def with_controller(self, controller) -> "AnalysisRunBuilder":
        """Attach a `RunController` (core/controller.py) whose `cancel()`
        any thread may call: the run raises `RunCancelled` at its next
        batch or partition boundary, after every stage thread joined."""
        self._controller = controller
        return self

    def with_deadline(self, seconds: float) -> "AnalysisRunBuilder":
        """Bound the run's wall time: past `seconds` the next batch check
        raises `RunCancelled` (DQ402)."""
        self._deadline_s = float(seconds)
        return self

    def add_analyzer(self, analyzer: Analyzer) -> "AnalysisRunBuilder":
        self._analyzers.append(analyzer)
        return self

    def add_analyzers(self, analyzers: Sequence[Analyzer]) -> "AnalysisRunBuilder":
        self._analyzers.extend(analyzers)
        return self

    def aggregate_with(self, loader: "StateLoader") -> "AnalysisRunBuilder":
        self._aggregate_with = loader
        return self

    def save_states_with(self, persister: "StatePersister") -> "AnalysisRunBuilder":
        self._save_states_with = persister
        return self

    def with_state_repository(self, repository, dataset: str = "default") -> "AnalysisRunBuilder":
        """Attach a partition-state cache (repository/states.py). Over a
        partitioned source (`Table.scan_parquet_dataset`), a partition
        whose fingerprint and plan signature already have stored states
        loads them instead of being scanned, and a newly scanned one
        saves its states: a rerun costs its new partitions and gives the
        bits of a full rescan. `dataset` namespaces the entries;
        ``DEEQU_TPU_STATE_CACHE=0`` turns the cache off."""
        self._state_repository = repository
        self._dataset_name = dataset
        return self

    def use_repository(self, repository: "MetricsRepository") -> "AnalysisRunBuilder":
        self._metrics_repository = repository
        return self

    def reuse_existing_results_for_key(
        self, key: "ResultKey", fail_if_results_missing: bool = False
    ) -> "AnalysisRunBuilder":
        self._reuse_key = key
        self._fail_if_results_missing = fail_if_results_missing
        return self

    def save_or_append_result(self, key: "ResultKey") -> "AnalysisRunBuilder":
        self._save_key = key
        return self

    def run(self) -> AnalyzerContext:
        from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

        controller = self._controller
        if controller is None and self._deadline_s is not None:
            from deequ_tpu_torch.core.controller import RunController

            controller = RunController(deadline_s=self._deadline_s)
        return AnalysisRunner.do_analysis_run(
            self._data,
            self._analyzers,
            self._device,
            aggregate_with=self._aggregate_with,
            save_states_with=self._save_states_with,
            metrics_repository=self._metrics_repository,
            reuse_existing_results_for_key=self._reuse_key,
            fail_if_results_missing=self._fail_if_results_missing,
            save_or_append_results_with_key=self._save_key,
            state_repository=self._state_repository,
            dataset_name=self._dataset_name,
            controller=controller,
            engine=self._engine,
            mesh=self._mesh,
            validation=self._validation,
            tracing=self._tracing,
        )
