"""AnalysisRunner: the scheduler of the metrics engine.

Pipeline (reference: runners/AnalysisRunner.scala:98-193):
  1. deduplicate the analyzers and skip those whose metrics already
     exist in the metrics repository,
  2. partition out analyzers with failing preconditions -> failure metrics,
  3. run every scan-shareable analyzer in ONE fused device pass; an
     analyzer that is not shareable (Histogram) computes alone,
  4. run one frequency pass per grouping-column set (grouping_runner),
  5. turn the folded states into metrics, merging in and saving states
     where a state loader or persister is given,
  6. merge with the reused results and save to the metrics repository.

`data` is an in-memory Table or a streamed source (data/source.py). Over
a partitioned source a state repository (repository/states.py) lets a
partition load its states instead of being scanned.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence

from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers.base import Analyzer, Preconditions, ScanShareableAnalyzer
from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer
from deequ_tpu_torch.core.metrics import Metric
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.ops.fused import FusedScanPass
from deequ_tpu_torch.runners.context import AnalyzerContext
from deequ_tpu_torch.runners.grouping_runner import run_grouping_analyzers

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.state_provider import StateLoader, StatePersister
    from deequ_tpu_torch.repository.base import MetricsRepository, ResultKey


class AnalysisRunner:
    @staticmethod
    def on_data(table: Table, device: runtime.DeviceLike = None) -> "AnalysisRunBuilder":
        """A run over `table` (a Table or a streamed source) on `device`
        (CUDA unless the caller asks for the CPU with ``device="cpu"``)."""
        from deequ_tpu_torch.runners.analysis_run_builder import AnalysisRunBuilder

        return AnalysisRunBuilder(table, device)

    @staticmethod
    def do_analysis_run(
        data: Table,
        analyzers: Sequence[Analyzer],
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
        engine: str = "auto",
        mesh=None,
        validation: Optional[str] = None,
        tracing=None,
        forensics=None,
    ) -> AnalyzerContext:
        """`controller` (core/controller.RunController) is checked at every
        batch and partition boundary of the fused pass. `state_repository`
        (repository/states.StateRepository) caches the states of each
        partition of a partitioned source under `dataset_name`. `engine`
        and `mesh` pick the single-device pass or the mesh-sharded one
        (runners/engine.py); the mesh pass never uses a state cache.
        `validation` is the static pass's mode (lint/planlint.py:
        "strict", "lenient" or "off"; default ``DEEQU_TPU_VALIDATE``, else
        "lenient"): its diagnostics land on the context as
        `validation_warnings` and its cost prediction as `plan_cost`.
        `tracing` is True, False, a trace file's path or None (then
        ``DEEQU_TPU_TRACE`` decides); the finished trace attaches as
        `run_trace`, a subtree of the suite's under a traced verification
        run. `forensics` is a verification run's
        observe/forensics.ForensicsCapture, which the single-device pass
        feeds (the mesh pass has none)."""
        if not analyzers:
            return AnalyzerContext.empty()
        with observe.traced_run("analysis_run", enable=tracing, analyzers=len(analyzers)) as run:
            context = AnalysisRunner._do_analysis_run(
                data, analyzers, device, aggregate_with, save_states_with, metrics_repository,
                reuse_existing_results_for_key, fail_if_results_missing,
                save_or_append_results_with_key, state_repository, dataset_name, controller,
                engine, mesh, validation, forensics,
            )
        if run:
            context.run_trace = run.trace
        return context

    @staticmethod
    def _do_analysis_run(
        data, analyzers, device, aggregate_with, save_states_with, metrics_repository,
        reuse_existing_results_for_key, fail_if_results_missing,
        save_or_append_results_with_key, state_repository, dataset_name, controller,
        engine, mesh, validation, forensics,
    ) -> AnalyzerContext:
        device = runtime.resolve_device(device)
        state_cache = None
        if state_repository is not None and getattr(data, "partitions", None) is not None:
            from deequ_tpu_torch.repository.states import StateCacheContext

            state_cache = StateCacheContext(state_repository, dataset_name)
        # plan-time static analysis: strict raises before any scan
        with observe.span("plan_validate", cat="plan"):
            validation_diagnostics, plan_cost = AnalysisRunner._validate_plan(
                data, analyzers, validation, state_cache, device
            )
        from deequ_tpu_torch.runners.engine import resolve_engine

        mesh = resolve_engine(engine, mesh, num_rows=data.num_rows, device=device)

        seen = set()
        unique: List[Analyzer] = []
        for a in analyzers:
            if a not in seen:
                seen.add(a)
                unique.append(a)

        # repository reuse (reference: AnalysisRunner.scala:116-135)
        reused = AnalyzerContext.empty()
        if metrics_repository is not None and reuse_existing_results_for_key is not None:
            existing = metrics_repository.load_by_key(reuse_existing_results_for_key)
            if existing is not None:
                reused = AnalyzerContext(
                    {a: existing.metric_map[a] for a in unique if a in existing.metric_map}
                )
            if fail_if_results_missing:
                # internal (profiler pass-fusion) analyzers are never
                # repository-backed; their absence is not "missing"
                missing = [
                    a
                    for a in unique
                    if a not in reused.metric_map and not getattr(a, "internal", False)
                ]
                if missing:
                    raise RuntimeError(
                        "Could not find all necessary results in the "
                        "MetricsRepository, the calculation of the metrics "
                        f"for these analyzers would be needed: "
                        f"{', '.join(repr(a) for a in missing)}"
                    )
        unique = [a for a in unique if a not in reused.metric_map]

        # preconditions (reference: AnalysisRunner.scala:137-147)
        passed: List[Analyzer] = []
        metrics: Dict[Analyzer, Metric] = {}
        for a in unique:
            err = Preconditions.find_first_failing(data, a.preconditions())
            if err is None:
                passed.append(a)
            else:
                metrics[a] = a.to_failure_metric(err)

        # grouping vs scanning (reference: AnalysisRunner.scala:148-150)
        grouping = [a for a in passed if isinstance(a, GroupingAnalyzer)]
        scanning = [a for a in passed if not isinstance(a, GroupingAnalyzer)]
        shareable = [a for a in scanning if isinstance(a, ScanShareableAnalyzer)]

        # the fused scan pass (reference: AnalysisRunner.scala:279-326)
        if shareable:
            if mesh is not None:
                from deequ_tpu_torch.parallel.distributed import DistributedScanPass

                scan = DistributedScanPass(shareable, mesh=mesh, controller=controller)
            else:
                scan = FusedScanPass(
                    shareable, device=device, controller=controller, state_cache=state_cache,
                    forensics=forensics,
                )
            results = scan.run(data)
            for result in results:
                analyzer = result.analyzer
                if result.error is not None:
                    metrics[analyzer] = analyzer.to_failure_metric(result.error)
                else:
                    metrics[analyzer] = analyzer.calculate_metric(
                        result.state, aggregate_with, save_states_with, device
                    )
        for analyzer in scanning:
            if not isinstance(analyzer, ScanShareableAnalyzer):
                metrics[analyzer] = analyzer.calculate(
                    data, aggregate_with, save_states_with, device=device
                )

        # one frequency pass per grouping-column set
        # (reference: AnalysisRunner.scala:164-180, 249-277)
        context = reused + AnalyzerContext(metrics)
        if grouping:
            context = context + run_grouping_analyzers(
                data, grouping, device, aggregate_with, save_states_with, mesh=mesh
            )

        # save (reference: AnalysisRunner.scala:182-230)
        if metrics_repository is not None and save_or_append_results_with_key is not None:
            AnalysisRunner._save_or_append(
                metrics_repository, save_or_append_results_with_key, context
            )
        context.validation_warnings = validation_diagnostics
        context.plan_cost = plan_cost
        return context

    @staticmethod
    def _validate_plan(data, analyzers, validation, state_cache=None, device=None):
        """-> (diagnostics, PlanCost | None) of the static pass over the
        run (`validate_run_plan`)."""
        return validate_run_plan(data, analyzers, validation, state_cache, device)

    @staticmethod
    def _predict_partitions(data, analyzers, state_cache, device=None):
        """Per-partition cache prediction records for the cost model:
        `{"cached": bool, "bytes": int}` per partition, in partition
        order, from a probe of the state repository with the fingerprint
        and plan signature the fused pass will use (the runner's own
        filtering: dedupe, scan-shareable, not grouping)."""
        import os

        probe = None
        if state_cache is not None and runtime.state_cache_enabled():
            from deequ_tpu_torch.repository.states import plan_signature_for

            seen: set = set()
            shareable = []
            for a in analyzers:
                if a in seen:
                    continue
                seen.add(a)
                if isinstance(a, ScanShareableAnalyzer) and not isinstance(a, GroupingAnalyzer):
                    shareable.append(a)
            probe = plan_signature_for(shareable, data, device=device)
        records = []
        for part in data.partitions():
            cached = bool(
                probe is not None
                and state_cache.repository.has_states(state_cache.dataset, part.fingerprint, probe)
            )
            try:
                nbytes = int(os.path.getsize(part.path))
            except OSError:
                nbytes = 0
            records.append({"cached": cached, "bytes": nbytes})
        return records

    @staticmethod
    def run_on_aggregated_states(
        schema_table: Table,
        analyzers: Sequence[Analyzer],
        state_loaders: Sequence["StateLoader"],
        save_states_with: Optional["StatePersister"] = None,
        metrics_repository: Optional["MetricsRepository"] = None,
        save_or_append_results_with_key: Optional["ResultKey"] = None,
        device: runtime.DeviceLike = None,
    ) -> AnalyzerContext:
        """Metrics purely from merged states, with no scan of data
        (reference: runners/AnalysisRunner.scala:375-446). The frequency
        aggregations run on the resolved `device`."""
        from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider

        device = runtime.resolve_device(device)
        if not analyzers or not state_loaders:
            return AnalyzerContext.empty()

        # precondition check against the schema
        passed: List[Analyzer] = []
        metrics: Dict[Analyzer, Metric] = {}
        for a in analyzers:
            err = Preconditions.find_first_failing(schema_table, a.preconditions())
            if err is None:
                passed.append(a)
            else:
                metrics[a] = a.to_failure_metric(err)

        aggregated = InMemoryStateProvider()
        with observe.span(
            "state_merge", cat="merge", analyzers=len(passed), loaders=len(state_loaders)
        ):
            for analyzer in passed:
                for loader in state_loaders:
                    state = loader.load(analyzer)
                    if state is None:
                        continue
                    existing = aggregated.load(analyzer)
                    aggregated.persist(
                        analyzer, existing.merge(state) if existing is not None else state
                    )

        for analyzer in passed:
            state = aggregated.load(analyzer)
            if save_states_with is not None and state is not None:
                save_states_with.persist(analyzer, state)
            metrics[analyzer] = analyzer.compute_metric_from(state, device)

        context = AnalyzerContext(metrics)
        if metrics_repository is not None and save_or_append_results_with_key is not None:
            AnalysisRunner._save_or_append(
                metrics_repository, save_or_append_results_with_key, context
            )
        return context

    @staticmethod
    def _save_or_append(
        repository: "MetricsRepository",
        key: "ResultKey",
        context: AnalyzerContext,
    ) -> None:
        """Upsert semantics (reference: AnalysisRunner.scala:195-213).
        Internal analyzers (profiler pass-fusion members) never reach the
        repository: their metrics carry raw states and have no serde."""
        context = AnalyzerContext(
            {a: m for a, m in context.metric_map.items() if not getattr(a, "internal", False)}
        )
        existing = repository.load_by_key(key)
        combined = (existing + context) if existing is not None else context
        repository.save(key, combined)


def validate_run_plan(
    data, analyzers, validation, state_cache=None, device=None, checks=(), deadline_s=None
):
    """-> (diagnostics, PlanCost | None) of the static pass over a run of
    `analyzers` and the analyzers of `checks` (a verification run) on
    `device` (lint/planlint.py:validate_plan); ([], None) when it is off.
    A strict-mode error raises PlanValidationError; any other failure of
    the pass leaves the run alone."""
    from deequ_tpu_torch.lint import PlanValidationError, SchemaInfo, validate_plan
    from deequ_tpu_torch.lint.planlint import resolve_validation_mode

    mode = resolve_validation_mode(validation)
    if mode == "off":
        return [], None
    try:
        schema = SchemaInfo.from_table(data)
        streaming = bool(getattr(data, "is_streaming", False))
        cap = getattr(data, "batch_rows", None) if streaming else None
        # a Parquet source's row-group statistics: the cost pass then
        # predicts the pushdown outcome the scan will produce
        row_groups = None
        stats_fn = getattr(data, "row_group_stats", None)
        if stats_fn is not None:
            try:
                row_groups = stats_fn()
            except Exception:  # noqa: BLE001 - statistics are advisory
                row_groups = None
        partitions = None
        if getattr(data, "partitions", None) is not None:
            planned = list(analyzers)
            for check in checks:
                planned.extend(check.required_analyzers())
            partitions = AnalysisRunner._predict_partitions(
                data, planned, state_cache, device
            )
        report = validate_plan(
            schema,
            checks=checks,
            required_analyzers=analyzers,
            mode=mode,
            num_rows=int(data.num_rows),
            streaming=streaming,
            stream_batch_rows=int(cap) if cap else None,
            row_groups=row_groups,
            partitions=partitions,
            device=device,
            deadline_s=deadline_s,
        )
        return list(report.diagnostics), report.plan_cost
    except PlanValidationError:
        raise
    except Exception:  # noqa: BLE001 - lint must never break a run
        return [], None
