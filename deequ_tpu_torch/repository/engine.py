"""Engine telemetry as first-class repository citizens.

The paper's product loop persists data-quality metrics through a
`MetricsRepository` and watches the resulting time series with anomaly
detection.  This module applies the identical machinery to the engine's
own health: each flat record from `observe.telemetry.engine_metric_record`
becomes an `AnalyzerContext` keyed by `EngineMetric` pseudo-analyzers
and is saved under a `ResultKey` tagged `telemetry=engine` (plus suite,
dataset, host, placement) — so one store holds both kinds of series,
the same loaders filter both, and `tools/sentinel.py` runs the same
anomaly strategies over both.
"""

from __future__ import annotations

import socket
import time
from typing import TYPE_CHECKING, Any, Dict, List, Optional

from deequ_tpu_torch.analyzers.base import Analyzer
from deequ_tpu_torch.core.maybe import Success
from deequ_tpu_torch.core.metrics import DoubleMetric, Entity
from deequ_tpu_torch.repository.base import MetricsRepository, ResultKey
from deequ_tpu_torch.runners.context import AnalyzerContext

if TYPE_CHECKING:  # pragma: no cover
    from deequ_tpu_torch.anomaly import DataPoint

__all__ = [
    "ENGINE_TELEMETRY_TAG",
    "ENGINE_TELEMETRY_VALUE",
    "EngineMetric",
    "engine_metric_names",
    "engine_result_key",
    "engine_series",
    "persist_engine_record",
    "record_run",
    "record_window_run",
]

ENGINE_TELEMETRY_TAG = "telemetry"
ENGINE_TELEMETRY_VALUE = "engine"


class EngineMetric(Analyzer):
    """Pseudo-analyzer keying one engine health metric in a repository.

    Never runs against data — it exists so engine series ride the
    ordinary `AnalyzerContext`/`MetricsRepository` path (save, load,
    filter, serde) with analyzer identity `(metric, instance)`.
    """

    def __init__(self, metric: str, instance: str = "engine"):
        self.metric = str(metric)
        self._instance = str(instance)

    @property
    def name(self) -> str:
        return self.metric

    @property
    def instance(self) -> str:
        return self._instance

    @property
    def entity(self) -> Entity:
        return Entity.DATASET

    def compute_state_from(self, table: Any) -> Any:
        raise NotImplementedError(
            "EngineMetric is a telemetry key, not a data analyzer."
        )

    def to_metric(self, value: float) -> DoubleMetric:
        return DoubleMetric(
            self.entity, self.name, self.instance, Success(float(value))
        )

    def __repr__(self) -> str:
        return f"EngineMetric(metric={self.metric!r}, instance={self._instance!r})"


def _placement_tag() -> str:
    try:
        from deequ_tpu_torch.ops import runtime

        return str(runtime.placement_mode())
    except Exception:
        return "unknown"


def engine_result_key(
    data_set_date: Optional[int] = None,
    *,
    suite: str,
    dataset: str,
    tags: Optional[Dict[str, str]] = None,
) -> ResultKey:
    """ResultKey for one engine telemetry point.

    `data_set_date` defaults to now (epoch milliseconds, the repository
    convention); standard tags are telemetry=engine, suite, dataset,
    host, placement — extra `tags` may add to or override them.
    """
    if data_set_date is None:
        data_set_date = int(time.time() * 1000)
    try:
        host = socket.gethostname() or "unknown"
    except OSError:
        host = "unknown"
    all_tags = {
        ENGINE_TELEMETRY_TAG: ENGINE_TELEMETRY_VALUE,
        "suite": str(suite),
        "dataset": str(dataset),
        "host": host,
        "placement": _placement_tag(),
    }
    if tags:
        all_tags.update({str(k): str(v) for k, v in tags.items()})
    return ResultKey(data_set_date, all_tags)


def persist_engine_record(
    repository: MetricsRepository,
    record: Dict[str, float],
    key: ResultKey,
    *,
    instance: str = "engine",
) -> AnalyzerContext:
    """Save one flat engine metric record under `key`; returns the context."""
    metric_map: Dict[Analyzer, DoubleMetric] = {}
    for name, value in record.items():
        try:
            fval = float(value)
        except (TypeError, ValueError):
            continue
        analyzer = EngineMetric(name, instance)
        metric_map[analyzer] = analyzer.to_metric(fval)
    context = AnalyzerContext(metric_map)
    repository.save(key, context)
    return context


def record_run(
    repository: MetricsRepository,
    trace: Any,
    plan_cost: Any = None,
    *,
    suite: str,
    dataset: str,
    data_set_date: Optional[int] = None,
    tags: Optional[Dict[str, str]] = None,
    instance: str = "engine",
    extra: Optional[Dict[str, float]] = None,
) -> ResultKey:
    """Derive the engine record from a RunTrace (+ optional PlanCost)
    and persist it as one time-series point; returns the key used."""
    from deequ_tpu_torch.observe import telemetry

    record = telemetry.engine_metric_record(trace, plan_cost, extra=extra)
    key = engine_result_key(
        data_set_date, suite=suite, dataset=dataset, tags=tags
    )
    persist_engine_record(repository, record, key, instance=instance)
    return key


def record_window_run(
    repository: MetricsRepository,
    trace: Any,
    drift_result: Any = None,
    plan_cost: Any = None,
    *,
    suite: str,
    dataset: str,
    data_set_date: Optional[int] = None,
    tags: Optional[Dict[str, str]] = None,
    instance: str = "engine",
) -> ResultKey:
    """`record_run` for a window query + optional drift evaluation: the
    trace contributes the `engine.window.*` counters (and the derived
    `engine.window.segment_hit_ratio`), and a `DriftCheckResult` adds
    `engine.drift.value_max` (the worst drift measure observed) and
    `engine.drift.failed_constraints` — the two series the sentinel
    watches for a drifting dataset."""
    extra: Dict[str, float] = {}
    if drift_result is not None:
        values = [
            float(r.value)
            for r in drift_result.constraint_results
            if r.value is not None and r.value == r.value
        ]
        finite = [v for v in values if v != float("inf")]
        if finite:
            extra["engine.drift.value_max"] = max(finite)
        extra["engine.drift.failed_constraints"] = float(
            sum(
                1
                for r in drift_result.constraint_results
                if getattr(r.status, "name", "") != "SUCCESS"
            )
        )
    return record_run(
        repository,
        trace,
        plan_cost,
        suite=suite,
        dataset=dataset,
        data_set_date=data_set_date,
        tags=tags,
        instance=instance,
        extra=extra or None,
    )


def _engine_results(
    repository: MetricsRepository, tags: Optional[Dict[str, str]]
) -> List[Any]:
    loader = repository.load().with_tag_values(
        {ENGINE_TELEMETRY_TAG: ENGINE_TELEMETRY_VALUE, **(tags or {})}
    )
    return list(loader.get())


def engine_series(
    repository: MetricsRepository,
    metric: str,
    *,
    instance: str = "engine",
    tags: Optional[Dict[str, str]] = None,
) -> List["DataPoint"]:
    """Load one engine metric's time series (sorted by data_set_date),
    ready for `AnomalyDetector.detect_anomalies_in_history`."""
    from deequ_tpu_torch.anomaly import DataPoint  # lazy: pulls in torch via HoltWinters

    analyzer = EngineMetric(metric, instance)
    points: List[DataPoint] = []
    for result in _engine_results(repository, tags):
        found = result.analyzer_context.metric_map.get(analyzer)
        if found is not None and found.value.is_success:
            points.append(
                DataPoint(result.result_key.data_set_date, float(found.value.get()))
            )
    points.sort(key=lambda p: p.time)
    return points


def engine_metric_names(
    repository: MetricsRepository,
    *,
    tags: Optional[Dict[str, str]] = None,
) -> List[str]:
    """All engine metric names present in the repository (sorted)."""
    names = set()
    for result in _engine_results(repository, tags):
        for analyzer in result.analyzer_context.metric_map:
            if isinstance(analyzer, EngineMetric):
                names.add(analyzer.metric)
    return sorted(names)
