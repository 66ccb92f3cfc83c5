"""Engine telemetry: flat metric records, /proc resources, OpenMetrics.

The paper's product loop stores *data-quality* metrics in a repository
and runs anomaly detection over the resulting time series.  This module
turns the *engine's own health* into the same shape: a traced run (plus
its optional PlanCost prediction) flattens into one `Dict[str, float]`
record — throughput, per-phase seconds, exact wire bytes, pipeline
stage occupancy, peak RSS, predicted-vs-observed drift — that
`deequ_tpu_torch.repository.engine` persists through the ordinary
`MetricsRepository`, so one store holds both kinds of series and one
anomaly stack (tools/sentinel.py) watches both.

Also here: an OpenMetrics / Prometheus text exporter over repository
results, ready for a future service layer to scrape.

Design constraints (same as the rest of `observe/`): no deequ_tpu
dependencies outside this package at import time — the repository and
lint layers are imported lazily inside functions, so `observe` stays
importable from every engine layer without cycles.
"""

from __future__ import annotations

import math
import re
import resource
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from deequ_tpu_torch.observe import report

__all__ = [
    "ENGINE_PREFIX",
    "SERVICE_PREFIX",
    "engine_metric_record",
    "latest_results",
    "openmetrics_text",
    "proc_resources",
    "service_metric_record",
]

#: every key in an engine metric record starts with this prefix, which is
#: what lets the exporter and the sentinel tell engine series apart from
#: data-quality metrics sharing the same repository.
ENGINE_PREFIX = "engine."

#: the fleet-service slice of the engine namespace: queue depths,
#: admit/reject/shed/preempt counters, per-tenant scan bytes, breaker
#: state — produced by `deequ_tpu_torch.service.telemetry` and consumed by the
#: same exporter/sentinel stack as any other `engine.` series.
SERVICE_PREFIX = ENGINE_PREFIX + "service."

#: span names whose `rows`/`batches` attributes count scanned work.
_SCAN_SPANS = ("fused_scan", "dist_scan")


def service_metric_record(values: Dict[str, Any]) -> Dict[str, float]:
    """Normalize a raw service-counter dict into an engine record.

    Keys gain the `engine.service.` prefix when they carry neither it
    nor the bare `engine.` prefix, and every value is coerced to float
    (non-finite values are dropped — repositories store finite floats),
    so ad-hoc dicts from operators' scripts and the `ServiceTelemetry`
    snapshot land in the repository in the same shape.
    """
    rec: Dict[str, float] = {}
    for key, value in values.items():
        name = key if key.startswith(ENGINE_PREFIX) else SERVICE_PREFIX + key
        try:
            v = float(value)
        except (TypeError, ValueError):
            continue
        if math.isfinite(v):
            rec[name] = v
    return rec


# ---------------------------------------------------------------------------
# /proc resource accounting (no psutil dependency)
# ---------------------------------------------------------------------------


def proc_resources() -> Dict[str, float]:
    """Peak RSS (MB) and cumulative major page faults for this process.

    Reads `/proc/self/status` (VmHWM) and `/proc/self/stat` (majflt,
    field 12); falls back to `resource.getrusage` where /proc is absent
    so callers never need an external measurement tool.
    """
    out: Dict[str, float] = {}
    try:
        with open("/proc/self/status", encoding="ascii") as fh:
            for line in fh:
                if line.startswith("VmHWM:"):
                    out["peak_rss_mb"] = float(line.split()[1]) / 1024.0
                    break
    except (OSError, ValueError, IndexError):
        pass
    try:
        with open("/proc/self/stat", encoding="ascii") as fh:
            # comm may contain spaces/parens: split after the closing paren,
            # which leaves state at index 0 and majflt (field 12) at index 9.
            tail = fh.read().rsplit(")", 1)[1].split()
        out["major_faults"] = float(int(tail[9]))
    except (OSError, ValueError, IndexError):
        pass
    if "peak_rss_mb" not in out or "major_faults" not in out:
        usage = resource.getrusage(resource.RUSAGE_SELF)
        # linux reports ru_maxrss in KB
        out.setdefault("peak_rss_mb", usage.ru_maxrss / 1024.0)
        out.setdefault("major_faults", float(usage.ru_majflt))
    return out


# ---------------------------------------------------------------------------
# flat engine metric record
# ---------------------------------------------------------------------------


def engine_metric_record(
    trace: Any,
    plan_cost: Any = None,
    *,
    extra: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Flatten a RunTrace (and optional PlanCost) into one metric record.

    Keys are `engine.`-prefixed floats: wall/CPU seconds, scanned
    rows/batches and rows/s, summed dispatch wire bytes, disjoint
    per-phase self seconds, per-stage pipeline occupancy, trace
    counters, peak RSS / major faults, and — when `plan_cost` is given —
    `engine.drift.*` predicted-vs-observed deltas per PlanCost field
    (see `deequ_tpu_torch.lint.cost.cost_drift`).
    """
    root = trace.root
    wall = float(trace.duration_s)
    rec: Dict[str, float] = {
        "engine.wall_s": wall,
        "engine.cpu_s": float(root.cpu_s),
    }

    rows = 0
    batches = 0
    saw_scan = False
    wire = 0
    saw_wire = False
    for sp in trace.spans():
        if sp.name in _SCAN_SPANS:
            attrs = sp.attrs
            if "rows" in attrs or "batches" in attrs:
                rows += int(attrs.get("rows", 0))
                batches += int(attrs.get("batches", 0))
                saw_scan = True
        elif sp.name == "dispatch" and "wire_bytes" in sp.attrs:
            wire += int(sp.attrs["wire_bytes"])
            saw_wire = True
    if saw_scan:
        rec["engine.rows"] = float(rows)
        rec["engine.batches"] = float(batches)
        if wall > 0.0:
            rec["engine.rows_per_s"] = rows / wall
    if saw_wire:
        rec["engine.wire_bytes"] = float(wire)

    for phase, secs in trace.phase_seconds().items():
        if secs > 0.0 or phase in report.PHASES:
            rec[f"engine.phase.{phase}_s"] = float(secs)

    for row in report.pipeline_occupancy([root]):
        stage = str(row["stage"])
        rec[f"engine.pipeline.{stage}.occupancy"] = float(row["occupancy"])
        rec[f"engine.pipeline.{stage}.busy_s"] = float(row["busy_s"])
        rec[f"engine.pipeline.{stage}.stall_s"] = float(row["stall_s"])

    for key, value in trace.counters.items():
        if isinstance(value, (int, float)):
            rec[f"engine.counter.{key}"] = float(value)

    # derived: fraction of parquet row groups the pushdown analyzer
    # skipped this run (the sentinel watches it for prune-effectiveness
    # regressions); only present when a prune decision actually ran
    rg_total = rec.get("engine.counter.rg_total", 0.0)
    if rg_total > 0.0:
        rec["engine.rg_skipped_ratio"] = (
            rec.get("engine.counter.rg_skipped", 0.0) / rg_total
        )

    # derived: fraction of scanned columns the buffer-level native
    # decode took, and the per-scan average worker count (exact when
    # every scan ran the same pool size) — the sentinel watches both for
    # decode-fast-path regressions; only present when a decode plan ran
    decode_total = rec.get("engine.counter.decode_cols_total", 0.0)
    if decode_total > 0.0:
        rec["engine.decode_fastpath_ratio"] = (
            rec.get("engine.counter.decode_cols_fast", 0.0) / decode_total
        )
    decode_passes = rec.get("engine.counter.decode_passes", 0.0)
    if decode_passes > 0.0:
        rec["engine.decode_workers"] = (
            rec.get("engine.counter.decode_workers", 0.0) / decode_passes
        )

    # derived: fraction of scanned columns decoded STRAIGHT to the wire
    # (decode-to-wire fusion) — the sentinel watches it for fall-off
    # regressions; only present when a wire verdict actually ran
    wire_total = rec.get("engine.counter.wire_cols_total", 0.0)
    if wire_total > 0.0:
        rec["engine.wire_fused_ratio"] = (
            rec.get("engine.counter.wire_fused_cols", 0.0) / wire_total
        )

    # derived: fraction of fast-path column-chunks the native parquet
    # page reader decoded (page bytes straight to arrow layout, no
    # pyarrow materialization) — the sentinel watches it for reader
    # fall-off regressions; only present when a reader verdict ran
    reader_total = rec.get("engine.counter.reader_chunks_total", 0.0)
    if reader_total > 0.0:
        rec["engine.reader_native_ratio"] = (
            rec.get("engine.counter.reader_chunks_native", 0.0) / reader_total
        )

    # derived: encoded-fold health. run_ratio = logical values folded
    # per (run, code) entry — the compression the fold exploited (the
    # sentinel watches it dropping toward 1.0: the data stopped
    # run-compressing and the fold stopped paying). fallback_ratio =
    # chunks that failed closed to the row-width path out of planned
    # run-fold chunks plus fallbacks (watched rising: pages stopped
    # being all-dictionary at decode). codes_folded / bytes_saved =
    # dictionary codes rolled up to engine values and row-width bytes
    # never materialized (watched dropping). Only present when an
    # encoded-fold chunk actually decoded.
    enc_chunks = rec.get("engine.counter.encfold_chunks", 0.0)
    enc_fallback = rec.get("engine.counter.encfold_chunks_fallback", 0.0)
    if enc_chunks > 0.0 or enc_fallback > 0.0:
        enc_runs = rec.get("engine.counter.encfold_runs", 0.0)
        if enc_runs > 0.0:
            rec["engine.encfold.run_ratio"] = (
                rec.get("engine.counter.encfold_values", 0.0) / enc_runs
            )
        rec["engine.encfold.fallback_ratio"] = enc_fallback / (
            enc_chunks + enc_fallback
        )
        rec["engine.encfold.codes_folded"] = rec.get(
            "engine.counter.encfold_codes_folded", 0.0
        )
        rec["engine.encfold.bytes_saved"] = rec.get(
            "engine.counter.encfold_bytes_saved", 0.0
        )

    # derived: fraction of dataset partitions whose analyzer states
    # loaded from the persistent state cache instead of scanning — the
    # sentinel watches it for incremental-scan regressions; only present
    # when a partitioned run actually split cached vs scanned
    partitions_total = rec.get("engine.counter.partitions_total", 0.0)
    if partitions_total > 0.0:
        rec["engine.state_cache_hit_ratio"] = (
            rec.get("engine.counter.partitions_cached", 0.0) / partitions_total
        )

    # derived: fraction of a window query's cover spans answered by a
    # precomputed segment envelope (the rest rebuilt from per-partition
    # states) — the sentinel watches it collapsing, which means segment
    # publication broke or churn outruns the covers; only present when
    # a window query actually resolved spans
    window_spans = rec.get("engine.counter.window.spans", 0.0)
    if window_spans > 0.0:
        rec["engine.window.segment_hit_ratio"] = (
            rec.get("engine.counter.window.segment_hits", 0.0) / window_spans
        )

    # derived: fraction of fused-fn lookups that found their plan
    # *shape* already compiled (the jit/fuse cost paid once per shape
    # fleet-wide) — the sentinel watches it dropping; only present when
    # a fused-fn lookup actually ran
    plan_lookups = rec.get("engine.counter.plan_cache.lookups", 0.0)
    if plan_lookups > 0.0:
        rec["engine.plan_cache_hit_ratio"] = (
            rec.get("engine.counter.plan_cache.hits", 0.0) / plan_lookups
        )

    # derived: fraction of retried transient-IO operations that
    # recovered within the retry budget (the rest degraded to the
    # pyarrow fallback) — the sentinel watches it dropping; only present
    # when a retry outcome was actually recorded
    retried = rec.get("engine.counter.retry.recovered", 0.0) + rec.get(
        "engine.counter.retry.exhausted", 0.0
    )
    if retried > 0.0:
        rec["engine.retry.recovery_ratio"] = (
            rec.get("engine.counter.retry.recovered", 0.0) / retried
        )

    # derived: fraction of observed faults that cost a unit its native
    # decode (degraded to the pyarrow fallback) — the sentinel watches
    # it rising; only present when a fault was actually observed
    faults = rec.get("engine.counter.fault.observed", 0.0)
    if faults > 0.0:
        rec["engine.fault.fallback_ratio"] = (
            rec.get("engine.counter.fault.fallback_units", 0.0) / faults
        )

    # derived: sharded-scan health (one record per participating
    # process). skew_ratio = this mesh's largest shard vs the even
    # split (1.0 = perfectly balanced; the sentinel watches it rising),
    # rows_per_s = THIS shard's fold throughput (watched dropping),
    # merge_bytes = gathered state-envelope bytes that crossed the
    # process boundary (watched rising — states, never rows, so this
    # should stay KB-scale). Only present when a sharded scan ran.
    shard_count = rec.get("engine.counter.shard.count", 0.0)
    if shard_count > 0.0:
        shard_total = rec.get("engine.counter.shard.partitions_total", 0.0)
        if shard_total > 0.0:
            rec["engine.shard.skew_ratio"] = rec.get(
                "engine.counter.shard.partitions_max", 0.0
            ) / (shard_total / shard_count)
        rec["engine.shard.merge_bytes"] = rec.get(
            "engine.counter.shard.merge_bytes", 0.0
        )
        if wall > 0.0:
            rec["engine.shard.rows_per_s"] = (
                rec.get("engine.counter.shard.rows_local", 0.0) / wall
            )

    # traced_run stamps these on the root span; live /proc read
    # covers traces produced before the attributes existed.
    res = proc_resources()
    rec["engine.peak_rss_mb"] = float(root.attrs.get("peak_rss_mb", res.get("peak_rss_mb", 0.0)))
    rec["engine.major_faults"] = float(root.attrs.get("major_faults", res.get("major_faults", 0.0)))

    if plan_cost is not None:
        from deequ_tpu_torch.lint.cost import cost_drift  # lazy: observe must not need lint at import

        for key, value in cost_drift(plan_cost, trace).items():
            rec[f"engine.{key}"] = float(value)

    if extra:
        for key, value in extra.items():
            name = key if key.startswith(ENGINE_PREFIX) else ENGINE_PREFIX + key
            rec[name] = float(value)
    return rec


# ---------------------------------------------------------------------------
# OpenMetrics / Prometheus exposition
# ---------------------------------------------------------------------------

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")
_LABEL_OK = re.compile(r"[^a-zA-Z0-9_]")


def _metric_name(prefix: str, raw: str) -> str:
    name = _NAME_OK.sub("_", f"{prefix}_{raw}")
    if name[:1].isdigit():
        name = "_" + name
    return name


def _label_name(raw: str) -> str:
    name = _LABEL_OK.sub("_", raw)
    if not name or name[:1].isdigit():
        name = "_" + name
    return name


def _escape(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_str(labels: Sequence[Tuple[str, str]]) -> str:
    if not labels:
        return ""
    body = ",".join(f'{_label_name(k)}="{_escape(str(v))}"' for k, v in labels)
    return "{" + body + "}"


def latest_results(results: Iterable[Any]) -> List[Any]:
    """Keep the newest result per distinct tag set (by data_set_date).

    OpenMetrics forbids duplicate label sets within a family, so a
    scrape exposes the *latest* point of each series; history stays in
    the repository for the sentinel.
    """
    by_tags: Dict[Tuple[Tuple[str, str], ...], Any] = {}
    for res in results:
        key = tuple(sorted(res.result_key.tags.items()))
        cur = by_tags.get(key)
        if cur is None or res.result_key.data_set_date >= cur.result_key.data_set_date:
            by_tags[key] = res
    return [by_tags[key] for key in sorted(by_tags)]


def openmetrics_text(results: Iterable[Any], *, prefix: str = "deequ_tpu") -> str:
    """Render repository results as OpenMetrics exposition text.

    Engine telemetry metrics (names under `engine.`) become one gauge
    family each (`<prefix>_engine_rows_per_s{...}`); data-quality
    metrics share a single `<prefix>_metric` family labelled by
    metric/instance/entity.  Result-key tags become labels on every
    sample.  Failed and non-finite metric values are skipped.  Output
    ends with the mandatory `# EOF` terminator.
    """
    families: Dict[str, List[str]] = {}
    seen: set = set()

    def _emit(family: str, labels: List[Tuple[str, str]], value: float) -> None:
        if not math.isfinite(value):
            return
        label_str = _label_str(labels)
        dedupe = (family, label_str)
        if dedupe in seen:
            return
        seen.add(dedupe)
        families.setdefault(family, []).append(f"{family}{label_str} {value!r}")

    dq_family = _metric_name(prefix, "metric")
    for res in latest_results(results):
        tags = sorted(res.result_key.tags.items())
        for metric in res.analyzer_context.metric_map.values():
            for flat in metric.flatten():
                if not flat.value.is_success:
                    continue
                try:
                    value = float(flat.value.get())
                except (TypeError, ValueError):
                    continue
                if flat.name.startswith(ENGINE_PREFIX):
                    family = _metric_name(prefix, flat.name.replace(".", "_"))
                    labels = [("instance", flat.instance)] + list(tags)
                else:
                    family = dq_family
                    labels = [
                        ("metric", flat.name),
                        ("instance", flat.instance),
                        ("entity", getattr(flat.entity, "value", str(flat.entity))),
                    ] + list(tags)
                _emit(family, labels, value)

    lines: List[str] = []
    for family in sorted(families):
        lines.append(f"# TYPE {family} gauge")
        lines.extend(sorted(families[family]))
    lines.append("# EOF")
    return "\n".join(lines) + "\n"
