#!/usr/bin/env python3
"""Regression sentinel: anomaly detection over engine telemetry series.

Loads engine metric time series from two sources and runs the repo's own
anomaly strategies over them, exiting nonzero with a human-readable
verdict when throughput or phase shares regress:

  * a metrics repository JSON file (default `ENGINE_METRICS.json` at the
    repo root, where `repository.engine.record_run` points are saved),
    filtered to `telemetry=engine` result keys via
    `deequ_tpu_torch.repository.engine`;
  * a history of benchmark rounds (`--bench GLOB`, files with a
    `parsed.value` headline rows/s and a round number `n`). The port has
    no benchmark of its own yet, so none is read by default: the
    repository's `BENCH_r0*.json` are the JAX package's rounds.

Detection per series (union of what each strategy flags):

  * `RateOfChangeStrategy` over log-values — scale-free relative step
    detection; a drop of more than `--max-drop` (default 20%) between
    consecutive points flags (for up-is-bad series: a rise of more than
    the same fraction);
  * `OnlineNormalStrategy` one-sided at 3 sigma — drift detection
    against the running mean (lower side for throughput, upper side for
    phase shares);
  * `HoltWinters` (daily/weekly) on series long enough for two full
    cycles plus a test window — catches seasonal-shape breaks.

Usage:
  python tools/torch_sentinel.py [--repo PATH] [--bench GLOB] [--max-drop F]

Exit status: 0 = ok (or not enough history), 1 = regression flagged.
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import sys
from typing import Any, Dict, List, Optional, Sequence, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: engine series watched from the metrics repository, with regression
#: direction ("down" = drops are bad, "up" = rises are bad)
WATCHED_SERIES: Sequence[Tuple[str, str]] = (
    ("engine.rows_per_s", "down"),
    ("engine.peak_rss_mb", "up"),
    # pushdown effectiveness: the fraction of parquet row groups skipped
    # statically; a drop means predicates stopped proving groups
    # all-false (stats regressed, interpreter weakened, plan changed)
    ("engine.rg_skipped_ratio", "down"),
    # decode fast-path effectiveness: the fraction of scanned columns on
    # the buffer-level native decode; a drop means columns fell back to
    # the host chain (classifier narrowed, native build broken, schema
    # drifted toward ineligible types)
    ("engine.decode_fastpath_ratio", "down"),
    # per-scan decode worker count; a drop means the pool stopped
    # scaling (env override lost, cpu_count misdetected)
    ("engine.decode_workers", "down"),
    # decode-to-wire effectiveness: the fraction of scanned columns fused
    # straight to wire buffers at decode; a drop means columns fell back
    # to the Column path (consumer set widened, sticky spec lost, wire
    # kernels unavailable)
    ("engine.wire_fused_ratio", "down"),
    # native parquet reader effectiveness: the fraction of fast-path
    # column-chunks decoded by the page-to-wire reader; a drop means
    # chunks fell back to arrow (codec library vanished, writer switched
    # to an unsupported page encoding, chunk layout metadata lost)
    ("engine.reader_native_ratio", "down"),
    # encoded-fold compression: logical values folded per (run, code)
    # entry; a drop toward 1.0 means the data stopped run-compressing
    # (cardinality rising, writer stopped dictionary-coding) and the
    # run-fold kernels stopped paying
    ("engine.encfold.run_ratio", "down"),
    # encoded-fold containment: chunks that failed closed to the
    # row-width path out of planned run-fold chunks; a rise means pages
    # stopped being all-dictionary at decode (writer fallback pages,
    # corrupt runs, dict-size overflow past the cap)
    ("engine.encfold.fallback_ratio", "up"),
    # state-cache effectiveness: the fraction of dataset partitions whose
    # analyzer states loaded from the persistent partition-state cache
    # instead of rescanning; a drop means incremental runs stopped
    # hitting (fingerprints churning, plan signature drifting, envelope
    # decode failures falling back to rescan)
    ("engine.state_cache_hit_ratio", "down"),
    # compiled-plan cache effectiveness: the fraction of fused-fn
    # lookups whose plan shape was already jitted (the fuse cost paid
    # once per shape fleet-wide); a drop means plan shapes stopped
    # deduplicating (shape key churning, cache evicting under max-size,
    # tenants diverging in analyzer spelling)
    ("engine.plan_cache_hit_ratio", "down"),
    # transient-fault recovery: the fraction of retried IO operations
    # that recovered within the retry budget; a drop means transient
    # faults stopped being absorbed (budget misconfigured, backoff too
    # short for the store's stall profile, faults turned persistent)
    ("engine.retry.recovery_ratio", "down"),
    # fault containment cost: the fraction of observed faults that cost
    # a unit its native decode (degraded to the pyarrow fallback); a
    # rise means faults are escaping the retry layer and landing on the
    # slow path
    ("engine.fault.fallback_ratio", "up"),
    # DQ service overload shedding: the fraction of submissions shed at
    # admission (DQ412); growth means the pool is saturated — queues
    # too small, workers too few, or a tenant flooding past its quota
    ("engine.service.shed_ratio", "up"),
    # DQ service circuit breakers currently open: a rise means more
    # (tenant, dataset) pairs are repeatedly failing their runs and
    # being fenced off from the pool (corrupt upstream tables)
    ("engine.service.breaker_open", "up"),
    # sharded-scan per-shard fold throughput: a drop means shards
    # stopped scaling (straggler host, shrunken readahead, partition
    # skew starving the mesh)
    ("engine.shard.rows_per_s", "down"),
    # sharded-scan balance: the largest shard's partition count over
    # the even split; a rise means the rendezvous assignment degenerated
    # (partition count too low for the mesh, exclusions piling up)
    ("engine.shard.skew_ratio", "up"),
    # sharded-scan merge traffic: gathered state-envelope bytes crossing
    # the process boundary; growth means states bloated (HLL/histogram
    # payloads growing, partition counts exploding) — rows never cross,
    # so this must stay KB-scale
    ("engine.shard.merge_bytes", "up"),
    # windowed-query segment effectiveness: the fraction of a window's
    # cover spans answered by a precomputed DQSG segment envelope; a
    # collapse means segment publication broke (warm=False everywhere,
    # put_blob failing silently) or partition churn outruns the covers
    ("engine.window.segment_hit_ratio", "down"),
    # windowed-query rescan pressure: member partitions with no usable
    # cached state; a rise means the per-partition state commit path
    # regressed (serde failures, signature churn) and window queries are
    # quietly turning back into scans
    ("engine.window.partitions_rescanned", "up"),
    # dataset drift: the worst two-sample drift measure a DriftCheck
    # observed (KS distance, cardinality ratio, completeness/moment
    # deltas); a rise means the watched dataset's distribution is moving
    # against its baseline window
    ("engine.drift.value_max", "up"),
    # drift constraint failures per evaluation; any sustained rise means
    # a dataset is actively violating its drift contract (or the
    # baseline wiring broke — DQ324 failures count here too)
    ("engine.drift.failed_constraints", "up"),
)

#: phases whose share of wall time is watched (rises are bad: a phase
#: eating a larger fraction of the run means a new bottleneck)
WATCHED_PHASE_SHARES: Sequence[str] = ("dispatch", "transfer", "merge", "host")

#: minimum points before a series is judged at all
MIN_POINTS = 4

#: HoltWinters needs two full weekly cycles of training plus a test window
HW_MIN_POINTS = 15


def _ensure_repo_on_path() -> None:
    if REPO_ROOT not in sys.path:
        sys.path.insert(0, REPO_ROOT)


def detect_regressions(
    points: Sequence[Any],
    *,
    direction: str = "down",
    max_drop: float = 0.2,
) -> List[Dict[str, Any]]:
    """Run the strategy union over one series of anomaly DataPoints.

    Returns one finding dict per flagged point: {time, value, detail,
    strategies}. Points whose metric_value is None are dropped first.
    """
    _ensure_repo_on_path()
    from deequ_tpu_torch.anomaly import (
        HoltWinters,
        MetricInterval,
        OnlineNormalStrategy,
        RateOfChangeStrategy,
        SeriesSeasonality,
    )

    series = [p for p in points if p.metric_value is not None]
    series.sort(key=lambda p: p.time)
    values = [float(p.metric_value) for p in series]
    times = [p.time for p in series]
    n = len(values)
    if n < MIN_POINTS:
        return []

    flagged: Dict[int, Dict[str, Any]] = {}

    def _flag(index: int, strategy: str, detail: str) -> None:
        if not (0 <= index < n):
            return
        entry = flagged.setdefault(
            index,
            {
                "time": times[index],
                "value": values[index],
                "strategies": [],
                "detail": detail,
            },
        )
        if strategy not in entry["strategies"]:
            entry["strategies"].append(strategy)

    # 1) relative step detection on log-values (scale-free): a drop
    # below (1 - max_drop)x, or a rise above 1/(1 - max_drop)x for
    # up-is-bad series, between consecutive points
    if all(v > 0.0 for v in values):
        logs = [math.log(v) for v in values]
        bound = math.log(1.0 - max_drop)
        if direction == "down":
            roc = RateOfChangeStrategy(max_rate_decrease=bound)
        else:
            roc = RateOfChangeStrategy(max_rate_increase=-bound)
        for idx, anomaly in roc.detect(logs, (1, n)):
            prev = values[idx - 1]
            change = (values[idx] / prev - 1.0) * 100.0 if prev else float("nan")
            _flag(
                idx,
                "RateOfChange",
                f"{change:+.1f}% vs previous point {prev:.6g}",
            )

    # 2) one-sided drift vs the running mean (3 sigma)
    if direction == "down":
        online = OnlineNormalStrategy(
            lower_deviation_factor=3.0, upper_deviation_factor=None
        )
    else:
        online = OnlineNormalStrategy(
            lower_deviation_factor=None, upper_deviation_factor=3.0
        )
    for idx, anomaly in online.detect(values, (0, n)):
        _flag(idx, "OnlineNormal", anomaly.detail or ">3 sigma vs running mean")

    # 3) seasonal forecast residuals, only with enough history for two
    # full (weekly) cycles of training plus a test window
    if n >= HW_MIN_POINTS:
        hw = HoltWinters(MetricInterval.DAILY, SeriesSeasonality.WEEKLY)
        try:
            for idx, anomaly in hw.detect(values, (14, n)):
                _flag(idx, "HoltWinters", anomaly.detail or "forecast residual")
        except (ValueError, ImportError):
            pass  # degenerate series / missing scipy: skip the seasonal pass

    return [flagged[idx] for idx in sorted(flagged)]


def _repo_series(
    repo_path: str,
) -> List[Tuple[str, str, List[Any]]]:
    """(series_name, direction, points) triples from a repository file."""
    _ensure_repo_on_path()
    from deequ_tpu_torch.anomaly import DataPoint
    from deequ_tpu_torch.repository import engine
    from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository

    if not os.path.exists(repo_path):
        return []
    repository = FileSystemMetricsRepository(repo_path)
    available = set(engine.engine_metric_names(repository))
    out: List[Tuple[str, str, List[Any]]] = []
    for name, direction in WATCHED_SERIES:
        if name in available:
            out.append((name, direction, engine.engine_series(repository, name)))

    # phase shares: join phase seconds against wall seconds by timestamp
    wall = {p.time: p.metric_value for p in engine.engine_series(repository, "engine.wall_s")}
    for phase in WATCHED_PHASE_SHARES:
        name = f"engine.phase.{phase}_s"
        if name not in available:
            continue
        shares = [
            DataPoint(p.time, float(p.metric_value) / float(wall[p.time]))
            for p in engine.engine_series(repository, name)
            if p.metric_value is not None and wall.get(p.time)
        ]
        if shares:
            out.append((f"engine.phase_share.{phase}", "up", shares))
    return out


def _bench_series(pattern: str) -> List[Any]:
    """Headline throughput series from the benchmark round files."""
    _ensure_repo_on_path()
    from deequ_tpu_torch.anomaly import DataPoint

    points = []
    for path in sorted(glob.glob(pattern)):
        try:
            with open(path, encoding="utf-8") as fh:
                data = json.load(fh)
        except (OSError, ValueError):
            continue
        parsed = data.get("parsed") or {}
        value = parsed.get("value")
        round_n = data.get("n")
        if value is None or round_n is None:
            continue  # early rounds have "parsed": null
        points.append(DataPoint(int(round_n), float(value)))
    points.sort(key=lambda p: p.time)
    return points


def run_sentinel(
    repo_path: str,
    bench_pattern: str,
    *,
    max_drop: float = 0.2,
    out=sys.stdout,
) -> int:
    """Check every watched series; print the verdict; return exit status."""
    findings_total = 0
    checked = 0

    def _report(source: str, name: str, points: Sequence[Any], direction: str) -> None:
        nonlocal findings_total, checked
        live = [p for p in points if p.metric_value is not None]
        if len(live) < MIN_POINTS:
            out.write(
                f"sentinel: {name} — {len(live)} points from {source} "
                f"(need {MIN_POINTS}) — skipped\n"
            )
            return
        checked += 1
        findings = detect_regressions(live, direction=direction, max_drop=max_drop)
        if not findings:
            out.write(f"sentinel: {name} — {len(live)} points from {source} — ok\n")
            return
        findings_total += len(findings)
        out.write(f"sentinel: {name} — {len(live)} points from {source}:\n")
        for f in findings:
            out.write(
                f"  REGRESSION at t={f['time']}: value {f['value']:.6g} "
                f"({f['detail']}) [{', '.join(f['strategies'])}]\n"
            )

    for name, direction, points in _repo_series(repo_path):
        _report(os.path.basename(repo_path), name, points, direction)
    bench_points = _bench_series(bench_pattern) if bench_pattern else []
    if bench_points:
        _report(
            os.path.basename(bench_pattern), "bench.rows_per_s", bench_points, "down"
        )

    if findings_total:
        out.write(
            f"verdict: REGRESSION — {findings_total} flagged point(s) "
            f"across {checked} series\n"
        )
        return 1
    if not checked:
        out.write("verdict: ok — not enough engine history to judge yet\n")
        return 0
    out.write(f"verdict: ok — no regressions across {checked} series\n")
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--repo",
        default=os.path.join(REPO_ROOT, "ENGINE_METRICS.json"),
        help="metrics repository JSON file with engine telemetry series",
    )
    parser.add_argument(
        "--bench",
        default="",
        help="glob of benchmark round files (none by default)",
    )
    parser.add_argument(
        "--max-drop",
        type=float,
        default=0.2,
        help="relative throughput drop between points that flags (default 0.2)",
    )
    args = parser.parse_args(argv)
    return run_sentinel(args.repo, args.bench, max_drop=args.max_drop)


if __name__ == "__main__":
    sys.exit(main())
