"""The counter API: pass/launch accounting shared by `ExecutionStats`
sinks and active tracers.

`ops/runtime.py`'s `monitored()` / `record_pass()` / `record_launch()`
delegate here. A sink
is any object with `device_passes` / `device_launches` / `group_passes`
ints and a `pass_labels` list — `runtime.ExecutionStats` in practice,
duck-typed so this module never imports the ops layer.

The sink stack is thread-local (concurrent monitored scans on separate
threads never cross-contaminate), and every record also feeds the
thread's active tracer, whose counters therefore stay bit-identical to
what a `monitored()` block around the same run would report.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, List

from deequ_tpu_torch.observe import spans

_local = threading.local()

_EMPTY: List = []


def _sinks() -> List:
    return getattr(_local, "sinks", _EMPTY)


@contextlib.contextmanager
def collect(sink) -> Iterator:
    """Register `sink` for every record_* on this thread in the block."""
    try:
        stack = _local.sinks
    except AttributeError:
        stack = _local.sinks = []
    stack.append(sink)
    try:
        yield sink
    finally:
        stack.pop()


def record_pass(label: str) -> None:
    """One fused scan over a dataset (≈ one Spark job)."""
    for sink in _sinks():
        sink.device_passes += 1
        sink.pass_labels.append(label)
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("device_passes", 1, label)


def record_launch() -> None:
    """One compiled-program invocation (per batch)."""
    for sink in _sinks():
        sink.device_launches += 1
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("device_launches", 1)


def record_group_pass(label: str) -> None:
    """One group-by frequency computation."""
    for sink in _sinks():
        sink.group_passes += 1
        sink.pass_labels.append(f"group:{label}")
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("group_passes", 1, f"group:{label}")


def record_pruned_groups(skipped: int, total: int) -> None:
    """Row-group pushdown outcome of one fused scan: groups statically
    skipped vs groups in the file. Tracer-only (no ExecutionStats
    field — pruning is an IO property, not an execution count); the
    counters feed cost_drift's predicted-vs-observed check and the
    `engine.rg_skipped_ratio` telemetry series."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("rg_skipped", int(skipped))
        tracer.count("rg_total", int(total))


def record_decode_fastpath(fast: int, total: int, workers: int) -> None:
    """Decode-plan outcome of one fused scan: columns routed through the
    buffer-level native decode vs columns scanned, plus the worker count
    the scan decodes with. Tracer-only, like record_pruned_groups; the
    counters feed cost_drift's decode pin and the
    `engine.decode_fastpath_ratio` / `engine.decode_workers` telemetry
    series (decode_passes normalizes workers to a per-scan average)."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("decode_cols_fast", int(fast))
        tracer.count("decode_cols_total", int(total))
        tracer.count("decode_workers", int(workers))
        tracer.count("decode_passes", 1)


def record_wire_fused(fused: int, total: int) -> None:
    """Decode-to-wire outcome of one fused scan: columns whose wire
    buffers the decode workers emit directly vs columns scanned.
    Tracer-only, like record_decode_fastpath; the counters feed
    cost_drift's wire pin and the `engine.wire_fused_ratio` telemetry
    series."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("wire_fused_cols", int(fused))
        tracer.count("wire_cols_total", int(total))


def record_reader_chunks(native: int, fallback: int, total: int) -> None:
    """Native-reader plan outcome of one fused scan: column chunks the
    native parquet reader decodes vs chunks that fall back to pyarrow,
    out of the chunks the scan touches (scanned columns × non-pruned row
    groups). Tracer-only, like record_decode_fastpath; the counters feed
    cost_drift's `drift.reader_chunks_native` pin and the
    `engine.reader_native_ratio` telemetry series."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("reader_chunks_native", int(native))
        tracer.count("reader_chunks_fallback", int(fallback))
        tracer.count("reader_chunks_total", int(total))


def record_encfold_plan(cols: int, total: int) -> None:
    """Encoded-fold plan outcome of one fused scan: columns the planner
    proved run-foldable (classify_encfold_columns) vs columns scanned.
    STATIC, recorded once per scan like record_reader_chunks — the trace
    side of cost_drift's `drift.encfold_columns` pin."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("encfold_cols", int(cols))
        tracer.count("encfold_cols_total", int(total))


def record_encfold(
    chunks: int,
    fallback: int,
    runs: int,
    values: int,
    codes: int,
    bytes_saved: int,
) -> None:
    """Encoded-fold outcome of one decode unit (the DYNAMIC half —
    record_encfold_plan carries the static column verdict): chunks that
    folded over (run, code) streams, chunks that failed closed to the
    row-width path, runs vs logical values folded (run_ratio — the
    compression the fold exploited), distinct dictionary codes rolled up
    to engine values, and row-width bytes never materialized.
    Tracer-only; the counters feed the `engine.encfold.*` telemetry
    series the sentinel watches."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("encfold_chunks", int(chunks))
        if fallback:
            tracer.count("encfold_chunks_fallback", int(fallback))
        if runs:
            tracer.count("encfold_runs", int(runs))
        if values:
            tracer.count("encfold_values", int(values))
        if codes:
            tracer.count("encfold_codes_folded", int(codes))
        if bytes_saved:
            tracer.count("encfold_bytes_saved", int(bytes_saved))


def record_retry(attempts: int, recovered: int, exhausted: int) -> None:
    """Transient-IO retry outcome of one readahead fetch operation:
    backoff sleeps taken, whether the operation recovered after >=1
    retry, and whether the budget ran dry (the unit then degrades to
    the pyarrow fallback — never a wrong answer). Tracer-only, like
    record_pruned_groups; the counters feed the
    `engine.retry.recovery_ratio` telemetry series the sentinel
    watches."""
    tracer = spans.current_tracer()
    if tracer is not None:
        if attempts:
            tracer.count("retry.attempts", int(attempts))
        if recovered:
            tracer.count("retry.recovered", int(recovered))
        if exhausted:
            tracer.count("retry.exhausted", int(exhausted))


def record_fault(injected: int = 0, fallback_units: int = 0) -> None:
    """Fault-containment accounting: faults observed at engine fault
    points (injected by the chaos harness or real transient IO errors),
    and decode units that degraded to the pyarrow fallback because of
    one. Tracer-only; feeds the `engine.fault.fallback_ratio` telemetry
    series the sentinel watches."""
    tracer = spans.current_tracer()
    if tracer is not None:
        if injected:
            tracer.count("fault.observed", int(injected))
        if fallback_units:
            tracer.count("fault.fallback_units", int(fallback_units))


def record_shard_scan(
    shard: int,
    num_shards: int,
    partitions_local: int,
    partitions_max: int,
    partitions_total: int,
    merge_bytes: int,
    rows_local: int,
) -> None:
    """Shard-split outcome of one sharded streaming scan (one record per
    participating process): which shard this is out of how many, its
    partition slice vs the largest shard's and the dataset total, the
    gathered state-envelope bytes that crossed the process boundary,
    and the rows this shard folded. Tracer-only, like
    record_state_cache; the counters feed cost_drift's shard pins and
    the `engine.shard.*` telemetry series the sentinel watches."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("shard.index", int(shard))
        tracer.count("shard.count", int(num_shards))
        tracer.count("shard.partitions_local", int(partitions_local))
        tracer.count("shard.partitions_max", int(partitions_max))
        tracer.count("shard.partitions_total", int(partitions_total))
        tracer.count("shard.merge_bytes", int(merge_bytes))
        tracer.count("shard.rows_local", int(rows_local))


def record_plan_cache(hit: bool) -> None:
    """Compiled-plan cache outcome of one fused-fn lookup: whether the
    jit/fuse cost for this plan *shape* (the analyzer-repr component of
    `repository.states.plan_signature`, plus wire layout and x64 flag)
    was already paid by an earlier plan anywhere in the process —
    fleet-wide under the DQService, where co-tenant suites share plan
    shapes. Tracer-only, like record_pruned_groups; the counters feed
    the `engine.plan_cache_hit_ratio` telemetry series the sentinel
    watches."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("plan_cache.lookups", 1)
        if hit:
            tracer.count("plan_cache.hits", 1)


def record_state_cache(cached: int, scanned: int, total: int) -> None:
    """Partition-split outcome of one partitioned fused scan: partitions
    whose states loaded from the state cache vs partitions that decoded
    and folded, out of the dataset's partition count. Tracer-only, like
    record_pruned_groups; the counters feed cost_drift's
    `drift.partitions_cached` pin and the `engine.state_cache_hit_ratio`
    telemetry series."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("partitions_cached", int(cached))
        tracer.count("partitions_scanned", int(scanned))
        tracer.count("partitions_total", int(total))


def record_window(
    segments: int, hits: int, built: int, rescanned: int, partitions: int
) -> None:
    """Segment-merge outcome of one window query (windows/query.py):
    cover spans merged, of which segment-envelope hits vs lazily built,
    plus partitions that had to rescan out of the window's member
    count. Tracer-only, like record_state_cache; the counters feed
    cost_drift's `drift.window_*` pins and the
    `engine.window.segment_hit_ratio` telemetry series the sentinel
    watches."""
    tracer = spans.current_tracer()
    if tracer is not None:
        tracer.count("window.spans", int(segments))
        tracer.count("window.segments_merged", int(segments))
        tracer.count("window.segment_hits", int(hits))
        tracer.count("window.segments_built", int(built))
        tracer.count("window.partitions_rescanned", int(rescanned))
        tracer.count("window.partitions", int(partitions))
