"""Engine counts: where each one is defined and recorded.

A count has two readers, and one `record_*` call feeds both:

  * the `monitored()` blocks open on the thread, each an `ExecutionStats`
    sink on a thread-local stack (concurrent monitored scans on separate
    threads never mix); a decode or prep thread of a monitored pass
    counts into its caller's blocks by `attached_sinks(current_sinks())`;
  * the thread's tracer (`observe.spans`), whose `counters` and the
    innermost span's attributes the run report, `lint/cost.py`'s drift
    pins and `observe/telemetry.py`'s `engine.counter.*` series read by
    name.

Each `record_*` below is one counted event; its docstring says what it
adds to the sinks and what to the tracer. Sinks are added to under one
lock, since decode workers record at once; the tracer has its own.

To add a counter: a field on `ExecutionStats` if `monitored()` should
see it, one `record_*` function here that hands its counts to
`_record`, called from where the event happens, and a pair in
`HEADLINE_RATIOS` if the run report's headline should print it.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass, field
from types import MappingProxyType
from typing import Any, Iterator, List, Mapping, Sequence, Tuple

from deequ_tpu_torch.observe import spans


@dataclass
class ExecutionStats:
    """Counts of engine work during a `monitored()` block."""

    device_passes: int = 0  # one per fused scan over a table
    device_launches: int = 0  # one per device program run (per batch)
    group_passes: int = 0  # one per group-by frequency computation
    # one label per device pass ("scan:...", "freq-agg:...") and group
    # pass ("group:..."), in the order they ran
    pass_labels: List[str] = field(default_factory=list)
    # partitioned scans: partitions whose states loaded from a state
    # repository, partitions that scanned, and all of them
    partitions_cached: int = 0
    partitions_scanned: int = 0
    partitions_total: int = 0
    # placement of each pass's members: the mode, members folded in the
    # device program, members folded on the host
    placements: List[str] = field(default_factory=list)
    device_members: int = 0
    host_members: int = 0
    # family kernels of host-folded sketches: C traversals run (one per
    # batched group or solo column) and families served by counts
    family_kernels: int = 0
    family_shortcuts: int = 0
    # decode-to-wire: columns fused and columns the planner judged
    wire_fused_cols: int = 0
    wire_cols_total: int = 0
    wire_fused: List[str] = field(default_factory=list)
    wire_falloffs: List[Tuple[str, str, str]] = field(default_factory=list)
    # (column, batch) pairs of STRING columns with a DataType or HLL
    # input: classified and hashed on the device (K5), and all of them
    device_strings: int = 0
    device_strings_total: int = 0
    # predicate mask builds (`pred:`, `prednn:`, `where:`): those served
    # from a STRING column's dictionary, and all of them
    dictionary_predicates: int = 0
    dictionary_predicates_total: int = 0
    # quantile sketches' per-batch samples (one per member, batch and
    # mesh shard): selected in the device program (K6), and all of them
    device_quantile_samples: int = 0
    device_quantile_samples_total: int = 0
    # encoded fold, the plan: columns approved and judged, the approved
    # names and the others' reasons
    encfold_cols: int = 0
    encfold_cols_total: int = 0
    encfold_planned: List[str] = field(default_factory=list)
    encfold_falloffs: List[Tuple[str, str]] = field(default_factory=list)
    # encoded fold, the decode: chunks folded over runs, chunks that fell
    # back to row width, runs and values folded, dictionary codes rolled
    # up, row-width bytes never built
    encfold_chunks: int = 0
    encfold_chunks_fallback: int = 0
    encfold_runs: int = 0
    encfold_values: int = 0
    encfold_codes_folded: int = 0
    encfold_bytes_saved: int = 0
    # mesh-sharded passes (parallel/distributed.py) and their shards in
    # all: each shard of each batch is one device program run
    mesh_passes: int = 0
    mesh_shards: int = 0
    # sharded streaming scan (parallel/multihost.py), this process's
    # shard: its partitions, the gathered envelope bytes that crossed
    # the process boundary, and the rows of its partitions
    shard_partitions_local: int = 0
    shard_merge_bytes: int = 0
    shard_rows_local: int = 0
    # row-group pruning (lint/pushdown.py), summed over the pruned
    # scans: groups skipped unread, groups in the files, the rows of the
    # skipped groups, and where filters swapped for a constant mask
    rg_skipped: int = 0
    rg_total: int = 0
    rg_rows_skipped: int = 0
    wheres_elided: int = 0

    @property
    def jobs(self) -> int:
        return self.device_passes + self.group_passes


#: the (count, total) tracer counters the run report's headline prints
#: as "count/total" beside the pass counters, each left out while its
#: total is 0 (observe/report.py)
HEADLINE_RATIOS = (
    ("device_strings", "device_strings_total"),
    ("dictionary_predicates", "dictionary_predicates_total"),
    ("device_quantile_samples", "device_quantile_samples_total"),
)

_local = threading.local()
_EMPTY: List[ExecutionStats] = []
_LOCK = threading.Lock()  # every sink update, from any thread
_NONE: Mapping[str, Any] = MappingProxyType({})


def _sinks() -> List[ExecutionStats]:
    return getattr(_local, "sinks", _EMPTY)


def current_sinks() -> List[ExecutionStats]:
    """The `monitored()` blocks this thread counts into, for a stage
    thread that works for it (`attached_sinks`)."""
    return list(_sinks())


@contextlib.contextmanager
def attached_sinks(sinks: Sequence[ExecutionStats]) -> Iterator[None]:
    """Count this thread's work into `sinks` as well, for the block: a
    decode or prep thread of a monitored pass records into its caller's
    blocks."""
    try:
        stack = _local.sinks
    except AttributeError:
        stack = _local.sinks = []
    base = len(stack)
    stack.extend(sinks)
    try:
        yield
    finally:
        del stack[base:]


@contextlib.contextmanager
def monitored() -> Iterator[ExecutionStats]:
    """Count the engine work of everything run on this thread inside the
    block, and on the stage threads that attach it. A traced run's
    counters are the same numbers, since every record feeds both."""
    stats = ExecutionStats()
    with attached_sinks([stats]):
        yield stats


def _record(
    sinks: Mapping[str, Any] = _NONE,
    tracer: Mapping[str, Any] = _NONE,
    nonzero: Mapping[str, Any] = _NONE,
) -> None:
    """Add `sinks` to every sink of this thread under the lock (a list
    extends its field, anything else adds to it as an int), then
    `tracer` to the thread's tracer, and `nonzero` after it less the
    keys whose count is 0."""
    stack = _sinks()
    if stack and sinks:
        with _LOCK:
            for sink in stack:
                for name, value in sinks.items():
                    if isinstance(value, list):
                        getattr(sink, name).extend(value)
                    else:
                        setattr(sink, name, getattr(sink, name) + int(value))
    t = spans.current_tracer()
    if t is not None:
        for key, n in tracer.items():
            t.count(key, int(n))
        for key, n in nonzero.items():
            if n:
                t.count(key, int(n))


def record_pass(label: str) -> None:
    """One fused scan over a table, or one shared frequency aggregation.
    Sinks: a pass and its label. Tracer: the pass."""
    _record({"device_passes": 1, "pass_labels": [label]}, {"device_passes": 1})


def record_launch() -> None:
    """One run of a batch's device program, or of a frequency
    aggregation. Sinks and tracer alike."""
    _record({"device_launches": 1}, {"device_launches": 1})


def record_group_pass(label: str) -> None:
    """One group-by counting pass over a table. Sinks: a pass and its
    label, ``group:<label>``. Tracer: the pass."""
    _record({"group_passes": 1, "pass_labels": [f"group:{label}"]}, {"group_passes": 1})


def record_state_cache(cached: int, scanned: int, total: int) -> None:
    """The split of one partitioned scan: partitions whose states loaded
    from the state repository, partitions that scanned, and all of them.
    Sinks and tracer alike, zeros too (cost_drift's
    `drift.partitions_cached` pin, `engine.state_cache_hit_ratio`)."""
    counts = {"partitions_cached": cached, "partitions_scanned": scanned, "partitions_total": total}
    _record(counts, counts)


def record_placement(mode: str, device_members: int, host_members: int) -> None:
    """One fused pass's placement and its member split. Sinks only."""
    _record({"placements": [mode], "device_members": device_members, "host_members": host_members})


def record_family(kernels: int = 0, shortcuts: int = 0) -> None:
    """Family kernels run for one host batch, and families served from
    counts instead. Sinks only: the kernels have their own spans."""
    _record({"family_kernels": kernels, "family_shortcuts": shortcuts})


def record_wire_fused(fused: Sequence[str], total: int, falloffs=()) -> None:
    """One pass's decode-to-wire verdict: the columns whose wire buffers
    the decode writes, the columns judged, and the others' (column,
    reason, key) records. Sinks and tracer: the two counts, zeros too
    (cost_drift's wire pin, `engine.wire_fused_ratio`). Sinks also: the
    names and the records."""
    counts = {"wire_fused_cols": len(fused), "wire_cols_total": total}
    _record({**counts, "wire_fused": list(fused), "wire_falloffs": list(falloffs)}, counts)


def record_device_strings(device: int, total: int) -> None:
    """One batch's verdict on its STRING columns' DataType classes and
    HLL codes: columns computed on the device from their dictionary
    (K5), and all the columns with such an input. Sinks and tracer
    alike, zeros too; a headline pair of the run report."""
    counts = {"device_strings": device, "device_strings_total": total}
    _record(counts, counts)


def record_dictionary_predicates(engaged: int, total: int) -> None:
    """Predicate mask builds (`pred:`, `prednn:`, `where:`): those served
    from a STRING column's dictionary (one evaluation over its entries,
    gathered through the codes), and all of them. Sinks and tracer
    alike, zeros too; a headline pair of the run report."""
    counts = {"dictionary_predicates": engaged, "dictionary_predicates_total": total}
    _record(counts, counts)


def record_device_quantile_samples(device: int, total: int) -> None:
    """A quantile sketch's samples of one batch (one a mesh shard): those
    selected in the device program (K6, `hist16_select`), and all of
    them, host-folded ones too. Sinks and tracer alike; a headline pair of
    the run report."""
    counts = {"device_quantile_samples": device, "device_quantile_samples_total": total}
    _record(counts, counts)


def record_encfold_plan(cols: Sequence[str], total: int, falloffs=()) -> None:
    """One pass's encoded-fold verdict: the columns the planner proved
    run-foldable, the columns judged, and the others' (column, reason)
    records. Sinks and tracer: the two counts, zeros too (cost_drift's
    `drift.encfold_columns` pin). Sinks also: the names and the
    records."""
    counts = {"encfold_cols": len(cols), "encfold_cols_total": total}
    _record({**counts, "encfold_planned": list(cols), "encfold_falloffs": list(falloffs)}, counts)


def record_encfold(
    chunks: int, fallback: int, runs: int, values: int, codes: int, bytes_saved: int
) -> None:
    """One decode unit's encoded fold: chunks folded over (run, code)
    streams, chunks that fell back to the row-width path, runs and
    logical values folded, dictionary codes rolled up, row-width bytes
    never built. Sinks and tracer alike (`engine.encfold.*`), but the
    tracer gets only the chunks when the others are 0."""
    always = {"encfold_chunks": chunks}
    nonzero = {
        "encfold_chunks_fallback": fallback,
        "encfold_runs": runs,
        "encfold_values": values,
        "encfold_codes_folded": codes,
        "encfold_bytes_saved": bytes_saved,
    }
    _record({**always, **nonzero}, always, nonzero)


def record_mesh_pass(shards: int) -> None:
    """One mesh-sharded pass over `shards` shards. Sinks only."""
    _record({"mesh_passes": 1, "mesh_shards": shards})


def record_shard_scan(
    shard: int,
    num_shards: int,
    partitions_local: int,
    partitions_max: int,
    partitions_total: int,
    merge_bytes: int,
    rows_local: int,
) -> None:
    """This process's part of one sharded streaming scan: its shard of
    how many, its partitions against the largest shard's and the
    dataset's, the gathered envelope bytes that crossed the process
    boundary, and its rows. Sinks: the local counts. Tracer: every
    field as `shard.*`, zeros too (cost_drift's shard pins)."""
    _record(
        {
            "shard_partitions_local": partitions_local,
            "shard_merge_bytes": merge_bytes,
            "shard_rows_local": rows_local,
        },
        {
            "shard.index": shard,
            "shard.count": num_shards,
            "shard.partitions_local": partitions_local,
            "shard.partitions_max": partitions_max,
            "shard.partitions_total": partitions_total,
            "shard.merge_bytes": merge_bytes,
            "shard.rows_local": rows_local,
        },
    )


def record_pruned_groups(skipped: int, total: int, rows_skipped: int, wheres_elided: int) -> None:
    """One scan's row-group prune decision (ops/fused.py:
    apply_prune_plan): groups skipped unread, groups in the files, the
    skipped groups' rows, and where filters swapped for a constant mask.
    Sinks: all four. Tracer: the two group counts, zeros too
    (cost_drift's predicted-against-observed check,
    `engine.rg_skipped_ratio`)."""
    groups = {"rg_skipped": skipped, "rg_total": total}
    _record({**groups, "rg_rows_skipped": rows_skipped, "wheres_elided": wheres_elided}, groups)


def record_decode_fastpath(fast: int, total: int, workers: int) -> None:
    """One scan's decode routing: the columns on the C decode, the
    columns scanned and the decode threads, and a scan that makes the
    workers a per-scan mean. Tracer only, zeros too (cost_drift's decode
    pin, `engine.decode_fastpath_ratio`, `engine.decode_workers`)."""
    _record(
        tracer={
            "decode_cols_fast": fast,
            "decode_cols_total": total,
            "decode_workers": workers,
            "decode_passes": 1,
        }
    )


def record_reader_chunks(native: int, fallback: int, total: int) -> None:
    """One scan's C reader plan: column chunks the reader takes, chunks
    left to pyarrow, and all chunks scanned (scanned columns times
    unpruned row groups). Tracer only, zeros too (cost_drift's
    `drift.reader_chunks_native` pin, `engine.reader_native_ratio`)."""
    _record(
        tracer={
            "reader_chunks_native": native,
            "reader_chunks_fallback": fallback,
            "reader_chunks_total": total,
        }
    )


def record_plan_cache(hit: bool) -> None:
    """One device-program lookup, and a hit when its plan shape was
    cached anywhere in the process (co-tenant suites of the DQService
    share plan shapes). Tracer only, the hit only when there was one
    (`engine.plan_cache_hit_ratio`)."""
    _record(tracer={"plan_cache.lookups": 1}, nonzero={"plan_cache.hits": int(hit)})


def record_retry(attempts: int, recovered: int, exhausted: int) -> None:
    """One transient-IO operation's retries: backoff sleeps taken,
    whether it recovered after one or more, whether its budget ran dry
    (the unit then reads through pyarrow, never a wrong answer). Tracer
    only, each only when not 0 (`engine.retry.recovery_ratio`)."""
    _record(
        nonzero={
            "retry.attempts": attempts,
            "retry.recovered": recovered,
            "retry.exhausted": exhausted,
        }
    )


def record_fault(injected: int = 0, fallback_units: int = 0) -> None:
    """Faults seen at the engine's fault points (injected by the chaos
    harness, or real transient IO errors), and decode units that went to
    pyarrow because of one. Tracer only, each only when not 0
    (`engine.fault.fallback_ratio`)."""
    _record(nonzero={"fault.observed": injected, "fault.fallback_units": fallback_units})


def record_window(segments: int, hits: int, built: int, rescanned: int, partitions: int) -> None:
    """One window query's merge (windows/query.py): cover spans merged
    (kept as `window.spans` and as `window.segments_merged`), of them
    segment hits and segments built, partitions rescanned, and the
    window's partitions. Tracer only, zeros too (cost_drift's
    `drift.window_*` pins, `engine.window.segment_hit_ratio`)."""
    _record(
        tracer={
            "window.spans": segments,
            "window.segments_merged": segments,
            "window.segment_hits": hits,
            "window.segments_built": built,
            "window.partitions_rescanned": rescanned,
            "window.partitions": partitions,
        }
    )
