"""Static scan-cost analyzer: predict the execution shape of an analysis
plan — passes, fused family groups, batches, wire bytes, transfers —
WITHOUT touching a row of data.

The predictions are not estimates of a separate model: placement
partitioning, input-spec dedup, and family grouping come from the SAME
pure planner the runtime consumes (`ops/fused.plan_scan_members` /
`plan_family_jobs` / `group_family_jobs`), the decode verdicts from the
same `plan_decode_fastpath` over the same pruned source view, and the
batching/wire math replays the port's `FusedScanPass._run_pass` /
`pack_batch_inputs` arithmetic. The port's tests and chip_smoke.py pin
the predicted counters, batches and first-batch wire bytes against
`runtime.monitored()` and the buffers `pack_batch_inputs` returns.

Stated model assumptions (where runtime behavior is data-dependent):

  * bool where/predicate masks are transferred unless the pushdown
    interpreter proves them all-true (the runtime also elides a mask
    that happens to be all-true on a given batch);
  * `hll:` codes (register << 6 | rank, 15 bits) ship as int16: int8
    only when every row of the batch hashes into registers 0-1;
  * every shared frequency aggregation launches once on the run's
    device (a spilled state launches once per spill partition more).

The port's copy of deequ_tpu/lint/cost.py. It predicts the port's own
run: float64 compute, a float64 wire with no row-count scalar, masks
padded to whole bytes, and the port's planner verdicts.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.lint.effects import (
    AnalyzerEffect,
    _MASK_PREFIXES,
    analyzer_read_columns,
    pass_read_bytes_per_row,
    pass_wire_bytes_per_row,
    prednn_elided,
    scan_effects,
)
from deequ_tpu_torch.lint.schema import SchemaInfo

#: every span name the execution layer can emit for one analysis run;
#: `span_counts` carries an entry for each (0 = predicted absent) so the
#: differential suite compares complete vocabularies, not subsets.
EXECUTION_SPANS = (
    "plan_fuse",
    "fused_scan",
    "dist_scan",
    "dispatch",
    "host_fold",
    "transfer",
    "merge",
    "family_kernel",
    "grouping",
    "group_pass",
    "freq_agg",
    "state_allgather",
)

#: `runtime.monitored()` counts (ExecutionStats fields) the model predicts
COUNTERS = ("device_passes", "device_launches", "group_passes")


@dataclass(frozen=True)
class FamilyGroupCost:
    """One predicted family-kernel dispatch group: the (where, cap)
    batch of quantile-family columns a single native traversal serves
    per scan batch. Mirrors the `family_kernel` span attrs."""

    where: str  # where_key of the family ("where:<all>" for no filter)
    cap: int
    dtype: str  # compute dtype of the value arrays
    columns: Tuple[str, ...]
    batched: bool
    want_regs: bool = False


@dataclass
class PassCost:
    """Predicted cost of ONE pass over the data (a fused scan, one
    grouping-column-set frequency pass, or a solo analyzer's own scan)."""

    kind: str  # 'scan' | 'grouping' | 'aux'
    label: str
    analyzers: Tuple[str, ...] = ()
    columns: Tuple[str, ...] = ()
    device_members: int = 0
    host_members: int = 0
    input_keys: Tuple[str, ...] = ()
    read_bytes_per_row: float = 0.0
    wire_bytes_per_row: float = 0.0
    n_batches: int = 1
    #: exact packed wire bytes of the FIRST batch (replays the
    #: `pack_batch_inputs` layout math: the sum of `nbytes` of the
    #: buffers it returns); None when the key set contains a format the
    #: model does not replay, or the pass runs on a mesh
    wire_bytes_per_batch: Optional[int] = None
    #: of the first batch's device keys, those predicted to ship as bit
    #: rows (wire_pad_size(rows) / 8 bytes each): the runtime sends one
    #: that is all-true on the batch as a constant instead
    wire_bit_keys: Tuple[str, ...] = ()
    #: row-group pushdown prediction (scan passes over parquet sources
    #: with statistics only): groups in the file / groups the runtime
    #: will skip / decode bytes those skipped groups would have cost.
    #: None = no statistics were available to the planner.
    rg_total: Optional[int] = None
    rg_skipped: Optional[int] = None
    saved_read_bytes: Optional[float] = None
    #: decode fast-path prediction (scan passes over parquet sources
    #: whose decode vocabulary was provided): columns the native
    #: buffer-level decode will take / columns scanned / per-column
    #: fallback reasons / bytes of intermediate host materialization the
    #: fast columns avoid over the decoded rows. None = no decode
    #: vocabulary (in-memory table) or the fast path is unavailable.
    decode_cols_total: Optional[int] = None
    decode_cols_fast: Optional[int] = None
    decode_fallbacks: Tuple[Tuple[str, str], ...] = ()
    saved_decode_bytes: Optional[float] = None
    decode_workers: Optional[int] = None
    #: decode-to-wire prediction (layered on the fast-path verdict,
    #: single-engine scans only): columns decoding straight to packed
    #: wire slices / per-column fall-off reasons with the offending
    #: consumer key / bytes of host pack re-reads the fused columns skip
    #: over the decoded rows. None = wire planning will not run (knob
    #: off, distributed pass, no member plan).
    wire_fused_cols: Optional[int] = None
    wire_falloffs: Tuple[Tuple[str, str, str], ...] = ()
    saved_pack_bytes: Optional[float] = None
    #: native-parquet-reader prediction (layered on the fast-path
    #: verdict, needs footer chunk metadata in `row_groups`): column
    #: chunks the page-level native reader will decode / chunks the scan
    #: touches (scanned columns × non-pruned groups) / per-column
    #: fall-off reasons naming the disqualifying encoding or codec /
    #: bytes of arrow materialization the native chunks avoid over the
    #: decoded rows. None = reader planning will not run (knob off, no
    #: chunk metadata, no loadable codec).
    reader_chunks_total: Optional[int] = None
    reader_chunks_native: Optional[int] = None
    reader_fallbacks: Tuple[Tuple[str, str], ...] = ()
    saved_alloc_bytes: Optional[float] = None
    #: encoded-fold prediction (layered on the native-reader verdict,
    #: single-engine scans only — the consumer proofs need the live
    #: analyzer set): columns whose chunks will fold over (run, code)
    #: streams without row-width materialization / columns scanned /
    #: per-column fall-off reasons naming the disqualifying codec,
    #: analyzer family, dtype, or dict-size condition. None =
    #: encoded-fold planning will not run (knob off, distributed pass,
    #: no reader verdict).
    encfold_cols: Optional[int] = None
    encfold_cols_total: Optional[int] = None
    #: of encfold_cols: columns whose moments fold as Σ(run_len × value)
    #: directly over RLE runs (the rest roll dictionary codes up into
    #: their sketch families)
    encfold_moment_cols: Optional[int] = None
    encfold_falloffs: Tuple[Tuple[str, str], ...] = ()
    #: partition-state-cache prediction (partitioned parquet sources
    #: only): partitions in the dataset / partitions whose states will
    #: load from the attached StateRepository instead of scanning / file
    #: bytes those cached partitions would have read+decoded. None = the
    #: source is not partitioned.
    partitions_total: Optional[int] = None
    partitions_cached: Optional[int] = None
    saved_partition_bytes: Optional[float] = None
    family_groups: Tuple[FamilyGroupCost, ...] = ()
    #: grouping passes: estimated distinct-group count (product of
    #: `approx_distinct` hints); None when any hint is missing
    estimated_groups: Optional[int] = None
    spill_risk: bool = False
    notes: Tuple[str, ...] = ()


#: stated host-side throughput for the decode+prep stages of the stream
#: pipeline (Arrow decode + wire pack are memcpy-shaped): used to turn
#: read bytes/batch into a host seconds/batch for the overlap model.
PIPELINE_HOST_BYTES_PER_S = 2e9


@dataclass
class PipelineCost:
    """Predicted shape of the backpressured stream pipeline
    (ops/pipeline.py) for the scan pass: per-batch stage costs under the
    stated overlap model, and whether the configured queue depth can
    hide the measured H2D transfer latency.

    Model: decode+prep host work per batch is `read_bytes / batch` at
    `PIPELINE_HOST_BYTES_PER_S` (stated constant); the H2D wire time is
    the exact packed first-batch bytes over the measured link bandwidth
    (the same disk-cached probe the placement policy uses, or an
    injected `link_bandwidth`). Serially those costs add; pipelined, the
    critical path is the slowest stage — the overlap-adjusted cost. With
    queue depth d the prep stage can run at most d batches ahead, so a
    single transfer outlasting d batches of host work starves the fold
    stage no matter how the stages interleave (the DQ305 condition)."""

    enabled: bool
    queue_depth: int
    stages: Tuple[str, ...] = ("decode", "prep", "fold")
    n_batches: int = 1
    wire_bytes_per_batch: Optional[int] = None
    link_bandwidth: Optional[float] = None  # bytes/s; None = unmeasured
    host_s_per_batch: Optional[float] = None
    wire_s_per_batch: Optional[float] = None
    serial_s_per_batch: Optional[float] = None
    overlapped_s_per_batch: Optional[float] = None
    bottleneck: Optional[str] = None  # 'host' | 'transfer'

    @property
    def depth_hides_transfer(self) -> Optional[bool]:
        """False when one batch's H2D transfer outlasts `queue_depth`
        batches of host work — the queue drains and the fold stage
        starves. None when either side is unmeasured."""
        if self.wire_s_per_batch is None or self.host_s_per_batch is None:
            return None
        return self.wire_s_per_batch <= self.queue_depth * self.host_s_per_batch


@dataclass
class PlanCost:
    """Machine-readable prediction of a plan's execution shape."""

    placement: str
    compute_dtype: str
    engine: str
    num_rows: Optional[int]
    batch_size: Optional[int]
    analyzers: Tuple[str, ...] = ()  # post-dedupe, pre-precondition
    precondition_failures: Tuple[Tuple[str, str], ...] = ()
    effects: Tuple[AnalyzerEffect, ...] = ()
    passes: List[PassCost] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    span_counts: Dict[str, int] = field(default_factory=dict)
    num_hosts: int = 1
    allgather_rounds: int = 0
    #: sharded streaming scan (parallel/multihost.run_sharded_analysis):
    #: processes in the mesh and each one's partition-slice size in
    #: shard order (from parallel/shard.plan_shards) — rendered in
    #: EXPLAIN's `shards:` line
    num_shards: int = 1
    shard_partitions: Tuple[int, ...] = ()
    #: stream-pipeline prediction for the scan pass; None for
    #: non-streaming plans (in-memory tables never engage the pipeline)
    pipeline: Optional[PipelineCost] = None
    #: the full lint/pushdown.PrunePlan behind the scan pass's rg_*
    #: fields (per-predicate verdicts + eligibility for DQ310/DQ311);
    #: None when no row-group statistics reached the planner
    prune: Optional[Any] = None
    #: the caller's deadline in seconds (None = unbounded), checked by
    #: DQ318 (a deadline over an unpartitioned source leaves nothing
    #: committed for a resume)
    deadline_s: Optional[float] = None
    #: admission classification (DQService admission control): the cost
    #: tier this plan lands in — 'interactive' | 'batch' | 'heavy' —
    #: from the predicted post-prune, post-cache scan bytes against the
    #: ADMISSION_*_BYTES thresholds. Unknown row counts classify as
    #: 'batch' (admit, but never preempt others). Set by analyze_plan.
    admission_tier: Optional[str] = None
    #: scan-bytes headroom left in the tenant's quota window after this
    #: plan runs once — set by explain_plan when the caller supplies
    #: `quota_scan_bytes`; negative means the plan overdraws the window
    #: and DQ319 fires when it can NEVER fit
    quota_headroom_bytes: Optional[float] = None

    @property
    def shard_partitions_max(self) -> int:
        """The largest shard's partition count (the straggler bound)."""
        return max(self.shard_partitions) if self.shard_partitions else 0

    @property
    def shard_skew(self) -> float:
        """Largest shard over the even split; 1.0 = perfectly balanced."""
        total = sum(self.shard_partitions)
        if not total or self.num_shards < 1:
            return 1.0
        return self.shard_partitions_max / (total / self.num_shards)

    @property
    def total_read_bytes_per_row(self) -> float:
        return sum(p.read_bytes_per_row for p in self.passes)

    @property
    def total_wire_bytes_per_row(self) -> float:
        return sum(p.wire_bytes_per_row for p in self.passes)

    @property
    def scan_pass(self) -> Optional[PassCost]:
        for p in self.passes:
            if p.kind == "scan":
                return p
        return None

    @property
    def predicted_scan_bytes(self) -> Optional[float]:
        """Predicted bytes this plan reads end to end: per-pass read
        bytes/row × rows, minus what pushdown skips and what cached
        partition states avoid. None when the row count is unknown —
        admission then classifies conservatively ('batch')."""
        if self.num_rows is None:
            return None
        total = 0.0
        for p in self.passes:
            total += p.read_bytes_per_row * float(self.num_rows)
        scan = self.scan_pass
        if scan is not None:
            total -= float(scan.saved_read_bytes or 0.0)
            total -= float(scan.saved_partition_bytes or 0.0)
        return max(0.0, total)

    def dispatch_signature(self) -> Dict[str, Any]:
        """The comparable execution shape: the `runtime.monitored()`
        counts, the span histogram, and the deduplicated family-group
        set."""
        families = sorted(
            (g.where, g.cap, g.dtype, g.columns, g.batched)
            for p in self.passes
            for g in p.family_groups
        )
        return {
            "counters": dict(self.counters),
            "spans": {k: v for k, v in self.span_counts.items() if v},
            "family_groups": families,
        }


# -- admission tiers (DQService admission control) ---------------------------

#: plans predicted to read fewer bytes than this are 'interactive':
#: they may preempt a running heavy profile (~64 MiB ≈ well under a
#: second of scan on any placement)
ADMISSION_INTERACTIVE_BYTES = 64 << 20
#: plans predicted to read at least this many bytes are 'heavy': they
#: are preemptible at partition boundaries and never preempt others
ADMISSION_HEAVY_BYTES = 1 << 30

ADMISSION_TIERS = ("interactive", "batch", "heavy")


def _tier_threshold(env: str, default: float) -> float:
    """Operator override for a tier boundary (fleet tuning: a deploy
    whose 'interactive' latency budget maps to a different scan size
    than the defaults)."""
    import os

    raw = os.environ.get(env, "")
    if not raw:
        return float(default)
    try:
        return float(raw)
    except ValueError:
        return float(default)


def cost_tier(cost: "PlanCost") -> str:
    """Classify a PlanCost into an admission tier from its predicted
    scan bytes. Unknown row counts land in 'batch': admitted, queued
    behind interactive work, but never trusted to preempt. Boundaries
    are overridable via DEEQU_TPU_TIER_INTERACTIVE_BYTES and
    DEEQU_TPU_TIER_HEAVY_BYTES."""
    scan_bytes = cost.predicted_scan_bytes
    if scan_bytes is None:
        return "batch"
    if scan_bytes < _tier_threshold(
        "DEEQU_TPU_TIER_INTERACTIVE_BYTES", ADMISSION_INTERACTIVE_BYTES
    ):
        return "interactive"
    if scan_bytes >= _tier_threshold(
        "DEEQU_TPU_TIER_HEAVY_BYTES", ADMISSION_HEAVY_BYTES
    ):
        return "heavy"
    return "batch"


def cost_drift(cost: "PlanCost", trace: Any) -> Dict[str, float]:
    """Predicted-vs-observed drift per PlanCost field, from a RunTrace.

    Positive values mean the run did *more* than the planner predicted
    (extra passes/launches, more batches, wider wire rows). Keys:
    `drift.counter.<name>`, `drift.span.<name>`, `drift.family_groups`,
    and, when both sides are known, `drift.batches`,
    `drift.wire_bytes_first_batch` and the pins of pruning, decode
    routing, the C reader, the encoded fold, the state cache and the
    shard split. Feeds `engine.drift.*` in the telemetry record, so the
    sentinel watches the prediction's quality as a time series."""
    from deequ_tpu_torch.observe import compare  # lazy: lint imports without observe

    predicted = cost.dispatch_signature()
    observed = compare.dispatch_signature(trace)
    out: Dict[str, float] = {}
    for key in set(predicted["counters"]) | set(observed["counters"]):
        out[f"drift.counter.{key}"] = float(
            observed["counters"].get(key, 0) - predicted["counters"].get(key, 0)
        )
    for key in set(predicted["spans"]) | set(observed["spans"]):
        out[f"drift.span.{key}"] = float(
            observed["spans"].get(key, 0) - predicted["spans"].get(key, 0)
        )
    out["drift.family_groups"] = float(
        len(observed["family_groups"]) - len(predicted["family_groups"])
    )

    counters = trace.counters
    scan = cost.scan_pass
    if scan is not None:
        observed_batches = 0
        saw_batches = False
        first_wire: Optional[int] = None
        for sp in trace.spans():
            if sp.name in ("fused_scan", "dist_scan") and "batches" in sp.attrs:
                observed_batches += int(sp.attrs["batches"])
                saw_batches = True
            elif first_wire is None and sp.name == "dispatch" and "wire_bytes" in sp.attrs:
                first_wire = int(sp.attrs["wire_bytes"])
        if saw_batches:
            out["drift.batches"] = float(observed_batches - scan.n_batches)
        if first_wire is not None and scan.wire_bytes_per_batch is not None:
            out["drift.wire_bytes_first_batch"] = float(first_wire - scan.wire_bytes_per_batch)
        pins = (
            ("drift.rg_skipped", scan.rg_skipped, "rg_total", "rg_skipped"),
            ("drift.decode_cols_fast", scan.decode_cols_fast, "decode_cols_total", "decode_cols_fast"),
            ("drift.wire_fused_cols", scan.wire_fused_cols, "wire_cols_total", "wire_fused_cols"),
            (
                "drift.reader_chunks_native", scan.reader_chunks_native,
                "reader_chunks_total", "reader_chunks_native",
            ),
            ("drift.encfold_columns", scan.encfold_cols, "encfold_cols", "encfold_cols"),
        )
        for key, predicted_value, present, name in pins:
            if predicted_value is not None and present in counters:
                out[key] = float(int(counters.get(name, 0)) - predicted_value)
        if (
            scan.partitions_cached is not None
            and scan.partitions_total is not None
            and "partitions_total" in counters
        ):
            out["drift.partitions_cached"] = float(
                int(counters.get("partitions_cached", 0)) - scan.partitions_cached
            )
            out["drift.partitions_scanned"] = float(
                int(counters.get("partitions_scanned", 0))
                - (scan.partitions_total - scan.partitions_cached)
            )

    # the shard planner is deterministic: the observed split must equal
    # the predicted one exactly
    if cost.num_shards > 1 and "shard.count" in counters:
        out["drift.shard_count"] = float(int(counters.get("shard.count", 0)) - cost.num_shards)
        if cost.shard_partitions:
            out["drift.shard_partitions_max"] = float(
                int(counters.get("shard.partitions_max", 0)) - cost.shard_partitions_max
            )
    return out


# -- wire-format replay -------------------------------------------------------


#: bytes per row of an `ival` wire row, by the narrow dtype the wire
#: planner pinned (classify_wire_columns)
_IVAL_ITEMSIZE = {"int8": 1, "int16": 2, "int32": 4}


def _predict_packed_bytes(
    device_keys: Sequence[str],
    schema: SchemaInfo,
    rows: int,
    elided: frozenset = frozenset(),
    wire_specs: Optional[Dict[str, Any]] = None,
) -> Tuple[Optional[int], Tuple[str, ...]]:
    """Replay the port's `pack_batch_inputs` byte accounting for one
    batch of `rows` rows -> (the sum of `nbytes` of the buffers it
    returns, the keys predicted to ship as bit rows). Every row is
    padded to `runtime.wire_pad_size(rows)`; a bool mask ships as a bit
    row (padded / 8 bytes) unless it is all-true, which ships nothing;
    a float value row ships float64; an integer row ships range-narrowed.
    `elided` holds where-keys the pushdown interpreter proved all-true on
    every decoded group (the runtime swaps them for constant masks);
    `wire_specs` the decode-to-wire columns (ops/fused.py:
    classify_wire_columns), whose value rows ship in the width the
    planner pinned. The bytes are None for a key the model does not
    replay."""
    from deequ_tpu_torch.ops.runtime import wire_pad_size

    padded = wire_pad_size(rows)
    wire_specs = wire_specs or {}
    total = 0
    bits: List[str] = []
    for key in device_keys:
        if key == "where:<all>" or key in elided:
            continue
        if key.startswith("valid:"):
            fld = schema.field(key[len("valid:") :])
            if fld is not None and not fld.nullable:
                continue  # all-true mask: rebuilt on the device
            bits.append(key)
        elif key.startswith("prednn:") and prednn_elided(key[len("prednn:") :], schema):
            continue
        elif key.startswith(_MASK_PREFIXES):
            bits.append(key)
        elif key.startswith("num:"):
            spec = wire_specs.get(key[len("num:") :])
            if spec is not None and spec.value_kind == "ival":
                total += padded * _IVAL_ITEMSIZE[spec.value_dtype]
            else:
                total += padded * 8  # float64 values
        elif key.startswith("dtclass:"):
            total += padded  # int8 class codes stay int8
        elif key.startswith("hll:"):
            total += padded * 2  # 15-bit codes narrow to int16
        else:
            return None, tuple(bits)
    total += len(bits) * (padded // 8)
    return total, tuple(bits)


def _n_batches(num_rows: Optional[int], batch_size: int) -> int:
    if num_rows is None:
        return 1
    return max(1, math.ceil(num_rows / batch_size))


def _quantile_cap(analyzer: Any) -> Optional[int]:
    sample_size = getattr(analyzer, "_sample_size", None)
    if callable(sample_size):
        try:
            return int(sample_size())
        except Exception:  # noqa: BLE001
            return None
    return None


#: per-row bytes of intermediate host materialization the C decode
#: avoids for one column: the filled Arrow array copy (element width)
#: plus the bitmap-to-bool mask expansion (1 byte). Prediction only.
_DECODE_TOKEN_BYTES = {
    "double": 8, "float": 4, "int8": 1, "int16": 2, "int32": 4,
    "int64": 8, "uint8": 1, "uint16": 2, "uint32": 4, "uint64": 8,
    "bool": 1, "dictionary<string,int32>": 4,
}


def _token_bytes_per_row(columns, col_types: Dict[str, str]) -> int:
    """Bytes per row a column set's decode skips building (the value
    array and its mask byte per column), by the columns' Arrow tokens."""
    return sum(_DECODE_TOKEN_BYTES.get(col_types.get(c, ""), 0) + 1 for c in columns)


def _wire_saved_pack_bytes_per_row(wire_specs: Dict[str, Any]) -> int:
    """Bytes per row the pack no longer re-reads for the decode-to-wire
    columns: the Column's float64 value row and its bool mask."""
    return sum(
        (8 if spec.want_value else 0) + (1 if spec.want_valid else 0)
        for spec in wire_specs.values()
    )


def _decode_verdicts(
    scan_pass: PassCost,
    source: Any,
    specs: Dict[str, Any],
    member_plan: Any,
    live: Sequence[Any],
    prune_plan: Any,
    decoded_rows: Optional[int],
) -> Optional[Dict[str, Any]]:
    """The decode, decode-to-wire, reader and encoded-fold verdicts of
    the scan over `source`, from the runtime's own planner
    (`plan_decode_fastpath`) on the view the runtime plans over: the
    source without the pruned groups, restricted to the columns the
    live specs read. `member_plan` None is the mesh pass, which plans
    neither decode-to-wire nor the encoded fold. Fills `scan_pass`
    and returns the wire columns' specs (None when nothing planned)."""
    from deequ_tpu_torch.ops.fused import plan_decode_fastpath, prune_table_columns

    view = source
    if prune_plan is not None and prune_plan.skip and hasattr(view, "with_prune"):
        view = view.with_prune(prune_plan.skip)
    view = prune_table_columns(view, specs)
    dplan = plan_decode_fastpath(view, specs, member_plan=member_plan, analyzers=live)
    if dplan is None:
        return None
    col_types = view.decode_column_types()
    rows = decoded_rows

    def per_rows(nbytes: int) -> Optional[float]:
        return float(nbytes * rows) if rows is not None else None

    scan_pass.decode_cols_total = dplan.total
    scan_pass.decode_cols_fast = len(dplan.fast)
    scan_pass.decode_fallbacks = dplan.fallbacks
    scan_pass.decode_workers = 1  # the port decodes on one thread
    scan_pass.saved_decode_bytes = per_rows(_token_bytes_per_row(dplan.fast, col_types))
    if dplan.wire_planned:
        scan_pass.wire_fused_cols = len(dplan.wire_specs)
        scan_pass.wire_falloffs = dplan.wire_falloffs
        scan_pass.saved_pack_bytes = per_rows(_wire_saved_pack_bytes_per_row(dplan.wire_specs))
    if dplan.reader_planned:
        live_groups = (
            prune_plan.decoded_groups if prune_plan is not None else len(view.row_group_stats())
        )
        scan_pass.reader_chunks_native = len(dplan.reader_chunks)
        scan_pass.reader_chunks_total = dplan.total * live_groups
        scan_pass.reader_fallbacks = dplan.reader_falloffs
        scan_pass.saved_alloc_bytes = per_rows(_token_bytes_per_row(dplan.reader_cols, col_types))
    if dplan.enc_planned:
        scan_pass.encfold_cols = len(dplan.enc_specs)
        scan_pass.encfold_cols_total = dplan.total
        scan_pass.encfold_moment_cols = sum(
            1 for spec in dplan.enc_specs.values() if spec.publish_moments
        )
        scan_pass.encfold_falloffs = dplan.enc_falloffs
    return dplan.wire_specs or None


# -- the analyzer -------------------------------------------------------------


def analyze_plan(
    analyzers: Sequence[Any],
    schema: SchemaInfo,
    *,
    num_rows: Optional[int] = None,
    batch_size: Optional[int] = None,
    placement: Optional[str] = None,
    engine: str = "single",
    num_hosts: int = 1,
    num_shards: int = 1,
    shard_partitions: Optional[Sequence[int]] = None,
    num_devices: int = 1,
    streaming: bool = False,
    stream_batch_rows: Optional[int] = None,
    link_bandwidth: Optional[float] = None,
    pipeline_depth: Optional[int] = None,
    row_groups: Optional[Sequence[Any]] = None,
    source: Any = None,
    partitions: Optional[Sequence[Any]] = None,
    deadline_s: Optional[float] = None,
    device: Any = None,
) -> PlanCost:
    """Abstract interpretation of `AnalysisRunner.do_analysis_run`:
    dedupe -> static precondition filtering (zero-row table) ->
    grouping/scanning split -> the pure scan planner -> batching and
    wire math. Pure: no kernel runs, no row is read.

    `placement` defaults to `runtime.placement_mode(device)`, the run's
    own (on a CUDA device with ``DEEQU_TPU_PLACEMENT`` unset that reads,
    or takes, the link measurement the run takes too).

    `streaming=True` additionally predicts the stream pipeline's shape
    (`PlanCost.pipeline`): per-batch host vs wire seconds under the
    stated overlap model, with the link bandwidth taken from
    `link_bandwidth` or the placement probe's cache.
    `stream_batch_rows` is the source's own per-batch row cap
    (`ParquetSource.batch_rows`): a streamed source yields batches of
    `min(batch_size, batch_rows)` rows, so the batch count and per-batch
    wire bytes honor it.

    `row_groups` (a `lint/pushdown.RowGroupStats` sequence, from
    `ParquetSource.row_group_stats()`) switches the scan pass onto the
    pushdown model: batch count and first-batch rows come from an exact
    replay of the source's row-group iteration over the groups the
    runtime will actually decode, and the pass reports predicted
    skipped/decoded groups + saved read bytes.

    `source` (the Parquet-backed source itself) switches on the decode
    verdicts: `plan_decode_fastpath`, the runtime's own planner, runs
    over the pruned, column-pruned view of it, and the scan pass reports
    the C decode, decode-to-wire, reader and encoded-fold columns with
    the others' reasons. A decode-to-wire column's value row then enters
    the wire bytes in the width the planner pinned.

    `num_shards` / `shard_partitions` (per-shard partition counts in
    shard order, from `parallel/shard.plan_shards`) describe a sharded
    streaming scan, rendered in EXPLAIN's `shards:` line.

    `partitions` (per-partition `{"cached": bool, "bytes": int}` records
    from the runner's state-repository probe, partition order) switches
    on the partition-state-cache prediction: the scan pass reports how
    many partitions will load as cached states vs scan, and the file
    bytes the cached ones avoid reading."""
    from deequ_tpu_torch.analyzers.base import Preconditions, ScanShareableAnalyzer
    from deequ_tpu_torch.analyzers.frequency import (
        FrequencyBasedAnalyzer,
        ScanShareableFrequencyBasedAnalyzer,
    )
    from deequ_tpu_torch.analyzers.freq_spill import default_max_groups_in_memory
    from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer
    from deequ_tpu_torch.ops import pipeline, runtime
    from deequ_tpu_torch.ops.fused import (
        DEFAULT_BATCH_SIZE,
        elide_where_specs,
        group_family_jobs,
        plan_family_jobs,
    )

    compute_dtype = str(runtime.compute_dtype()).replace("torch.", "")

    # dedupe preserving order — same identity the runner uses
    seen: set = set()
    unique: List[Any] = []
    for a in analyzers:
        if a not in seen:
            seen.add(a)
            unique.append(a)

    # static precondition replay on the zero-row schema table
    empty = schema.empty_table()
    passed: List[Any] = []
    failures: List[Tuple[str, str]] = []
    for a in unique:
        try:
            err = Preconditions.find_first_failing(empty, a.preconditions())
        except Exception as e:  # noqa: BLE001
            err = e
        if err is None:
            passed.append(a)
        else:
            failures.append((repr(a), f"{type(err).__name__}: {err}"))

    grouping = [a for a in passed if isinstance(a, GroupingAnalyzer)]
    scanning = [a for a in passed if not isinstance(a, GroupingAnalyzer)]
    shareable = [a for a in scanning if isinstance(a, ScanShareableAnalyzer)]
    solo = [a for a in scanning if not isinstance(a, ScanShareableAnalyzer)]

    cost = PlanCost(
        placement=placement or runtime.placement_mode(device),
        compute_dtype=compute_dtype,
        engine=engine,
        num_rows=num_rows,
        batch_size=batch_size,
        analyzers=tuple(repr(a) for a in unique),
        precondition_failures=tuple(failures),
        num_hosts=max(1, int(num_hosts)),
        num_shards=max(1, int(num_shards)),
        shard_partitions=tuple(int(c) for c in (shard_partitions or ())),
        counters={k: 0 for k in COUNTERS},
        span_counts={k: 0 for k in EXECUTION_SPANS},
        deadline_s=float(deadline_s) if deadline_s is not None else None,
    )
    spans = cost.span_counts
    counters = cost.counters
    distributed = engine == "distributed"
    num_devices = max(1, int(num_devices))

    # ---- the fused scan pass ------------------------------------------------
    if shareable:
        plan, effects = scan_effects(shareable, mode=cost.placement)
        cost.effects = tuple(effects)
        use_device = bool(plan.merge_idx or plan.assisted_idx)
        live_idx = plan.merge_idx + plan.assisted_idx + plan.host_idx + plan.host_assisted_idx
        any_members = bool(live_idx)

        if distributed:
            eff_batch = (batch_size or (1 << 21)) * num_devices
        else:
            eff_batch = batch_size or DEFAULT_BATCH_SIZE
            if (
                not use_device
                and not streaming
                and batch_size is None
                and num_rows is not None
            ):
                # pure host fold over an in-memory table widens to one
                # batch (FusedScanPass._run_pass host-widening rule;
                # streamed sources never widen)
                eff_batch = max(eff_batch, min(num_rows, 1 << 24))
        # a streaming source caps each batch at its own batch_rows
        # (data/source.py: min(batch_size, batch_rows))
        per_batch = eff_batch
        if streaming and stream_batch_rows:
            per_batch = min(per_batch, int(stream_batch_rows))
        batches = _n_batches(num_rows, per_batch)

        # ---- row-group pushdown (parquet statistics available) ----------
        # Mirrors the runtime decision point exactly: FusedScanPass
        # prunes with the wheres of the LIVE members (spec errors are
        # already out), gated on the same knob this prediction reads.
        prune_plan = None
        pushdown_on = runtime.pushdown_enabled()
        batch_rows_list: Optional[Tuple[int, ...]] = None
        if row_groups and streaming and any_members:
            from deequ_tpu_torch.lint.pushdown import build_prune_plan, types_from_schema

            try:
                prune_plan = build_prune_plan(
                    [getattr(shareable[i], "where", None) for i in live_idx],
                    row_groups,
                    types_from_schema(schema),
                )
            except Exception:  # noqa: BLE001 — prediction only, never fatal
                prune_plan = None
        if prune_plan is not None:
            cost.prune = prune_plan
            batch_rows_list = prune_plan.predicted_batch_rows(
                per_batch, pruned=pushdown_on
            )
            # the decode replay is exact even without any skip: it
            # models the source's tiny-group coalescing, which plain
            # ceil(num_rows / per_batch) cannot
            batches = max(1, len(batch_rows_list))

        device_keys = sorted(plan.device_keys)
        scan_columns: List[str] = []
        for eff in effects:
            for c in eff.columns:
                if c not in scan_columns:
                    scan_columns.append(c)

        host_assisted_members = [shareable[i] for i in plan.host_assisted_idx]
        host_only_members = [shareable[i] for i in plan.host_idx]
        jobs = plan_family_jobs(host_assisted_members, host_only_members)
        groups = group_family_jobs(jobs)
        family_groups = tuple(
            FamilyGroupCost(
                where=key[0],
                cap=key[1],
                # family kernels consume `numeric_values()` host arrays,
                # which are float64 regardless of the device dtype
                dtype="float64",
                columns=tuple(j.column for j in grp),
                batched=len(grp) > 1,
                want_regs=any(j.want_regs for j in grp),
            )
            for key, grp in groups
        )

        first_rows = (
            min(num_rows, per_batch) if num_rows is not None else per_batch
        )
        elided_keys: frozenset = frozenset()
        if batch_rows_list is not None:
            first_rows = batch_rows_list[0] if batch_rows_list else 0
        specs_eff = dict(plan.specs)
        if prune_plan is not None and pushdown_on:
            elide_where_specs(specs_eff, prune_plan.elided_wheres())
            elided_keys = frozenset(
                k for k, spec in specs_eff.items() if spec is not plan.specs[k]
            )

        notes: List[str] = []
        if plan.spec_errors:
            notes.append(f"{len(plan.spec_errors)} member(s) fail at spec build")
        scan_pass = PassCost(
            kind="scan",
            label="fused scan",
            analyzers=tuple(repr(a) for a in shareable),
            columns=tuple(scan_columns),
            device_members=len(plan.merge_idx) + len(plan.assisted_idx),
            host_members=len(plan.host_idx) + len(plan.host_assisted_idx),
            input_keys=tuple(device_keys),
            read_bytes_per_row=pass_read_bytes_per_row(scan_columns, schema),
            wire_bytes_per_row=(
                pass_wire_bytes_per_row(device_keys, schema, 8)
                if use_device
                else 0.0
            ),
            n_batches=batches,
            family_groups=family_groups,
            notes=tuple(notes),
        )
        if prune_plan is not None:
            scan_pass.rg_total = prune_plan.total_groups
            scan_pass.rg_skipped = (
                prune_plan.skipped_groups if pushdown_on else 0
            )
            scan_pass.saved_read_bytes = (
                scan_pass.read_bytes_per_row * prune_plan.skipped_rows
                if pushdown_on
                else 0.0
            )

        # ---- decode verdicts (a Parquet-backed source) -------------------
        # The runtime's own planner over the view the runtime plans over,
        # after the same elision and pruning; the mesh pass plans with no
        # member plan (no decode-to-wire, no encoded fold).
        wire_specs = None
        if source is not None and any_members and hasattr(source, "decode_column_types"):
            decoded_rows = num_rows
            if decoded_rows is not None and prune_plan is not None and pushdown_on:
                decoded_rows = max(0, decoded_rows - prune_plan.skipped_rows)
            wire_specs = _decode_verdicts(
                scan_pass,
                source,
                specs_eff,
                None if distributed else plan,
                None if distributed else [shareable[i] for i in live_idx],
                prune_plan if pushdown_on else None,
                decoded_rows,
            )
        wire_exact: Optional[int] = 0
        if use_device and distributed:
            wire_exact = None  # each shard packs its own slice
        elif use_device:
            wire_exact, scan_pass.wire_bit_keys = _predict_packed_bytes(
                device_keys, schema, first_rows, elided=elided_keys, wire_specs=wire_specs
            )
        scan_pass.wire_bytes_per_batch = wire_exact
        cost.passes.append(scan_pass)

        if streaming:
            depth = pipeline_depth if pipeline_depth is not None else pipeline.DEPTH
            bw = link_bandwidth
            if bw is None and use_device and device is not None:
                resolved = runtime.resolve_device(device)
                if resolved.type == "cuda":
                    bw = runtime._load_bandwidth_from_disk(runtime._platform_key(resolved))
            read_per_batch = scan_pass.read_bytes_per_row * first_rows
            host_s = (
                read_per_batch / PIPELINE_HOST_BYTES_PER_S
                if read_per_batch > 0
                else None
            )
            if not use_device:
                wire_s: Optional[float] = 0.0
            elif wire_exact is not None and bw:
                wire_s = wire_exact / float(bw)
            else:
                wire_s = None  # unreplayed wire or unmeasured link
            serial = overlapped = bottleneck = None
            if host_s is not None and wire_s is not None:
                serial = host_s + wire_s
                overlapped = max(host_s, wire_s)
                bottleneck = "transfer" if wire_s > host_s else "host"
            cost.pipeline = PipelineCost(
                enabled=runtime.pipeline_enabled(),
                queue_depth=depth,
                n_batches=batches,
                wire_bytes_per_batch=wire_exact if use_device else 0,
                link_bandwidth=bw,
                host_s_per_batch=host_s,
                wire_s_per_batch=wire_s,
                serial_s_per_batch=serial,
                overlapped_s_per_batch=overlapped,
                bottleneck=bottleneck,
            )

        if any_members:
            counters["device_passes"] += 1
            spans["host_fold"] += batches
            if distributed:
                spans["dist_scan"] += 1
            else:
                spans["fused_scan"] += 1
            if use_device:
                # the mesh pass runs one program per shard and batch
                counters["device_launches"] += batches * (num_devices if distributed else 1)
                spans["dispatch"] += batches
                spans["transfer"] += batches
                spans["merge"] += batches
            spans["family_kernel"] += len(groups) * batches
        if not distributed:
            spans["plan_fuse"] += 1
        if cost.num_hosts > 1 and any_members:
            cost.allgather_rounds = 1
            spans["state_allgather"] += 1

    # ---- solo scanning analyzers (their own pass each) ----------------------
    for a in solo:
        cols = analyzer_read_columns(a)
        cost.passes.append(
            PassCost(
                kind="aux",
                label=f"solo scan: {getattr(a, 'name', type(a).__name__)}",
                analyzers=(repr(a),),
                columns=cols,
                read_bytes_per_row=pass_read_bytes_per_row(cols, schema),
                n_batches=1,
                notes=("runs outside the shared pass",),
            )
        )
        # Histogram's vectorized group pass records a group_pass counter
        if getattr(a, "name", "") == "Histogram":
            counters["group_passes"] += 1

    # ---- grouping passes (one frequency pass per column set) ----------------
    freq_based = [a for a in grouping if isinstance(a, FrequencyBasedAnalyzer)]
    other_grouping = [
        a for a in grouping if not isinstance(a, FrequencyBasedAnalyzer)
    ]
    sets: Dict[Tuple[str, ...], List[Any]] = {}
    for a in freq_based:
        sets.setdefault(tuple(sorted(a.grouping_columns())), []).append(a)

    max_groups = default_max_groups_in_memory()
    for cols, group in sets.items():
        est: Optional[int] = 1
        for c in cols:
            fld = schema.field(c)
            if fld is None or fld.approx_distinct is None:
                est = None
                break
            est *= max(1, int(fld.approx_distinct))
        freq_shareable = [
            a for a in group if isinstance(a, ScanShareableFrequencyBasedAnalyzer)
        ]
        freq_solo = [
            a
            for a in group
            if not isinstance(a, ScanShareableFrequencyBasedAnalyzer)
        ]
        notes = []
        spill = est is not None and est > max_groups
        if spill:
            notes.append(
                f"~{est} groups exceeds the in-memory budget ({max_groups}): "
                "the frequency state will spill to disk"
            )
        cost.passes.append(
            PassCost(
                kind="grouping",
                label=f"grouping pass over ({', '.join(cols)})",
                analyzers=tuple(repr(a) for a in group),
                columns=cols,
                read_bytes_per_row=pass_read_bytes_per_row(cols, schema),
                n_batches=1,
                estimated_groups=est,
                spill_risk=spill,
                notes=tuple(notes),
            )
        )
        spans["grouping"] += 1
        spans["group_pass"] += 1
        counters["group_passes"] += 1
        if freq_shareable:
            spans["freq_agg"] += 1
            counters["device_passes"] += 1
            # the shared aggregation always runs on the run's device
            # (ops/freq_agg.py): once over the counts in memory
            counters["device_launches"] += 1
        # non-shareable frequency analyzers (e.g. MutualInformation)
        # each take an extra aggregation pass over the counts
        counters["device_passes"] += len(freq_solo)

    for a in other_grouping:
        cols = analyzer_read_columns(a)
        cost.passes.append(
            PassCost(
                kind="aux",
                label=f"grouping (own pass): {getattr(a, 'name', type(a).__name__)}",
                analyzers=(repr(a),),
                columns=cols,
                read_bytes_per_row=pass_read_bytes_per_row(cols, schema),
            )
        )

    # ---- partition-state cache (partitioned parquet sources) ---------------
    # `partitions` records ({"cached": bool, "bytes": int}, partition
    # order) come from the runner's pre-scan repository probe with the
    # exact fingerprint + plan signature the fused pass will use
    if partitions is not None:
        scan = cost.scan_pass
        if scan is not None:
            cached = [p for p in partitions if p.get("cached")]
            scan.partitions_total = len(partitions)
            scan.partitions_cached = len(cached)
            scan.saved_partition_bytes = float(
                sum(int(p.get("bytes", 0)) for p in cached)
            )

    cost.admission_tier = cost_tier(cost)
    return cost


__all__ = [
    "ADMISSION_HEAVY_BYTES",
    "ADMISSION_INTERACTIVE_BYTES",
    "ADMISSION_TIERS",
    "COUNTERS",
    "EXECUTION_SPANS",
    "PIPELINE_HOST_BYTES_PER_S",
    "FamilyGroupCost",
    "PassCost",
    "PipelineCost",
    "PlanCost",
    "analyze_plan",
    "cost_drift",
    "cost_tier",
]
