"""EXPLAIN for analysis plans: the human-readable report over the
static cost model (lint/cost.py) plus the DQ300-DQ304 performance
diagnostics.

`explain_plan(data_or_schema, analyzers=..., checks=...)` is the public
entrypoint: it predicts the execution shape (passes, batches, wire
bytes, family groups) without scanning a row, lints the plan for
performance anti-patterns, and renders both as a report. The same
diagnostics feed `validate_plan` when a row-count is known, so strict
runs aggregate DQ3xx warnings next to DQ1xx/DQ2xx errors.

The port's copy of deequ_tpu/lint/explain.py: it renders the port's own
cost model, and the failure-forensics capability lines (DQ316) from the
capture's own classification (observe/forensics.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.data.expr import (
    Bin,
    ExpressionParseError,
    Un,
    normalize_expression,
    parse,
)
from deequ_tpu_torch.lint.cost import PassCost, PlanCost, analyze_plan, _quantile_cap
from deequ_tpu_torch.lint.diagnostics import Diagnostic, Severity
from deequ_tpu_torch.lint.fold import satisfiability
from deequ_tpu_torch.lint.schema import SchemaInfo

#: DQ302: a quantile sketch cap at/above this many sample slots per
#: (column, where) family dominates the scan's host working set
DQ302_CAP_LIMIT = 1 << 20

#: DQ303: native family kernels tile the scan in SD_MC_BLOCK=4096-row
#: blocks; one tile's working set (values + valid + mask bytes per
#: column) above this budget thrashes L2 and serializes the multi-column
#: batch. ~1 MiB: half a typical per-core L2.
DQ303_TILE_ROWS = 4096
DQ303_TILE_BUDGET_BYTES = 1 << 20

#: DQ304: an explicit batch size below this floor with more than this
#: many batches pays per-dispatch latency per handful of rows
DQ304_MIN_BATCH = 1 << 16
DQ304_MAX_BATCHES = 8

_MAX_PAIRWISE_WHERES = 32


def _implied(a: Any, b: Any, schema: Optional[SchemaInfo]) -> bool:
    """True when predicate `a` admits no TRUE row that `b` excludes —
    i.e. the filter masks agree on every row (Kleene: NULL rows are
    excluded by both sides already)."""
    verdict = satisfiability(Bin("and", a, Un("not", b)), schema)
    return verdict in ("unsat", "null-only")


def cost_diagnostics(
    cost: PlanCost,
    analyzers: Sequence[Any] = (),
    schema: Optional[SchemaInfo] = None,
    *,
    quota_scan_bytes: Optional[float] = None,
) -> List[Diagnostic]:
    """The DQ300-DQ304 performance lints over a computed `PlanCost`.

    `quota_scan_bytes` — the tenant's scan-bytes-per-window budget,
    when known (the DQService admission path supplies it) — arms the
    DQ319 never-admittable lint."""
    diags: List[Diagnostic] = []
    scan = cost.scan_pass
    scan_columns = set(scan.columns) if scan is not None else set()

    # DQ300 — a solo-pass analyzer re-reads columns the shared scan
    # already covers: its work could ride the fused pass
    if scan is not None and scan_columns:
        for p in cost.passes:
            if p.kind != "aux" or not p.columns:
                continue
            if set(p.columns) <= scan_columns:
                diags.append(
                    Diagnostic(
                        "DQ300",
                        Severity.WARNING,
                        f"{p.label} re-reads column(s) "
                        f"{', '.join(sorted(p.columns))} that the shared "
                        "scan pass already reads — an extra full pass "
                        "over data the plan touches anyway",
                        subject=p.analyzers[0] if p.analyzers else None,
                    )
                )

    # DQ301 — where-clauses that are provably equivalent but normalize
    # differently: they split the fused (where, cap) family groups and
    # duplicate mask inputs, where one spelling would share both
    by_norm: Dict[str, Tuple[str, Any]] = {}
    for analyzer in analyzers:
        where = getattr(analyzer, "where", None)
        if not isinstance(where, str):
            continue
        try:
            key = normalize_expression(where)
            ast = parse(where)
        except ExpressionParseError:
            continue
        by_norm.setdefault(key, (where, ast))
    norms = list(by_norm.items())
    if 1 < len(norms) <= _MAX_PAIRWISE_WHERES:
        for i in range(len(norms)):
            for j in range(i + 1, len(norms)):
                (_, (ti, ai)), (_, (tj, aj)) = norms[i], norms[j]
                if _implied(ai, aj, schema) and _implied(aj, ai, schema):
                    diags.append(
                        Diagnostic(
                            "DQ301",
                            Severity.WARNING,
                            f"where-clauses {ti!r} and {tj!r} are "
                            "semantically equivalent but spelled "
                            "differently: they transfer two masks and "
                            "split one fused family group into two "
                            "kernel dispatches",
                            suggestion=ti,
                        )
                    )

    # DQ302 — blowup: an extreme quantile cap, or a grouping pass whose
    # estimated cardinality exceeds the in-memory group budget
    for analyzer in analyzers:
        cap = _quantile_cap(analyzer)
        if cap is not None and cap >= DQ302_CAP_LIMIT:
            diags.append(
                Diagnostic(
                    "DQ302",
                    Severity.WARNING,
                    f"quantile sketch cap {cap} (from relative_error="
                    f"{getattr(analyzer, 'relative_error', '?')}) holds "
                    f"{cap} sample slots per (column, where) family — "
                    "the sketch stops being a sketch; relax "
                    "relative_error",
                    subject=repr(analyzer),
                )
            )
    for p in cost.passes:
        if p.kind == "grouping" and p.spill_risk:
            diags.append(
                Diagnostic(
                    "DQ302",
                    Severity.WARNING,
                    f"grouping over ({', '.join(p.columns)}) is estimated "
                    f"at ~{p.estimated_groups} groups — beyond the "
                    "in-memory budget; the frequency state will spill to "
                    "disk partition by partition",
                )
            )

    # DQ303 — one family-kernel group's cache tile outgrows the budget:
    # too many columns batched into one (where, cap) traversal
    if scan is not None:
        itemsize = 8 if cost.compute_dtype == "float64" else 4
        for g in scan.family_groups:
            tile = DQ303_TILE_ROWS * (len(g.columns) * (itemsize + 1) + 1)
            if tile > DQ303_TILE_BUDGET_BYTES:
                diags.append(
                    Diagnostic(
                        "DQ303",
                        Severity.WARNING,
                        f"family group (where={g.where!r}, cap={g.cap}) "
                        f"batches {len(g.columns)} columns: one "
                        f"{DQ303_TILE_ROWS}-row tile needs ~{tile} bytes, "
                        f"over the {DQ303_TILE_BUDGET_BYTES}-byte cache "
                        "budget — split the plan or the where groups",
                    )
                )

    # DQ304 — transfer-per-row anti-pattern: a tiny explicit batch size
    # turns one streaming scan into many per-dispatch round-trips
    if (
        scan is not None
        and scan.device_members > 0
        and cost.batch_size is not None
        and cost.batch_size < DQ304_MIN_BATCH
        and scan.n_batches > DQ304_MAX_BATCHES
    ):
        diags.append(
            Diagnostic(
                "DQ304",
                Severity.WARNING,
                f"batch_size={cost.batch_size} dispatches "
                f"{scan.n_batches} device round-trips for this row "
                "count; below ~65536 rows/batch the per-dispatch "
                "latency dominates the wire time — raise batch_size",
            )
        )

    # DQ305 — the stream pipeline's queue depth cannot hide the measured
    # H2D transfer latency: one batch's wire time exceeds `depth` batches
    # of host (decode+prep) work, so however the stages interleave the
    # fold stage starves on transfer (cost.PipelineCost overlap model)
    pipe = cost.pipeline
    if (
        pipe is not None
        and pipe.enabled
        and scan is not None
        and scan.device_members > 0
        and scan.n_batches > 1
        and pipe.depth_hides_transfer is False
    ):
        diags.append(
            Diagnostic(
                "DQ305",
                Severity.WARNING,
                f"stream-pipeline queue depth {pipe.queue_depth} cannot "
                f"hide the measured H2D transfer: one batch's wire time "
                f"(~{pipe.wire_s_per_batch:.3g}s at the measured "
                f"{pipe.link_bandwidth:.3g} B/s link) exceeds "
                f"{pipe.queue_depth}x the per-batch host work "
                f"(~{pipe.host_s_per_batch:.3g}s) — raise "
                "DEEQU_TPU_PIPELINE_DEPTH or batch_size, or shed wire "
                "bytes (host placement folds discrete members without "
                "a transfer)",
            )
        )

    # DQ310/DQ311 — row-group pushdown (lint/pushdown.py). DQ310: a
    # where filter the interpreter cannot reason about, anchored on the
    # offending subexpression; DQ311: the statistics prove every group
    # skippable — a scan that decodes nothing almost always means a
    # misconfigured suite (wrong column, impossible range, stale file)
    prune = cost.prune
    if prune is not None:
        for p in prune.predicates:
            if not p.eligible:
                diags.append(
                    Diagnostic(
                        "DQ310",
                        Severity.WARNING,
                        f"where filter {p.where!r} is not pushdown-"
                        f"eligible ({p.reason}): every row group decodes "
                        "and filters at runtime even when statistics "
                        "could have excluded it",
                        source=p.where,
                        span=p.span,
                    )
                )
        if prune.proven_empty:
            diags.append(
                Diagnostic(
                    "DQ311",
                    Severity.WARNING,
                    "row-group statistics prove every where filter FALSE "
                    f"on all {prune.total_groups} row group(s): every "
                    "filtered metric is empty (one sentinel group still "
                    "decodes to keep results identical to an unpruned "
                    "scan) — check the predicates against the data's "
                    "actual ranges (wrong column, impossible range, or a "
                    "stale file)",
                )
            )

    # DQ312 — decode fast path: columns that fall off the buffer-level
    # native decode keep the multi-pass host from_arrow chain. Each is
    # named with the planner's reason (the same classifier the runtime
    # routes with), so the fix — recast a decimal/timestamp upstream, or
    # stop consuming host string values — is actionable per column.
    if scan is not None and scan.decode_fallbacks:
        for col, reason in scan.decode_fallbacks:
            diags.append(
                Diagnostic(
                    "DQ312",
                    Severity.WARNING,
                    f"column {col!r} falls off the decode fast path "
                    f"({reason}): it decodes through the multi-pass host "
                    "chain while fast-path columns decode in one native "
                    "pass",
                    source=col,
                )
            )

    # DQ313 — decode-to-wire fusion: fast-path columns that still build
    # the Column intermediate because a consumer needs it. The planner's
    # reason names the offending consumer key when there is one, and the
    # caret lands on it — so the fix (drop the host re-read, move the
    # member onto the compiled reduce) is actionable per column.
    if scan is not None and scan.wire_falloffs:
        for col, reason, key in scan.wire_falloffs:
            diags.append(
                Diagnostic(
                    "DQ313",
                    Severity.WARNING,
                    f"column {col!r} decodes to a host Column instead of "
                    f"fusing straight to the wire ({reason}): its pack "
                    "re-reads the decoded arrays every batch",
                    source=key or col,
                    span=(0, len(key)) if key else None,
                )
            )

    # DQ315 — native parquet reader: fast-path columns whose column-
    # chunks still decode through arrow because a page encoding, codec,
    # or physical layout has no native decoder. The reason names the
    # disqualifying property, so the fix — re-encode the file with
    # PLAIN/RLE-dictionary pages and snappy/zstd, or flatten the nested
    # column — is actionable per column.
    if scan is not None and scan.reader_fallbacks:
        for col, reason in scan.reader_fallbacks:
            diags.append(
                Diagnostic(
                    "DQ315",
                    Severity.WARNING,
                    f"column {col!r} falls off the native parquet reader "
                    f"({reason}): its pages decompress and decode through "
                    "arrow instead of the page-to-wire path",
                    source=col,
                )
            )

    # DQ325 — encoded fold: reader columns whose chunks still expand to
    # row width because a codec property, consumer analyzer, dtype, or
    # dictionary-size condition keeps the run-fold kernels off. The
    # reason names the disqualifying property with its class prefix
    # (codec:/analyzer:/dtype:/dict-size:), so the fix — rewrite the
    # file with dictionary pages, drop the row-width consumer, or move
    # the member off the device — is actionable per column.
    if scan is not None and scan.encfold_falloffs:
        for col, reason in scan.encfold_falloffs:
            diags.append(
                Diagnostic(
                    "DQ325",
                    Severity.WARNING,
                    f"column {col!r} falls off the encoded fold "
                    f"({reason}): its chunks expand to row width instead "
                    "of folding over (run, code) streams",
                    source=col,
                )
            )

    # DQ318 — a deadline over a source with no partition boundaries:
    # nothing commits to the state repository mid-run, so a deadline
    # trip loses ALL scanned work — the rerun starts from zero instead
    # of resuming at the partitions already folded
    if cost.deadline_s is not None and (
        scan is None or scan.partitions_total is None
    ):
        diags.append(
            Diagnostic(
                "DQ318",
                Severity.WARNING,
                f"deadline {cost.deadline_s:g}s set but the source has no "
                "partition boundaries: a deadline trip discards all "
                "progress (a partitioned source + StateRepository resumes "
                "at the partitions already committed)",
            )
        )

    # DQ319 — the plan can NEVER be admitted under the tenant's quota:
    # its predicted scan bytes exceed the whole bytes-per-window budget,
    # so admission control rejects it every time (DQ410) no matter how
    # empty the window is — the plan must shrink (filters that push
    # down, cached partitions, fewer columns) or the quota must grow
    if quota_scan_bytes is not None:
        predicted = cost.predicted_scan_bytes
        if predicted is not None and predicted > float(quota_scan_bytes):
            diags.append(
                Diagnostic(
                    "DQ319",
                    Severity.WARNING,
                    f"plan predicts ~{predicted:.0f} scan bytes but the "
                    f"tenant's quota window admits at most "
                    f"{float(quota_scan_bytes):.0f}: this plan can never "
                    "be admitted (rejected DQ410 at every submission) — "
                    "shed read bytes (pushdown-eligible filters, fewer "
                    "columns, a partitioned source with cached states) "
                    "or raise the tenant's scan-bytes quota",
                )
            )
    return diags


# -- rendering ----------------------------------------------------------------


def _fmt_bytes(n: Optional[float]) -> str:
    if n is None:
        return "?"
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if value < 1024 or unit == "GiB":
            return f"{value:.1f} {unit}" if unit != "B" else f"{int(value)} B"
        value /= 1024
    return f"{value:.1f} GiB"


def _render_pass(p: PassCost, idx: int) -> List[str]:
    lines = [f"Pass {idx}: {p.label}  [{p.kind}]"]
    if p.analyzers:
        lines.append(f"  members: {len(p.analyzers)} "
                     f"(device {p.device_members}, host {p.host_members})"
                     if p.kind == "scan" else f"  members: {len(p.analyzers)}")
    if p.columns:
        lines.append(f"  reads: {', '.join(p.columns)} "
                     f"(~{p.read_bytes_per_row:g} B/row)")
    if p.input_keys:
        lines.append(f"  device inputs: {len(p.input_keys)} key(s), "
                     f"~{p.wire_bytes_per_row:g} wire B/row")
    if p.kind == "scan":
        lines.append(f"  batches: {p.n_batches}"
                     + (f", first-batch wire {_fmt_bytes(p.wire_bytes_per_batch)}"
                        if p.wire_bytes_per_batch is not None else ""))
        if p.partitions_total is not None and p.partitions_cached is not None:
            lines.append(
                f"  partitions: {p.partitions_cached} cached, "
                f"{p.partitions_total - p.partitions_cached} scanned"
                + (f" (saves ~{_fmt_bytes(p.saved_partition_bytes)} read)"
                   if p.saved_partition_bytes else "")
            )
        if p.rg_total is not None and p.rg_skipped is not None:
            lines.append(
                f"  row groups: {p.rg_total - p.rg_skipped} decoded, "
                f"{p.rg_skipped} skipped statically"
                + (f" (saves ~{_fmt_bytes(p.saved_read_bytes)} decode)"
                   if p.saved_read_bytes else "")
            )
        if p.decode_cols_total is not None and p.decode_cols_fast is not None:
            line = (
                f"  decode: {p.decode_cols_fast}/{p.decode_cols_total} "
                "column(s) on the native fast path"
            )
            if p.decode_workers is not None:
                line += f", {p.decode_workers} worker(s)"
            if p.saved_decode_bytes:
                line += (
                    f" (avoids ~{_fmt_bytes(p.saved_decode_bytes)} "
                    "intermediate)"
                )
            lines.append(line)
        if p.wire_fused_cols is not None and p.decode_cols_total is not None:
            line = (
                f"  wire: {p.wire_fused_cols}/{p.decode_cols_total} "
                "column(s) fused at decode"
            )
            if p.saved_pack_bytes:
                line += f" (skips ~{_fmt_bytes(p.saved_pack_bytes)} pack)"
            lines.append(line)
        if p.reader_chunks_total is not None and p.reader_chunks_native is not None:
            line = (
                f"  reader: {p.reader_chunks_native}/{p.reader_chunks_total} "
                "column-chunks native"
            )
            if p.decode_workers is not None:
                line += f", {p.decode_workers} worker(s)"
            if p.saved_alloc_bytes:
                line += (
                    f" (avoids ~{_fmt_bytes(p.saved_alloc_bytes)} "
                    "arrow materialization)"
                )
            lines.append(line)
        if p.encfold_cols is not None and p.encfold_cols_total is not None:
            moments = p.encfold_moment_cols or 0
            lines.append(
                f"  encoded-fold: {p.encfold_cols}/{p.encfold_cols_total} "
                f"column(s) (runs={moments}, "
                f"dict={p.encfold_cols - moments})"
            )
        for g in p.family_groups:
            tag = "batched" if g.batched else "solo"
            lines.append(
                f"  family group (where={g.where!r}, cap={g.cap}): "
                f"{len(g.columns)} column(s) [{tag}]"
                + (" +hll" if g.want_regs else "")
            )
    if p.estimated_groups is not None:
        lines.append(f"  estimated groups: ~{p.estimated_groups}"
                     + ("  !! spill" if p.spill_risk else ""))
    for note in p.notes:
        lines.append(f"  note: {note}")
    return lines


def sharing_diagnostics(
    proof: Any, analyzers: Sequence[Any] = ()
) -> List[Diagnostic]:
    """DQ321/DQ322 over a `lint.subsume.SubsumptionProof` — one DQ321
    when the suite provably rides a shared scan, else one DQ322 per
    undischarged obligation with the caret on the offending where."""
    diags: List[Diagnostic] = []
    if proof is None:
        return diags
    if proof.contained:
        diags.append(
            Diagnostic(
                "DQ321",
                Severity.WARNING,
                "suite is provably contained in the candidate shared "
                f"scan — {proof.summary()}; one superset scan computes "
                "these metrics bit-identically over the state semigroup",
            )
        )
        return diags
    for mismatch in proof.env_mismatches:
        diags.append(
            Diagnostic(
                "DQ322",
                Severity.WARNING,
                "scan sharing declined: plan environments are "
                f"incomparable ({mismatch}) — states folded under "
                "different arithmetic are never merged",
            )
        )
    for obligation in proof.obligations:
        if obligation.satisfied:
            continue
        where = obligation.where
        diags.append(
            Diagnostic(
                "DQ322",
                Severity.WARNING,
                "scan sharing declined: "
                + (obligation.detail or "obligation not provably contained"),
                source=where,
                span=(0, len(where)) if where else None,
                subject=obligation.analyzer,
            )
        )
    return diags


def render_explain(
    cost: PlanCost,
    diagnostics: Sequence[Diagnostic] = (),
    sharing: Optional[str] = None,
) -> str:
    """The EXPLAIN report: predicted execution shape, then diagnostics.

    `sharing` — the one-line subsumption-proof summary
    (`SubsumptionProof.summary()`) when the plan was checked against a
    candidate shared scan; rendered as the `sharing:` line."""
    head = [
        "== Plan explain (static — no data scanned) ==",
        f"analyzers: {len(cost.analyzers)}   placement: {cost.placement}   "
        f"engine: {cost.engine}   compute dtype: {cost.compute_dtype}",
        f"rows: {cost.num_rows if cost.num_rows is not None else '?'}   "
        f"batch_size: {cost.batch_size if cost.batch_size is not None else 'default'}",
    ]
    if cost.num_hosts > 1:
        head.append(
            f"hosts: {cost.num_hosts}   allgather rounds: {cost.allgather_rounds}"
        )
    if cost.num_shards > 1:
        total = sum(cost.shard_partitions)
        per = -(-total // cost.num_shards) if total else 0  # ceil
        head.append(
            f"shards: {cost.num_shards} processes × {per} partitions each "
            f"(max skew {cost.shard_skew:.2f})"
        )
    if cost.precondition_failures:
        head.append(
            f"precondition failures: {len(cost.precondition_failures)} "
            "analyzer(s) will fail without scanning"
        )
        for rep, err in cost.precondition_failures:
            head.append(f"  - {rep}: {err}")
    body: List[str] = []
    for i, p in enumerate(cost.passes, 1):
        body.extend(_render_pass(p, i))
    if not cost.passes:
        body.append("(no passes: nothing to compute)")
    pipe = cost.pipeline
    if pipe is not None:
        state = "on" if pipe.enabled else "off (DEEQU_TPU_PIPELINE=0)"
        body.append(
            f"stream pipeline: {state}   depth: {pipe.queue_depth}   "
            f"stages: {' > '.join(pipe.stages)}"
        )
        if pipe.serial_s_per_batch is not None:
            body.append(
                f"  per-batch: host ~{pipe.host_s_per_batch:.3g}s "
                f"+ wire ~{pipe.wire_s_per_batch:.3g}s  ->  "
                f"overlapped ~{pipe.overlapped_s_per_batch:.3g}s "
                f"(serial ~{pipe.serial_s_per_batch:.3g}s, "
                f"bottleneck: {pipe.bottleneck})"
            )
        elif pipe.wire_s_per_batch is None and pipe.wire_bytes_per_batch:
            body.append(
                "  per-batch wire time unmeasured "
                "(no cached link-bandwidth probe)"
            )
    if cost.window_spec is not None:
        body.append(
            f"windows: {cost.window_spec} -> "
            f"{cost.window_segments_merged} segment merges, "
            f"{cost.window_partitions_rescanned} partitions rescanned "
            f"(saves ~{_fmt_bytes(cost.saved_window_bytes)} read)"
        )
    if cost.admission_tier is not None:
        scan_bytes = cost.predicted_scan_bytes
        line = (
            f"admission: tier={cost.admission_tier}, "
            f"predicted scan {_fmt_bytes(scan_bytes)}"
        )
        if cost.quota_headroom_bytes is not None:
            headroom = cost.quota_headroom_bytes
            line += (
                f", quota headroom ~{_fmt_bytes(headroom)}"
                if headroom >= 0
                else f", quota overdrawn by ~{_fmt_bytes(-headroom)}"
            )
        body.append(line)
    if sharing is not None:
        body.append(f"sharing: {sharing}")
    if cost.retry_budget is not None or cost.deadline_s is not None:
        scan = cost.scan_pass
        resume = (
            f"{scan.partitions_cached} cached partitions"
            if scan is not None and scan.partitions_cached is not None
            else "none (unpartitioned source)"
        )
        line = f"resilience: retries={cost.retry_budget}, resume={resume}"
        if cost.deadline_s is not None:
            line += f", deadline={cost.deadline_s:g}s"
        body.append(line)
    sig = cost.dispatch_signature()
    body.append(
        "predicted counters: "
        + ", ".join(f"{k}={v}" for k, v in sig["counters"].items())
    )
    spans = sig["spans"]
    if spans:
        body.append(
            "predicted spans: "
            + ", ".join(f"{k}×{v}" for k, v in spans.items())
        )
    tail: List[str] = []
    if diagnostics:
        tail.append(f"-- {len(diagnostics)} diagnostic(s) --")
        tail.extend(d.render() for d in diagnostics)
    else:
        tail.append("-- no performance diagnostics --")
    return "\n".join(head + body + tail)


# -- entrypoint ---------------------------------------------------------------


@dataclass
class ExplainResult:
    cost: PlanCost
    diagnostics: List[Diagnostic] = field(default_factory=list)
    # failure-forensics capability, from the capture's own static
    # classification of the checks (observe/forensics.py): (constraint
    # repr, row-level family) of the capable constraints, and
    # (constraint repr, reason) of the DQ316 fall-offs
    forensics_capable: List[Tuple[str, str]] = field(default_factory=list)
    forensics_falloffs: List[Tuple[str, str]] = field(default_factory=list)
    # the plan-subsumption proof (lint/subsume.SubsumptionProof) when
    # the plan was checked against a candidate shared scan; its summary
    # renders as the `sharing:` line
    sharing: Optional[Any] = None

    def render(self) -> str:
        text = render_explain(
            self.cost,
            self.diagnostics,
            sharing=self.sharing.summary() if self.sharing is not None else None,
        )
        if self.forensics_capable or self.forensics_falloffs:
            lines = [
                "failure forensics (with_forensics() / DEEQU_TPU_FORENSICS=1): "
                f"{len(self.forensics_capable)} of "
                f"{len(self.forensics_capable) + len(self.forensics_falloffs)}"
                " constraint(s) capture violating rows"
            ]
            for rep, kind in self.forensics_capable:
                lines.append(f"  + {rep}: {kind}")
            text = "\n".join([text] + lines)
        return text

    def __str__(self) -> str:
        return self.render()


def _plan_analyzers(analyzers: Sequence[Any], checks: Sequence[Any]) -> List[Any]:
    from deequ_tpu_torch.lint.planlint import _constraint_analyzers

    occurrences: List[Any] = list(analyzers)
    occurrences.extend(
        inner.analyzer for _, inner in _constraint_analyzers(checks)
    )
    seen: set = set()
    unique: List[Any] = []
    for a in occurrences:
        if a not in seen:
            seen.add(a)
            unique.append(a)
    return unique


def explain_plan(
    data_or_schema: Any,
    analyzers: Sequence[Any] = (),
    checks: Sequence[Any] = (),
    *,
    num_rows: Optional[int] = None,
    batch_size: Optional[int] = None,
    placement: Optional[str] = None,
    engine: str = "single",
    num_hosts: int = 1,
    num_shards: int = 1,
    shard_partitions: Optional[Sequence[int]] = None,
    num_devices: int = 1,
    streaming: Optional[bool] = None,
    stream_batch_rows: Optional[int] = None,
    link_bandwidth: Optional[float] = None,
    pipeline_depth: Optional[int] = None,
    row_groups: Optional[Sequence] = None,
    partitions: Optional[Sequence] = None,
    deadline_s: Optional[float] = None,
    quota_scan_bytes: Optional[float] = None,
    sharing_with: Optional[Sequence[Any]] = None,
    device: Any = None,
) -> ExplainResult:
    """EXPLAIN an analysis plan against a `Table` (schema and row count
    are taken from it — still zero data scanned) or a `SchemaInfo`.

    `streaming` defaults to the table's own `is_streaming` (False for a
    bare `SchemaInfo`), and `stream_batch_rows` to the table's own
    per-batch row cap; streaming plans additionally predict the stream
    pipeline's overlap shape and the DQ305 queue-depth lint, with the
    link bandwidth from `link_bandwidth` or the cached placement probe.

    `row_groups` defaults to the source's own parquet statistics
    (`row_group_stats()`) when it exposes them — reading file metadata,
    never a row — which turns on the pushdown prediction: skipped vs
    decoded row groups, the exact decode batch replay, and the
    DQ310/DQ311 lints.

    A source with a decode vocabulary (`decode_column_types()`, a
    Parquet source) turns on the decode verdicts, from the runtime's own
    planner over the pruned view (lint/cost.py), and the per-column
    DQ312/DQ313/DQ315/DQ325 lints.

    `device` is the device the run would use (CUDA unless the caller
    asks for the CPU): the placement, when ``DEEQU_TPU_PLACEMENT`` does
    not set it, is the run's own.

    `num_shards` / `shard_partitions` (per-shard partition counts from
    `parallel.shard.plan_shards`) describe a sharded streaming scan and
    add the `shards: N processes × K partitions each (max skew S)` line.

    `quota_scan_bytes` — a tenant's scan-bytes-per-window budget (the
    DQService admission path supplies it) — adds the quota headroom to
    the `admission:` line and arms the DQ319 never-admittable lint.

    `sharing_with` — the analyzer list of a candidate superset scan
    (another tenant's admitted plan over the same table): runs the
    plan-subsumption prover (lint/subsume.py) against it, attaches the
    proof as `result.sharing` (rendered on the `sharing:` line), and
    arms the DQ321/DQ322 diagnostics."""
    source = None
    if isinstance(data_or_schema, SchemaInfo):
        schema = data_or_schema
    else:
        schema = SchemaInfo.from_table(data_or_schema)
        if num_rows is None:
            num_rows = int(data_or_schema.num_rows)
        if streaming is None:
            streaming = bool(getattr(data_or_schema, "is_streaming", False))
        if stream_batch_rows is None and streaming:
            cap = getattr(data_or_schema, "batch_rows", None)
            stream_batch_rows = int(cap) if cap else None
        if row_groups is None:
            stats_fn = getattr(data_or_schema, "row_group_stats", None)
            if stats_fn is not None:
                try:
                    row_groups = stats_fn()
                except Exception:  # noqa: BLE001 — stats are advisory
                    row_groups = None
        if getattr(data_or_schema, "decode_column_types", None) is not None:
            source = data_or_schema
    plan = _plan_analyzers(analyzers, checks)
    cost = analyze_plan(
        plan,
        schema,
        num_rows=num_rows,
        batch_size=batch_size,
        placement=placement,
        engine=engine,
        num_hosts=num_hosts,
        num_shards=num_shards,
        shard_partitions=shard_partitions,
        num_devices=num_devices,
        streaming=bool(streaming),
        stream_batch_rows=stream_batch_rows,
        link_bandwidth=link_bandwidth,
        pipeline_depth=pipeline_depth,
        row_groups=row_groups,
        source=source,
        partitions=partitions,
        deadline_s=deadline_s,
        device=device,
    )
    if quota_scan_bytes is not None:
        predicted = cost.predicted_scan_bytes
        if predicted is not None:
            cost.quota_headroom_bytes = float(quota_scan_bytes) - predicted
    diagnostics = cost_diagnostics(
        cost, plan, schema, quota_scan_bytes=quota_scan_bytes
    )
    sharing_proof = None
    if sharing_with is not None:
        try:
            from deequ_tpu_torch.lint.subsume import prove_subsumption

            sharing_proof = prove_subsumption(plan, list(sharing_with), schema)
            diagnostics.extend(sharing_diagnostics(sharing_proof, plan))
        except Exception:  # noqa: BLE001 — the prover is advisory here
            sharing_proof = None
    # DQ316: which constraints' failures come back with sampled rows,
    # predicted by the classification the capture itself uses
    capable: List[Tuple[str, str]] = []
    falloffs: List[Tuple[str, str]] = []
    if checks:
        try:
            from deequ_tpu_torch.observe.forensics import classify_constraints

            for constraint, _inner, kind, reason in classify_constraints(checks):
                if kind is not None:
                    capable.append((repr(constraint), kind))
                else:
                    falloffs.append((repr(constraint), reason))
                    diagnostics.append(
                        Diagnostic(
                            "DQ316",
                            Severity.WARNING,
                            f"constraint {constraint!r} falls off row-level "
                            f"failure forensics ({reason}): a FAILURE "
                            "reports the metric value only, with no "
                            "sampled violating rows",
                        )
                    )
        except Exception:  # noqa: BLE001 — prediction is advisory
            capable, falloffs = [], []
    return ExplainResult(
        cost=cost,
        diagnostics=diagnostics,
        forensics_capable=capable,
        forensics_falloffs=falloffs,
        sharing=sharing_proof,
    )


def explain(
    analyzers: Sequence[Any],
    schema: SchemaInfo,
    **kwargs: Any,
) -> str:
    """Render the EXPLAIN report for a plan as a string."""
    return explain_plan(schema, analyzers=analyzers, **kwargs).render()


__all__ = [
    "DQ302_CAP_LIMIT",
    "DQ303_TILE_BUDGET_BYTES",
    "DQ303_TILE_ROWS",
    "DQ304_MAX_BATCHES",
    "DQ304_MIN_BATCH",
    "ExplainResult",
    "cost_diagnostics",
    "explain",
    "explain_plan",
    "render_explain",
    "sharing_diagnostics",
]
