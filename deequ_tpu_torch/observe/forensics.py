"""Failure forensics: row-level violation capture + metric provenance.

The paper's core algebra (declarative checks over mergeable sufficient
statistics) deliberately discards row identity — a FAILURE status plus a
metric value is all an operator gets. This module restores just enough
identity to triage, without a second pass: when enabled
(`with_forensics()` / `DEEQU_TPU_FORENSICS=1`), the fused scan hands
every already-decoded batch to a `ForensicsCapture`, which

* statically classifies the plan's constraints into row-level-capable
  families (completeness, compliance/`satisfies`, pattern match, min/max
  bounds — the same prove-eligibility-from-the-plan discipline as
  `classify_wire_columns`), everything else falling off with a DQ316
  reason;
* recomputes each capable constraint's violation mask with the SAME
  `InputSpec`s the fold itself uses (`analyzer.input_specs()`), on the
  same decoded batch — no extra decode, no extra pass, and zero
  contamination of the fold inputs (the off path never allocates);
* keeps a bounded deterministic reservoir of violating rows with full
  coordinates `(partition, fingerprint, row group, row index, offending
  values)` — the reservoir RNG is seeded from the violating indices
  themselves (the `sketch._batch_seed` trick), so reruns sample the
  same rows;
* records the run's provenance — plan signature, partitions scanned vs
  merged from the state cache, row groups pruned statically, decode
  fast-path/wire/native-reader column splits — so the report can say
  "constraint X failed because rows like these, in these partitions,
  which were scanned (not cached) under this plan".

Capture never raises into the scan: every per-constraint failure is
swallowed and counted. Offending values are read through the
`data/expr.py` evaluator on the decoded batch.

This module is imported lazily by the verification layer; it must not
be imported from telemetry/heartbeat/engine code — sampled row values live in the audit trail only,
never in `engine.*` series, OpenMetrics text, or heartbeat snapshots.
"""

from __future__ import annotations

import bisect
import math
import zlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "DEFAULT_MAX_SAMPLES",
    "FORENSICS_REPORT_VERSION",
    "ConstraintForensics",
    "ForensicsCapture",
    "ForensicsReport",
    "ViolationSample",
    "classify_constraints",
    "render_forensics",
]

DEFAULT_MAX_SAMPLES = 10

#: bump when ForensicsReport.to_dict's shape changes — the audit-trail
#: envelope (repository/audit.py) carries its own binary version on top
FORENSICS_REPORT_VERSION = 1


# ---------------------------------------------------------------------------
# static classification (mirrors lint/planlint._constraint_analyzers)
# ---------------------------------------------------------------------------


def _capable_kind(analyzer: Any) -> Optional[str]:
    """Row-level family of an analyzer, or None when its violating rows
    are not identifiable from one batch (aggregates, sketches, grouped
    metrics)."""
    from deequ_tpu_torch.analyzers import (
        Completeness,
        Compliance,
        Maximum,
        Minimum,
        PatternMatch,
    )

    if isinstance(analyzer, Completeness):
        return "completeness"
    if isinstance(analyzer, Compliance):
        return "compliance"
    if isinstance(analyzer, PatternMatch):
        return "pattern"
    if isinstance(analyzer, Minimum):
        return "minimum"
    if isinstance(analyzer, Maximum):
        return "maximum"
    return None


def classify_constraints(
    checks: Sequence,
) -> List[Tuple[object, object, Optional[str], str]]:
    """(constraint, inner, kind-or-None, falloff-reason) per analysis
    constraint in plan order. `kind is None` means not forensics-capable
    (the EXPLAIN DQ316 population); the reason says why."""
    from deequ_tpu_torch.lint.planlint import _constraint_analyzers

    out = []
    for constraint, inner in _constraint_analyzers(checks):
        kind = _capable_kind(inner.analyzer)
        if kind is None:
            out.append(
                (
                    constraint,
                    inner,
                    None,
                    "analyzer family has no per-row violation identity",
                )
            )
        elif inner.value_picker is not None:
            out.append(
                (
                    constraint,
                    inner,
                    None,
                    "custom value picker decouples the assertion from row values",
                )
            )
        else:
            out.append((constraint, inner, kind, ""))
    return out


# ---------------------------------------------------------------------------
# report surface
# ---------------------------------------------------------------------------


def _json_value(v: Any) -> Any:
    """One offending value made JSON-safe (numpy scalars unwrapped,
    non-finite floats stored as None like repository/serde.py does)."""
    if v is None:
        return None
    if isinstance(v, (np.bool_, bool)):
        return bool(v)
    if isinstance(v, (np.integer, int)):
        return int(v)
    if isinstance(v, (np.floating, float)):
        f = float(v)
        return f if math.isfinite(f) else None
    return str(v)


@dataclass
class ViolationSample:
    """One sampled violating row with full coordinates. `row_group` is
    -1 (and `row_index` the scan-global offset) for in-memory sources
    without parquet row groups."""

    partition: Optional[str]
    fingerprint: Optional[str]
    row_group: int
    row_index: int
    values: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "partition": self.partition,
            "fingerprint": self.fingerprint,
            "rowGroup": self.row_group,
            "rowIndex": self.row_index,
            "values": dict(self.values),
        }

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "ViolationSample":
        return ViolationSample(
            data.get("partition"),
            data.get("fingerprint"),
            int(data.get("rowGroup", -1)),
            int(data.get("rowIndex", -1)),
            dict(data.get("values") or {}),
        )


@dataclass
class ConstraintForensics:
    """One capable constraint's captured evidence. For min/max bounds
    `violations_seen` counts tested extreme candidates that violated
    the assertion (a lower bound on true violations); for the ratio
    families it is the exact violating-row count over scanned data."""

    constraint: str
    analyzer: str
    kind: str
    columns: List[str]
    violations_seen: int
    samples: List[ViolationSample]
    status: Optional[str] = None
    capture_errors: int = 0

    def to_dict(self) -> Dict[str, Any]:
        return {
            "constraint": self.constraint,
            "analyzer": self.analyzer,
            "kind": self.kind,
            "columns": list(self.columns),
            "violationsSeen": self.violations_seen,
            "samples": [s.to_dict() for s in self.samples],
            "status": self.status,
            "captureErrors": self.capture_errors,
        }

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "ConstraintForensics":
        return ConstraintForensics(
            str(data.get("constraint", "")),
            str(data.get("analyzer", "")),
            str(data.get("kind", "")),
            [str(c) for c in data.get("columns") or []],
            int(data.get("violationsSeen", 0)),
            [ViolationSample.from_dict(s) for s in data.get("samples") or []],
            data.get("status"),
            int(data.get("captureErrors", 0)),
        )


@dataclass
class ForensicsReport:
    """The persisted artifact: per-constraint evidence + run provenance
    + the DQ316 fall-off list. Round-trips through `to_dict`/`from_dict`
    (the audit-trail payload, repository/audit.py)."""

    constraints: List[ConstraintForensics] = field(default_factory=list)
    falloffs: List[Dict[str, str]] = field(default_factory=list)
    provenance: Dict[str, Any] = field(default_factory=dict)

    def failed(self) -> List[ConstraintForensics]:
        return [c for c in self.constraints if c.status == "FAILURE"]

    def to_dict(self) -> Dict[str, Any]:
        return {
            "version": FORENSICS_REPORT_VERSION,
            "constraints": [c.to_dict() for c in self.constraints],
            "falloffs": [dict(f) for f in self.falloffs],
            "provenance": dict(self.provenance),
        }

    @staticmethod
    def from_dict(data: Dict[str, Any]) -> "ForensicsReport":
        return ForensicsReport(
            [
                ConstraintForensics.from_dict(c)
                for c in data.get("constraints") or []
            ],
            [dict(f) for f in data.get("falloffs") or []],
            dict(data.get("provenance") or {}),
        )

    def render(self) -> str:
        return render_forensics(self)

    def __str__(self) -> str:
        return self.render()


def _render_sample(sample: ViolationSample) -> str:
    where = sample.partition if sample.partition else "<data>"
    coord = (
        f"rg={sample.row_group} row={sample.row_index}"
        if sample.row_group >= 0
        else f"row={sample.row_index}"
    )
    vals = ", ".join(f"{k}={v!r}" for k, v in sorted(sample.values.items()))
    return f"{where} {coord}: {vals}"


def render_forensics(report: ForensicsReport) -> str:
    """Human-readable triage section: provenance first (what ran, what
    merged from cache), then per-constraint sampled rows."""
    lines = ["failure forensics:"]
    prov = report.provenance or {}
    sig = prov.get("planSignature")
    if sig:
        lines.append(f"  plan signature: {str(sig)[:16]}…")
    parts = prov.get("partitions") or []
    if parts:
        scanned = prov.get("partitionsScanned", 0)
        cached = prov.get("partitionsCached", 0)
        lines.append(
            f"  partitions: {scanned} scanned, {cached} merged from state"
            f" cache ({len(parts)} total)"
        )
        for p in parts:
            fp = str(p.get("fingerprint") or "")[:12]
            lines.append(
                f"    {p.get('name')} [{p.get('mode')}]"
                + (f" fingerprint={fp}…" if fp else "")
            )
    rg_scanned = prov.get("rowGroupsScanned")
    if rg_scanned is not None:
        lines.append(
            f"  row groups: {rg_scanned} scanned,"
            f" {prov.get('rowGroupsPruned', 0)} pruned statically"
        )
    decode = prov.get("decode") or {}
    if decode:
        lines.append(
            "  decode split: fast={fast} fallback={fallback} wire={wire}"
            " native-reader={reader}".format(
                fast=decode.get("colsFast", 0),
                fallback=decode.get("colsFallback", 0),
                wire=decode.get("colsWireFused", 0),
                reader=decode.get("colsReader", 0),
            )
        )
    for cf in report.constraints:
        status = f" [{cf.status}]" if cf.status else ""
        lines.append(
            f"  {cf.constraint}{status} — {cf.violations_seen} violating"
            f" row(s) seen, {len(cf.samples)} sampled"
        )
        for sample in cf.samples:
            lines.append(f"    {_render_sample(sample)}")
    for fo in report.falloffs:
        lines.append(
            f"  not forensics-capable (DQ316): {fo.get('constraint')}"
            f" — {fo.get('reason')}"
        )
    if len(lines) == 1:
        lines.append("  (no forensics-capable constraints in this plan)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# value extraction (the data/expr.py evaluator on the decoded batch)
# ---------------------------------------------------------------------------


def _column_values(batch: Any, column: str, indices: Sequence[int]) -> List[Any]:
    """Offending values for `column` at batch-local `indices`, read
    through the expression evaluator (nulls -> None). Degrades to None
    values on any evaluation problem — forensics never invents data."""
    from deequ_tpu_torch.data.expr import Predicate

    try:
        values, null, _kind = Predicate(column).eval(batch)
    except Exception:  # noqa: BLE001 - capture is best-effort by contract
        return [None for _ in indices]
    out = []
    for i in indices:
        out.append(None if bool(null[i]) else _json_value(values[i]))
    return out


def _batch_seed(indices: np.ndarray, seen: int) -> int:
    """Content-derived reservoir seed (the sketch._batch_seed trick):
    same violating rows in the same order -> same sampled subset."""
    h = zlib.crc32(np.ascontiguousarray(indices, dtype=np.int64).tobytes())
    return (h ^ (int(seen) * 0x9E3779B1) ^ (int(indices.size) << 17)) & 0x7FFFFFFF


# ---------------------------------------------------------------------------
# per-constraint capture entries
# ---------------------------------------------------------------------------


class _EntryBase:
    """Shared spec plumbing: masks are rebuilt from the analyzer's OWN
    `input_specs()` on the decoded batch — never read out of the fold's
    `HostInputs` (which may hold packed/device representations), so the
    fold arithmetic is untouchable from here."""

    def __init__(self, constraint: Any, inner: Any, kind: str, cap: int):
        self.constraint = constraint
        self.inner = inner
        self.kind = kind
        self.cap = max(1, int(cap))
        self.errors = 0
        self._specs: Dict[str, Any] = {}
        for spec in inner.analyzer.input_specs():
            prefix = spec.key.split(":", 1)[0]
            # first spec wins: input_specs orders the analyzer's own
            # where filter before the shared all-true mask
            self._specs.setdefault(prefix, spec)

    def _build(
        self, batch: Any, prefix: str, cache: Optional[Dict[str, Any]] = None
    ) -> np.ndarray:
        # spec keys are globally deduplicated across the pass (see
        # InputSpec), so one build per (batch, key) serves every entry
        spec = self._specs[prefix]
        if cache is None:
            return np.asarray(spec.build(batch))
        arr = cache.get(spec.key)
        if arr is None:
            arr = cache[spec.key] = np.asarray(spec.build(batch))
        return arr

    def _bool(
        self, batch: Any, prefix: str, cache: Optional[Dict[str, Any]] = None
    ) -> np.ndarray:
        return self._build(batch, prefix, cache).astype(bool, copy=False)

    def result(self) -> ConstraintForensics:
        raise NotImplementedError


class _RatioEntry(_EntryBase):
    """Completeness / compliance / pattern match: the violation mask is
    exact per batch, sampled by a deterministic Algorithm-R reservoir."""

    def __init__(self, constraint: Any, inner: Any, kind: str, cap: int):
        super().__init__(constraint, inner, kind, cap)
        analyzer = inner.analyzer
        if kind == "compliance":
            self.columns = _predicate_columns(analyzer)
        else:
            self.columns = [str(getattr(analyzer, "column", ""))]
        self.seen = 0
        self.samples: List[Optional[ViolationSample]] = []

    def _violation_mask(
        self, batch: Any, cache: Optional[Dict[str, Any]] = None
    ) -> np.ndarray:
        w = self._bool(batch, "where", cache)
        if self.kind == "completeness":
            return w & ~self._bool(batch, "valid", cache)
        if self.kind == "compliance":
            pred = self._bool(batch, "pred", cache)
            nonnull = self._bool(batch, "prednn", cache)
            return w & nonnull & ~pred
        # pattern: nulls are guarded by the valid mask, match has null->False
        return w & self._bool(batch, "valid", cache) & ~self._bool(
            batch, "match", cache
        )

    def capture(
        self,
        batch: Any,
        row_offset: int,
        owner: "ForensicsCapture",
        cache: Optional[Dict[str, Any]] = None,
    ) -> None:
        idx = np.flatnonzero(self._violation_mask(batch, cache))
        if idx.size == 0:
            return
        rng = np.random.default_rng(_batch_seed(idx, self.seen))
        winners: Dict[int, int] = {}
        t0, m = self.seen, int(idx.size)
        fill = max(0, min(self.cap - t0, m))
        for j in range(fill):
            self.samples.append(None)
            winners[t0 + j] = int(idx[j])
        if m > fill:
            # Algorithm R, vectorized: item t replaces slot r_t when
            # r_t = U[0, t] < cap. Expected hits per batch are
            # cap·ln((t0+m)/t0) — a handful — so the Python work below
            # is O(hits), not O(violations).
            ts = np.arange(t0 + fill, t0 + m, dtype=np.int64)
            rs = rng.integers(0, ts + 1)
            for h in np.flatnonzero(rs < self.cap).tolist():
                winners[int(rs[h])] = int(idx[fill + h])
        self.seen += m
        if not winners:
            return
        locals_needed = sorted(set(winners.values()))
        if self.kind == "completeness":
            # the offending value IS the null — record it as such
            values = {i: {c: None for c in self.columns} for i in locals_needed}
        else:
            per_col = {
                c: _column_values(batch, c, locals_needed) for c in self.columns
            }
            values = {
                i: {c: per_col[c][k] for c in self.columns}
                for k, i in enumerate(locals_needed)
            }
        for slot, i in winners.items():
            group, row = owner.coords(row_offset + i)
            self.samples[slot] = ViolationSample(
                owner.partition_name,
                owner.partition_fingerprint,
                group,
                row,
                values[i],
            )

    def result(self) -> ConstraintForensics:
        return ConstraintForensics(
            str(self.constraint),
            repr(self.inner.analyzer),
            self.kind,
            list(self.columns),
            self.seen,
            [s for s in self.samples if s is not None],
            capture_errors=self.errors,
        )


class _ExtremeEntry(_EntryBase):
    """Minimum / maximum bounds: per batch, test the k most extreme
    masked values through the real assertion and keep the k most
    extreme failures overall. The global extremum is some batch's
    extreme, so a failing constraint always yields >=1 sample — no
    reservoir needed, and at most `cap` Python assertion calls per
    batch."""

    def __init__(self, constraint: Any, inner: Any, kind: str, cap: int):
        super().__init__(constraint, inner, kind, cap)
        self.column = str(getattr(inner.analyzer, "column", ""))
        self.columns = [self.column]
        self.seen = 0
        self.candidates: List[Tuple[float, ViolationSample]] = []

    def _violates(self, value: float) -> bool:
        try:
            return not bool(self.inner.assertion(value))
        except Exception:  # noqa: BLE001 - a crashing assertion fails too
            return True

    def capture(
        self,
        batch: Any,
        row_offset: int,
        owner: "ForensicsCapture",
        cache: Optional[Dict[str, Any]] = None,
    ) -> None:
        num = self._build(batch, "num", cache)
        mask = self._bool(batch, "valid", cache) & self._bool(
            batch, "where", cache
        )
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            return
        vals = np.asarray(num, dtype=np.float64)[idx]
        key = vals if self.kind == "minimum" else -vals
        if idx.size > self.cap:
            # O(n) partition for the k extremes, then sort only those k
            part = np.argpartition(key, self.cap - 1)[: self.cap]
            take = part[np.argsort(key[part], kind="stable")]
        else:
            take = np.argsort(key, kind="stable")
        for j in take.tolist():
            value = float(vals[j])
            if not self._violates(value):
                # candidates are sorted by extremity: once one passes,
                # every remaining (less extreme) one passes too
                break
            self.seen += 1
            group, row = owner.coords(row_offset + int(idx[j]))
            self.candidates.append(
                (
                    value,
                    ViolationSample(
                        owner.partition_name,
                        owner.partition_fingerprint,
                        group,
                        row,
                        {self.column: _json_value(value)},
                    ),
                )
            )
        self.candidates.sort(
            key=lambda t: t[0], reverse=(self.kind == "maximum")
        )
        del self.candidates[self.cap :]

    def result(self) -> ConstraintForensics:
        return ConstraintForensics(
            str(self.constraint),
            repr(self.inner.analyzer),
            self.kind,
            list(self.columns),
            self.seen,
            [s for _, s in self.candidates],
            capture_errors=self.errors,
        )


def _predicate_columns(analyzer: Any) -> List[str]:
    from deequ_tpu_torch.data.expr import Predicate

    predicate = getattr(analyzer, "predicate", None)
    if not isinstance(predicate, str):
        return []
    try:
        cols = Predicate(predicate).referenced_columns()
    except Exception:  # noqa: BLE001 - unparseable predicate: no values
        return []
    out: List[str] = []
    for c in cols:
        if c not in out:
            out.append(c)
    return out


# ---------------------------------------------------------------------------
# the capture object threaded through the fused scan
# ---------------------------------------------------------------------------


class ForensicsCapture:
    """One per verification run (when forensics is enabled). The fused
    pass calls the `note_*` hooks as it plans and `capture_batch` once
    per decoded batch; the suite calls `finalize` after constraint
    evaluation to stamp statuses and freeze the report.

    Partitioned scans run serially in deterministic order, so the
    current-partition coordinate state lives on this one object
    (`enter_partition` re-aims it before each sub-scan)."""

    def __init__(self, checks: Sequence, max_samples: int = DEFAULT_MAX_SAMPLES):
        cap = max(1, int(max_samples))
        self.max_samples = cap
        self._entries: List[_EntryBase] = []
        self.falloffs: List[Dict[str, str]] = []
        for constraint, inner, kind, reason in classify_constraints(checks):
            if kind is None:
                self.falloffs.append(
                    {"constraint": str(constraint), "reason": reason}
                )
            elif kind in ("minimum", "maximum"):
                self._entries.append(_ExtremeEntry(constraint, inner, kind, cap))
            else:
                self._entries.append(_RatioEntry(constraint, inner, kind, cap))
        # provenance accumulators
        self.plan_signature: Optional[str] = None
        self.partitions: List[Dict[str, Any]] = []
        self.row_groups_scanned = 0
        self.row_groups_pruned = 0
        self.decode: Dict[str, int] = {
            "colsFast": 0,
            "colsFallback": 0,
            "colsWireFused": 0,
            "colsReader": 0,
            "readerGroups": 0,
        }
        # current-scan coordinate state
        self.partition_name: Optional[str] = None
        self.partition_fingerprint: Optional[str] = None
        self._rg_groups: Optional[List[int]] = None
        self._rg_starts: Optional[List[int]] = None

    # -- plan/provenance hooks (called by ops/fused.FusedScanPass) ----------

    def note_plan_signature(self, signature: str) -> None:
        self.plan_signature = str(signature)

    def note_partition(self, name: str, fingerprint: str, mode: str) -> None:
        self.partitions.append(
            {"name": str(name), "fingerprint": str(fingerprint), "mode": str(mode)}
        )

    def enter_partition(self, name: str, fingerprint: str) -> "ForensicsCapture":
        """Aim subsequent coordinates at one partition's sub-scan;
        partitions scan serially, so reusing this object is safe."""
        self.partition_name = str(name)
        self.partition_fingerprint = str(fingerprint)
        self._rg_groups = None
        self._rg_starts = None
        return self

    def note_table(self, source: Any) -> None:
        """Build the scan-offset -> (row group, row-in-group) map for
        the (already pruned) source about to be scanned, and fold its
        row-group counts into provenance. In-memory sources map to
        row_group -1 with scan-global row indices."""
        self._rg_groups = None
        self._rg_starts = None
        stats_fn = getattr(source, "row_group_stats", None)
        if not callable(stats_fn):
            return
        prune = getattr(source, "prune_groups", None) or frozenset()
        try:
            groups: List[int] = []
            starts: List[int] = []
            offset = 0
            for g in stats_fn():
                if g.index in prune:
                    continue
                groups.append(int(g.index))
                starts.append(offset)
                offset += int(g.num_rows)
            self._rg_groups = groups
            self._rg_starts = starts
            self.row_groups_scanned += len(groups)
            self.row_groups_pruned += len(prune)
        except Exception:  # noqa: BLE001 - degrade to scan-global coords
            self._rg_groups = None
            self._rg_starts = None

    def note_decode_plan(self, plan: Any) -> None:
        def _n(name: str) -> int:
            try:
                return len(getattr(plan, name, ()) or ())
            except TypeError:
                return 0

        self.decode["colsFast"] += _n("fast")
        self.decode["colsFallback"] += _n("fallbacks")
        self.decode["colsWireFused"] += _n("wire_fused")
        self.decode["colsReader"] += _n("reader_cols")
        self.decode["readerGroups"] += _n("reader_groups")

    # -- per-batch hook ------------------------------------------------------

    def coords(self, scan_row: int) -> Tuple[int, int]:
        if self._rg_starts:
            i = bisect.bisect_right(self._rg_starts, scan_row) - 1
            return self._rg_groups[i], scan_row - self._rg_starts[i]
        return -1, int(scan_row)

    def capture_batch(self, batch: Any, row_offset: int) -> None:
        """Sample violating rows from one decoded batch whose first row
        sits at scan offset `row_offset`. Never raises: a broken entry
        counts its error and the scan continues."""
        cache: Dict[str, Any] = {}
        for entry in self._entries:
            try:
                entry.capture(batch, int(row_offset), self, cache)
            except Exception:  # noqa: BLE001 - capture must not break scans
                entry.errors += 1

    # -- result side ---------------------------------------------------------

    def _provenance(self) -> Dict[str, Any]:
        scanned = sum(1 for p in self.partitions if p.get("mode") == "scan")
        cached = sum(1 for p in self.partitions if p.get("mode") == "cache")
        return {
            "planSignature": self.plan_signature,
            "partitions": [dict(p) for p in self.partitions],
            "partitionsScanned": scanned,
            "partitionsCached": cached,
            "rowGroupsScanned": self.row_groups_scanned,
            "rowGroupsPruned": self.row_groups_pruned,
            "decode": dict(self.decode),
        }

    def finalize(self, check_results: Optional[Dict] = None) -> ForensicsReport:
        status_by_id: Dict[int, str] = {}
        status_by_repr: Dict[str, str] = {}
        for cres in (check_results or {}).values():
            for cr in getattr(cres, "constraint_results", []):
                status_by_id[id(cr.constraint)] = cr.status.name
                status_by_repr.setdefault(str(cr.constraint), cr.status.name)
        constraints = []
        for entry in self._entries:
            cf = entry.result()
            cf.status = status_by_id.get(
                id(entry.constraint), status_by_repr.get(cf.constraint)
            )
            constraints.append(cf)
        return ForensicsReport(
            constraints, [dict(f) for f in self.falloffs], self._provenance()
        )
