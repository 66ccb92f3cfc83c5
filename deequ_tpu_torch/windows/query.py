"""Window queries: metrics over a partition-time window as an O(log n)
segment merge, bit-identical to a full rescan, with zero data rows read
when the repository is warm.

Execution shape:

  1. resolve the window spec against the dataset's timeline
     (`spec.Timeline.derive` — layout dates or positional buckets);
  2. decompose the window's bucket range into the canonical aligned
     power-of-two cover (`segments.aligned_cover`) and address each
     span by its content fingerprint — late or re-stated partitions
     changed exactly the covering spans' keys, so staleness is
     impossible by construction;
  3. load each span's `DQSG` segment (one repository round-trip per
     span); a missing/corrupt span rebuilds from per-partition `DQST`
     states and is re-published, and partitions with no usable state at
     all are rescanned through the ordinary `AnalysisRunner` path
     (which re-commits their states);
  4. merge every member partition's states sequentially in global name
     order through the same `merge_states` semigroup surface the fused
     scan uses — the merge tree is identical to the engine's, so the
     answer is bit-identical to scanning the window's partitions.

A query runs on CUDA unless the caller passes ``device="cpu"``: the
rescans fold on that device, and the merged states reduce to metrics
there, as a run's merged states do.

The JAX counterpart is deequ_tpu/windows/query.py.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

from deequ_tpu_torch import observe
from deequ_tpu_torch.lint.diagnostics import Diagnostic, Severity
from deequ_tpu_torch.observe import counters
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.repository.states import (
    StateDecodeError,
    decode_states,
    merge_states,
    plan_signature_for,
)
from deequ_tpu_torch.windows.segments import (
    SegmentStore,
    aligned_cover,
    segment_key,
    span_fingerprint,
)
from deequ_tpu_torch.windows.spec import Timeline, WindowFrame, WindowSpec

__all__ = ["SpanResolution", "WindowPlan", "WindowQuery"]

WindowLike = Union[WindowSpec, WindowFrame]


@dataclass(frozen=True)
class SpanResolution:
    """One cover span's resolution: which aligned span, its content
    fingerprint, its member partition indices, and whether a segment
    envelope for it already exists in the repository."""

    level: int
    start: int
    fingerprint: str
    indices: Tuple[int, ...]
    hit: bool

    @property
    def span(self) -> Tuple[int, int]:
        return (self.start, self.start + (1 << self.level))


@dataclass
class WindowPlan:
    """The compiled merge tree of one window query: resolved frame,
    cover spans with hit/miss verdicts, partitions that must rescan
    (no usable per-partition state), and the byte accounting EXPLAIN
    and admission consume."""

    frame: WindowFrame
    spec_text: str
    signature: str
    spans: List[SpanResolution] = field(default_factory=list)
    #: partition names with no usable per-partition state entry — these
    #: rescan (and re-commit states) before the merge can run
    partitions_rescanned: Tuple[str, ...] = ()
    rescan_paths: Tuple[str, ...] = ()
    predicted_scan_bytes: float = 0.0
    saved_window_bytes: float = 0.0
    diagnostics: List[Diagnostic] = field(default_factory=list)

    @property
    def segments_merged(self) -> int:
        return len(self.spans)

    @property
    def segment_hits(self) -> int:
        return sum(1 for s in self.spans if s.hit)

    @property
    def segment_misses(self) -> int:
        return sum(1 for s in self.spans if not s.hit)

    def summary(self) -> str:
        return (
            f"{self.spec_text} -> {self.segments_merged} segment "
            f"merges ({self.segment_hits} warm), "
            f"{len(self.partitions_rescanned)} partitions rescanned"
        )


class WindowQuery:
    """Windowed metrics over a partitioned source through the
    repository's state algebra.

    `analyzers` must be scan-shareable, non-grouping analyzers — the
    family whose states the partitioned fused pass commits per
    partition — given in the SAME order the filling scans used, so the
    plan signature (and therefore every state entry) matches. `device`
    is the run's (CUDA unless ``"cpu"``): the filling scans must have run
    on the same kind of device, since the signature names its folds.
    """

    def __init__(
        self,
        source: Any,
        analyzers: Sequence[Any],
        *,
        repository: Any,
        dataset: str,
        extractor: Optional[Callable[[str], Optional[int]]] = None,
        batch_size: Optional[int] = None,
        device: Any = None,
    ) -> None:
        from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
        from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer

        seen: set = set()
        unique: List[Any] = []
        for a in analyzers:
            if a in seen:
                continue
            seen.add(a)
            unique.append(a)
        for a in unique:
            if isinstance(a, GroupingAnalyzer) or not isinstance(
                a, ScanShareableAnalyzer
            ):
                raise ValueError(
                    f"window queries need scan-shareable, non-grouping "
                    f"analyzers (their states are committed per "
                    f"partition); {a!r} is not"
                )
        if not unique:
            raise ValueError("window query needs at least one analyzer")
        self.analyzers: Tuple[Any, ...] = tuple(unique)
        self._source = source
        self._repository = repository
        self._dataset = dataset
        self._extractor = extractor
        self._batch_size = batch_size
        self.device = runtime.resolve_device(device)

    # -- plan ----------------------------------------------------------------

    def signature(self) -> str:
        """The live plan signature — the exact key
        `FusedScanPass._run_partitioned` computes for these analyzers
        over this source under the current runtime knobs."""
        return plan_signature_for(
            list(self.analyzers), self._source, self._batch_size, device=self.device
        )

    def timeline(self) -> Timeline:
        return Timeline.derive(self._source.partitions(), self._extractor)

    def _frame(self, window: WindowLike, timeline: Timeline) -> WindowFrame:
        if isinstance(window, WindowFrame):
            return window
        return window.resolve(timeline)

    def plan(
        self, window: WindowLike, *, timeline: Optional[Timeline] = None
    ) -> WindowPlan:
        """Compile the window into its merge tree and classify every
        span (segment hit / rebuild) and member partition (state present
        / rescan) — without reading a row or moving a byte."""
        parts = self._source.partitions()
        if timeline is None:
            timeline = Timeline.derive(parts, self._extractor)
        frame = self._frame(window, timeline)
        signature = self.signature()
        spec_text = (
            window.describe()
            if isinstance(window, WindowSpec)
            else frame.label
        )
        plan = WindowPlan(frame=frame, spec_text=spec_text, signature=signature)
        if not frame.indices:
            return plan

        store = SegmentStore(self._repository, self._dataset, signature)
        cover_lo = timeline.buckets[frame.indices[0]]
        cover_hi = timeline.buckets[frame.indices[-1]] + 1
        member_set = frozenset(frame.indices)
        for level, start in aligned_cover(cover_lo, cover_hi):
            end = start + (1 << level)
            idx = tuple(
                i
                for i in frame.indices
                if start <= timeline.buckets[i] < end
            )
            if not idx:
                continue  # sparse timeline: the span covers no partition
            members = [(timeline.buckets[i], parts[i].fingerprint) for i in idx]
            fp = span_fingerprint(level, start, members)
            plan.spans.append(
                SpanResolution(
                    level=level, start=start, fingerprint=fp, indices=idx,
                    hit=store.has(level, fp),
                )
            )

        # partitions needing a rescan: members of MISSED spans with no
        # per-partition state entry (a hit span carries its members'
        # states inside the segment envelope)
        needed = sorted(
            {i for s in plan.spans if not s.hit for i in s.indices}
        )
        rescan_names: List[str] = []
        rescan_paths: List[str] = []
        rescan_bytes = 0.0
        member_bytes = 0.0
        for i in frame.indices:
            try:
                nbytes = float(os.path.getsize(parts[i].path))
            except OSError:
                nbytes = 0.0
            member_bytes += nbytes
            if i in set(needed) and not self._repository.has_states(
                self._dataset, parts[i].fingerprint, signature
            ):
                rescan_names.append(parts[i].name)
                rescan_paths.append(parts[i].path)
                rescan_bytes += nbytes
        assert member_set  # non-empty frame reaches here
        plan.partitions_rescanned = tuple(rescan_names)
        plan.rescan_paths = tuple(rescan_paths)
        plan.predicted_scan_bytes = rescan_bytes
        plan.saved_window_bytes = member_bytes - rescan_bytes

        missed = [s for s in plan.spans if not s.hit]
        if missed:
            named = ", ".join(
                f"[{s.span[0]},{s.span[1]})" for s in missed[:6]
            )
            if len(missed) > 6:
                named += f", ... ({len(missed) - 6} more)"
            plan.diagnostics.append(
                Diagnostic(
                    code="DQ323",
                    severity=Severity.WARNING,
                    message=(
                        f"window not resolvable from precomputed segments: "
                        f"{len(missed)} of {len(plan.spans)} cover span(s) "
                        f"invalidated or cold ({named}); "
                        f"{len(rescan_names)} partition(s) rescan, the rest "
                        "rebuild from per-partition states"
                    ),
                    source=spec_text,
                    span=(0, len(spec_text)),
                    subject=f"dataset {self._dataset!r}",
                )
            )
        return plan

    # -- execution -----------------------------------------------------------

    def _rescan(self, paths: Sequence[str]) -> None:
        """Scan exactly `paths` through the ordinary runner with the
        repository attached — the partitioned fused pass re-commits one
        state envelope per partition as it goes."""
        from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

        AnalysisRunner.do_analysis_run(
            self._source.subset(list(paths)),
            list(self.analyzers),
            self.device,
            state_repository=self._repository,
            dataset_name=self._dataset,
        )

    def _assemble(
        self,
        plan: WindowPlan,
        parts: Sequence[Any],
        timeline: Timeline,
        *,
        warm: bool,
    ) -> Tuple[List[Tuple[str, int, bytes]], int, int]:
        """Per-partition DQST blobs for every frame member in global
        name order, via segments where possible. Returns (entries,
        segment_hits, segments_built)."""
        store = SegmentStore(self._repository, self._dataset, plan.signature)
        entries_all: List[Tuple[str, int, bytes]] = []
        hits = 0
        built = 0
        for res in plan.spans:
            seg = store.load(res.level, res.fingerprint) if res.hit else None
            expected = [parts[i].name for i in res.indices]
            if seg is not None and [e[0] for e in seg.entries] == expected:
                hits += 1
                entries_all.extend(seg.entries)
                continue
            entries: List[Tuple[str, int, bytes]] = []
            for i in res.indices:
                blob = self._repository.get_blob(
                    self._dataset, plan.signature, parts[i].fingerprint
                )
                if blob is None:
                    raise KeyError(
                        f"no cached states for dataset {self._dataset!r} "
                        f"partition {parts[i].name!r} under signature "
                        f"{plan.signature!r}"
                    )
                entries.append((parts[i].name, timeline.buckets[i], blob))
            if warm:
                store.save(res.level, res.start, res.fingerprint, entries)
            built += 1
            entries_all.extend(entries)
        return entries_all, hits, built

    def _merge(self, entries: Sequence[Tuple[str, int, bytes]]) -> List[Any]:
        """Sequential left-fold over per-partition states in global
        name order — the engine's merge tree exactly."""
        merged: List[Any] = [None] * len(self.analyzers)
        for _name, _bucket, blob in entries:
            states = decode_states(blob, self.analyzers)
            merged = [merge_states(m, s) for m, s in zip(merged, states)]
        return merged

    def _unusable_paths(
        self, plan: WindowPlan, parts: Sequence[Any]
    ) -> List[str]:
        """Frame members whose per-partition state entry is missing or
        does not decode — the degrade-to-rescan set."""
        bad: List[str] = []
        for i in plan.frame.indices:
            blob = self._repository.get_blob(
                self._dataset, plan.signature, parts[i].fingerprint
            )
            if blob is None:
                bad.append(parts[i].path)
                continue
            try:
                decode_states(blob, self.analyzers)
            except StateDecodeError:
                bad.append(parts[i].path)
        return bad

    def _resolve_states(
        self, window: WindowLike, *, warm: bool
    ) -> Tuple[WindowPlan, List[Any]]:
        """Plan + merged states, with the two recovery ladders armed:
        missing states rescan up front, and any defect discovered
        during assembly/merge (corrupt segment member, truncated
        partition envelope) degrades to one targeted rescan-and-retry —
        never a wrong answer, never an unbounded loop."""
        parts = self._source.partitions()
        timeline = Timeline.derive(parts, self._extractor)
        for attempt in (0, 1):
            plan = self.plan(window, timeline=timeline)
            with observe.span(
                "window", cat="window", op="resolve",
                spec=plan.spec_text,
                partitions=len(plan.frame.indices),
                segments=plan.segments_merged,
            ) as sp:
                if plan.rescan_paths:
                    self._rescan(plan.rescan_paths)
                try:
                    entries, hits, built = self._assemble(
                        plan, parts, timeline, warm=warm
                    )
                    merged = self._merge(entries)
                except (KeyError, StateDecodeError):
                    if attempt:
                        raise
                    bad = self._unusable_paths(plan, parts)
                    if not bad:
                        raise
                    self._rescan(bad)
                    continue
                sp.set(hits=hits, built=built)
                counters.record_window(
                    segments=plan.segments_merged,
                    hits=hits,
                    built=built,
                    rescanned=len(plan.partitions_rescanned),
                    partitions=len(plan.frame.indices),
                )
                return plan, merged
        raise AssertionError("unreachable")  # pragma: no cover

    def run(self, window: WindowLike, *, warm: bool = True, tracing=None):
        """Metrics over the window as an `AnalyzerContext` — the same
        object a scan produces, computed purely from merged states.
        `warm=True` (default) re-publishes any cover segment that had
        to be rebuilt, so the next query over the same range is pure
        segment loads. The compiled `WindowPlan` attaches to the
        returned context as `window_plan`."""
        from deequ_tpu_torch.runners.context import AnalyzerContext

        with observe.traced_run(
            "window_query", enable=tracing, analyzers=len(self.analyzers)
        ) as run:
            plan, merged = self._resolve_states(window, warm=warm)
            metrics = {
                analyzer: analyzer.compute_metric_from(state, self.device)
                for analyzer, state in zip(self.analyzers, merged)
            }
            context = AnalyzerContext(metrics)
        context.window_plan = plan
        context.validation_warnings = list(plan.diagnostics)
        if run.trace is not None:
            context.run_trace = run.trace
        return context

    def states(self, window: WindowLike, *, warm: bool = True):
        """The window's merged states as a `StateBag` — the two-sample
        input of the drift check family (`checks/drift.py`), with the
        plan signature carried along so baseline/current mismatches are
        detectable (DQ324)."""
        from deequ_tpu_torch.analyzers.drift import StateBag

        plan, merged = self._resolve_states(window, warm=warm)
        return StateBag.from_pairs(
            list(zip(self.analyzers, merged)),
            signature=plan.signature,
            label=plan.frame.label,
        )

    # -- admission / EXPLAIN -------------------------------------------------

    def admission_cost(self, window: WindowLike):
        """A `PlanCost` for this window query, costed like any other
        submission: the predicted scan bytes are the rescan partitions'
        file bytes ONLY (near zero on a warm repository), and the
        window fields feed EXPLAIN's `windows:` line and the
        `drift.window_*` pins."""
        from deequ_tpu_torch.lint.cost import analyze_plan
        from deequ_tpu_torch.lint.schema import SchemaInfo

        parts = self._source.partitions()
        timeline = Timeline.derive(parts, self._extractor)
        plan = self.plan(window, timeline=timeline)
        rescan = set(plan.partitions_rescanned)
        records = []
        num_rows = 0
        member_paths = []
        for i in plan.frame.indices:
            member_paths.append(parts[i].path)
            try:
                nbytes = int(os.path.getsize(parts[i].path))
            except OSError:
                nbytes = 0
            records.append(
                {"cached": parts[i].name not in rescan, "bytes": nbytes}
            )
        if member_paths:
            num_rows = int(self._source.subset(member_paths).num_rows)
        schema = SchemaInfo.from_table(self._source)
        cost = analyze_plan(
            list(self.analyzers),
            schema,
            num_rows=num_rows,
            batch_size=self._batch_size,
            streaming=True,
            stream_batch_rows=getattr(self._source, "batch_rows", None),
            partitions=records,
            device=self.device,
        )
        cost.window_spec = plan.spec_text
        cost.window_segments_merged = plan.segments_merged
        cost.window_partitions_rescanned = len(plan.partitions_rescanned)
        cost.saved_window_bytes = plan.saved_window_bytes
        return cost


# re-exported for callers that build covers by hand (tests, tools)
_ = segment_key
