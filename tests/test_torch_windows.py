"""Windowed state algebra (deequ_tpu_torch/windows/): timeline derivation
from dataset layouts, the aligned power-of-two cover, DQSG segment
envelope serde + fail-closed validation, SegmentStore degrade paths
(corruption, signature mismatch, injected `state.segment` chaos
faults), content-keyed span invalidation exactness, the WindowQuery
end-to-end contract (zero rows warm, bit-identical to a full rescan,
O(log n) invalidation on a late partition), DQ323 diagnostics and the
EXPLAIN/admission surfaces.

Port-mapped from tests/test_windows.py: the same cases against
deequ_tpu_torch, every run on the CPU (tests/torch_cpu.py), its two
`DQService.submit_window` cases included (`TestServiceSubmitWindow`,
over the port's service). The cases at the end hold the port to the JAX
package: a window's metrics against the JAX `WindowQuery`'s over the
same partitions, and the DQSG bytes of equal states.
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import datetime
import glob
import math
import os
import struct
import warnings

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    CountDistinct,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
)
from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.repository.states import (
    FileSystemStateRepository,
    InMemoryStateRepository,
    StateDecodeError,
    encode_states,
)
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from deequ_tpu_torch.testing import faults
from deequ_tpu_torch.windows import (
    SEGMENT_FORMAT_VERSION,
    SEGMENT_MAGIC,
    LastN,
    SegmentStore,
    Sliding,
    Timeline,
    Tumbling,
    WindowQuery,
    aligned_cover,
    decode_segment,
    default_bucket_for,
    encode_segment,
    span_fingerprint,
)
from deequ_tpu_torch.windows.segments import segment_key

pytestmark = pytest.mark.usefixtures("cpu_default")

DAY0 = datetime.date(2026, 1, 1)


def _bits(x: float) -> bytes:
    return struct.pack(">d", float(x))


class _P:
    """A minimal Partition stand-in (anything with .name)."""

    def __init__(self, name: str) -> None:
        self.name = name


def _daily_table(rng: np.random.Generator, n: int = 400) -> Table:
    x = rng.normal(40.0, 10.0, n)
    x[rng.random(n) < 0.05] = np.nan
    y = x * 0.5 + rng.normal(0, 1.0, n)
    g = rng.integers(0, 500, n)
    return Table.from_pydict(
        {"x": list(x), "y": list(y), "g": [int(v) for v in g]},
        types={
            "x": ColumnType.DOUBLE,
            "y": ColumnType.DOUBLE,
            "g": ColumnType.LONG,
        },
    )


def _write_daily_dataset(dir_path, n_days: int, seed: int = 0) -> list:
    """`n_days` date-named parquet partitions; partition i is a pure
    function of (seed, i)."""
    os.makedirs(str(dir_path), exist_ok=True)
    paths = []
    for i in range(n_days):
        day = DAY0 + datetime.timedelta(days=i)
        path = os.path.join(str(dir_path), f"part-{day.isoformat()}.parquet")
        rng = np.random.default_rng(seed * 1_000 + i)
        _daily_table(rng).to_parquet(path, row_group_size=128)
        paths.append(path)
    return paths


_ANALYZERS = [
    Size(),
    Completeness("x"),
    Mean("x"),
    StandardDeviation("x"),
    Minimum("x"),
    Maximum("y"),
    ApproxCountDistinct("g"),
    ApproxQuantile("x", 0.5),
]


def _snapshot(context) -> dict:
    snap = {}
    for analyzer, metric in context.metric_map.items():
        v = (
            metric.value.get()
            if metric.value.is_success
            else type(metric.value.exception).__name__
        )
        if isinstance(v, float):
            v = _bits(v)
        snap[repr(analyzer)] = v
    return snap


# ---------------------------------------------------------------------------
# timeline derivation
# ---------------------------------------------------------------------------


class TestTimeline:
    def test_iso_date_layout_maps_to_epoch_days(self):
        names = [
            f"part-{(DAY0 + datetime.timedelta(days=d)).isoformat()}.parquet"
            for d in (0, 1, 5)
        ]
        tl = Timeline.derive([_P(n) for n in names])
        assert tl.axis == "date"
        assert tl.buckets == (
            DAY0.toordinal(),
            DAY0.toordinal() + 1,
            DAY0.toordinal() + 5,
        )

    def test_compact_yyyymmdd_layout(self):
        tl = Timeline.derive([_P("20260101.pq"), _P("20260103.pq")])
        assert tl.axis == "date"
        assert tl.buckets[1] - tl.buckets[0] == 2

    def test_compact_form_needs_digit_boundaries(self):
        # a 9-digit run is not a date; the lookaround guards reject it
        assert default_bucket_for("id-202601015.pq") is None

    def test_invalid_calendar_date_is_not_a_bucket(self):
        assert default_bucket_for("part-2026-13-40.parquet") is None

    def test_undated_layout_degrades_to_positional(self):
        tl = Timeline.derive([_P("a.parquet"), _P("b.parquet")])
        assert tl.axis == "index"
        assert tl.buckets == (0, 1)

    def test_one_undated_name_degrades_the_whole_layout(self):
        tl = Timeline.derive([_P("part-2026-01-01.pq"), _P("z.pq")])
        assert tl.axis == "index"

    def test_explicit_extractor_wins(self):
        tl = Timeline.derive(
            [_P("a"), _P("b")], extractor=lambda name: ord(name[0])
        )
        assert tl.buckets == (ord("a"), ord("b"))

    def test_extractor_must_bucket_every_partition(self):
        with pytest.raises(ValueError, match="extractor returned None"):
            Timeline.derive(
                [_P("a"), _P("b")],
                extractor=lambda name: None if name == "b" else 0,
            )

    def test_buckets_must_be_nondecreasing_in_name_order(self):
        # name order is the engine's merge order; buckets that decrease
        # along it would break window contiguity
        with pytest.raises(ValueError, match="non-decreasing"):
            Timeline(("a", "b"), (5, 3))

    def test_frame_and_indices_in(self):
        tl = Timeline(("a", "b", "c", "d"), (10, 11, 11, 14))
        assert tl.indices_in(11, 14) == (1, 2)
        frame = tl.frame(10, 12)
        assert frame.indices == (0, 1, 2)
        assert (frame.lo, frame.hi) == (10, 12)

    def test_shifted_frame_moves_earlier(self):
        tl = Timeline(("a", "b", "c"), (10, 11, 12))
        frame = tl.frame(11, 13)
        prior = frame.shifted(2, tl)
        assert (prior.lo, prior.hi) == (9, 11)
        assert prior.indices == (0,)


# ---------------------------------------------------------------------------
# the aligned power-of-two cover
# ---------------------------------------------------------------------------


class TestAlignedCover:
    def test_known_decomposition(self):
        assert aligned_cover(3, 20) == [(0, 3), (2, 4), (3, 8), (2, 16)]

    def test_empty_and_unit_ranges(self):
        assert aligned_cover(5, 5) == []
        assert aligned_cover(7, 8) == [(0, 7)]

    def test_negative_lo_rejected(self):
        with pytest.raises(ValueError):
            aligned_cover(-1, 4)

    def test_cover_properties_fuzzed(self):
        rng = np.random.default_rng(7)
        for _ in range(200):
            lo = int(rng.integers(0, 2000))
            hi = lo + int(rng.integers(1, 2000))
            spans = aligned_cover(lo, hi)
            cur = lo
            for level, start in spans:
                size = 1 << level
                assert start == cur  # contiguous, ascending
                assert start % size == 0 or start == 0  # aligned
                cur = start + size
            assert cur == hi  # exact cover
            # O(log n) spans: the segment-tree bound
            assert len(spans) <= 2 * max(1, (hi - lo).bit_length())

    def test_same_range_same_spans(self):
        assert aligned_cover(37, 1000) == aligned_cover(37, 1000)


# ---------------------------------------------------------------------------
# DQSG envelope serde
# ---------------------------------------------------------------------------


def _entries():
    blob_a = encode_states([(Size(), None)])
    blob_b = encode_states([(Size(), None)])
    return [("part-a", 10, blob_a), ("part-b", 11, blob_b)]


class TestSegmentSerde:
    def test_round_trip(self):
        entries = _entries()
        blob = encode_segment(3, 8, "sig-1", entries)
        seg = decode_segment(blob)
        assert (seg.level, seg.start, seg.signature) == (3, 8, "sig-1")
        assert seg.entries == entries
        assert seg.span == (8, 16)

    def test_corruption_fails_closed(self):
        blob = bytearray(encode_segment(1, 2, "sig", _entries()))
        blob[len(blob) // 2] ^= 0xFF
        with pytest.raises(StateDecodeError, match="digest"):
            decode_segment(bytes(blob))

    def test_truncation_fails_closed(self):
        blob = encode_segment(1, 2, "sig", _entries())
        for cut in (0, 3, len(blob) // 2, len(blob) - 1):
            with pytest.raises(StateDecodeError):
                decode_segment(blob[:cut])

    def test_version_bump_fails_closed(self):
        blob = encode_segment(1, 2, "sig", _entries())
        body = bytearray(blob[:-32])
        struct.pack_into(">I", body, len(SEGMENT_MAGIC), SEGMENT_FORMAT_VERSION + 1)
        import hashlib

        patched = bytes(body) + hashlib.sha256(bytes(body)).digest()
        with pytest.raises(StateDecodeError, match="version"):
            decode_segment(patched)

    def test_trailing_bytes_fail_closed(self):
        import hashlib

        body = encode_segment(1, 2, "sig", _entries())[:-32] + b"\x00"
        patched = body + hashlib.sha256(body).digest()
        with pytest.raises(StateDecodeError, match="trailing"):
            decode_segment(patched)


class TestSpanFingerprint:
    def test_stable_for_identical_members(self):
        members = [(10, "aa"), (11, "bb")]
        assert span_fingerprint(2, 8, members) == span_fingerprint(
            2, 8, list(members)
        )

    def test_any_change_changes_the_key(self):
        base = span_fingerprint(2, 8, [(10, "aa"), (11, "bb")])
        assert span_fingerprint(2, 8, [(10, "aa"), (11, "XX")]) != base
        assert span_fingerprint(2, 8, [(10, "aa"), (12, "bb")]) != base
        assert span_fingerprint(3, 8, [(10, "aa"), (11, "bb")]) != base
        assert span_fingerprint(2, 12, [(10, "aa"), (11, "bb")]) != base
        assert span_fingerprint(2, 8, [(10, "aa")]) != base

    def test_segment_keys_are_disjoint_from_partition_fingerprints(self):
        # partition fingerprints are bare hex; the seg- prefix keeps the
        # two families from colliding in the same repository slot
        assert segment_key(3, "ab" * 16).startswith("seg-L03-")


# ---------------------------------------------------------------------------
# SegmentStore: persistence + degrade paths
# ---------------------------------------------------------------------------


class TestSegmentStore:
    def _store(self):
        return SegmentStore(InMemoryStateRepository(), "ds", "sig-1")

    def test_save_has_load_round_trip(self):
        store = self._store()
        entries = _entries()
        fp = span_fingerprint(1, 2, [(10, "aa"), (11, "bb")])
        assert not store.has(1, fp)
        assert store.save(1, 2, fp, entries)
        assert store.has(1, fp)
        seg = store.load(1, fp)
        assert seg is not None and seg.entries == entries

    def test_missing_entry_is_a_silent_miss(self):
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            assert self._store().load(0, "0" * 32) is None

    def test_corrupt_entry_warns_dq323_and_misses(self):
        store = self._store()
        fp = "f" * 32
        store.repository.put_blob(
            "ds", "sig-1", segment_key(0, fp), b"DQSG garbage"
        )
        with pytest.warns(RuntimeWarning, match="DQ323"):
            assert store.load(0, fp) is None

    def test_signature_mismatch_warns_dq323_and_misses(self):
        store = self._store()
        fp = "e" * 32
        blob = encode_segment(0, 5, "OTHER-sig", _entries())
        store.repository.put_blob("ds", "sig-1", segment_key(0, fp), blob)
        with pytest.warns(RuntimeWarning, match="signature"):
            assert store.load(0, fp) is None

    def test_injected_read_fault_degrades_with_warning(self):
        store = self._store()
        fp = span_fingerprint(0, 5, [(5, "cc")])
        assert store.save(0, 5, fp, _entries())
        with faults.install("seed=1,state.segment:1.0:1"):
            with pytest.warns(RuntimeWarning, match="DQ323"):
                assert store.load(0, fp) is None
        # fault budget spent: the entry itself is intact
        assert store.load(0, fp) is not None

    def test_injected_write_fault_is_best_effort(self):
        store = self._store()
        fp = "d" * 32
        with faults.install("seed=1,state.segment:1.0:1"):
            assert store.save(0, 5, fp, _entries()) is False
        assert not store.has(0, fp)


# ---------------------------------------------------------------------------
# window specs
# ---------------------------------------------------------------------------


class TestWindowSpecs:
    TL = Timeline(
        ("a", "b", "c", "d", "e"), (100, 101, 102, 104, 106)
    )

    def test_tumbling_series_is_aligned_and_non_overlapping(self):
        frames = Tumbling(4).series(self.TL)
        assert [(f.lo, f.hi) for f in frames] == [(100, 104), (104, 108)]
        assert frames[0].indices == (0, 1, 2)
        assert frames[1].indices == (3, 4)

    def test_tumbling_resolve_is_the_latest_window(self):
        frame = Tumbling(4).resolve(self.TL)
        assert (frame.lo, frame.hi) == (104, 108)

    def test_sliding_resolve_ends_at_the_newest_bucket(self):
        frame = Sliding(3).resolve(self.TL)
        assert (frame.lo, frame.hi) == (104, 107)
        assert frame.indices == (3, 4)

    def test_sliding_series_steps(self):
        frames = Sliding(2, step=2).series(self.TL)
        assert all(f.hi - f.lo == 2 for f in frames)
        assert frames[-1].hi == 107

    def test_last_n_days_is_bucket_arithmetic(self):
        frame = LastN(3, unit="days").resolve(self.TL)
        assert frame.indices == (3, 4)  # buckets 104 and 106 in [104, 107)
        assert LastN(1, unit="days").resolve(self.TL).indices == (4,)

    def test_last_n_partitions_is_positional(self):
        frame = LastN(3, unit="partitions").resolve(self.TL)
        assert frame.indices == (2, 3, 4)

    def test_invalid_specs_rejected(self):
        with pytest.raises(ValueError):
            Tumbling(0)
        with pytest.raises(ValueError):
            Sliding(2, step=0)
        with pytest.raises(ValueError):
            LastN(2, unit="weeks")

    def test_describe_round_trips_through_repr(self):
        assert repr(Sliding(7)) == "sliding(7, step=1)"
        assert repr(LastN(7)) == "last(7 days)"


# ---------------------------------------------------------------------------
# WindowQuery end to end
# ---------------------------------------------------------------------------


@pytest.fixture()
def daily(tmp_path, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    monkeypatch.delenv("DEEQU_TPU_STATE_CACHE", raising=False)
    _write_daily_dataset(tmp_path / "ds", 10)
    repo = FileSystemStateRepository(str(tmp_path / "cache"))

    def query():
        source = Table.scan_parquet_dataset(str(tmp_path / "ds"))
        return WindowQuery(
            source, _ANALYZERS, repository=repo, dataset="t"
        ), source

    return tmp_path, repo, query


class TestWindowQueryEndToEnd:
    def test_rejects_grouping_and_non_scan_shareable(self, daily):
        _, repo, query = daily
        q, source = query()
        with pytest.raises(ValueError, match="scan-shareable"):
            WindowQuery(
                source, [CountDistinct(["g"])], repository=repo, dataset="t"
            )
        with pytest.raises(ValueError, match="at least one analyzer"):
            WindowQuery(source, [], repository=repo, dataset="t")
        assert len(q.analyzers) == len(_ANALYZERS)

    def test_cold_plan_reports_dq323_and_rescans(self, daily):
        _, _, query = daily
        q, _ = query()
        plan = q.plan(Sliding(7))
        assert plan.segment_hits == 0
        assert len(plan.partitions_rescanned) == 7
        assert plan.predicted_scan_bytes > 0
        [diag] = plan.diagnostics
        assert diag.code == "DQ323"
        # the caret line underlines the spec text
        rendered = diag.render()
        assert "sliding(7" in rendered and "^" in rendered

    def test_cold_then_warm_bit_identical_with_zero_rows(self, daily):
        _, _, query = daily
        q, source = query()
        cold = q.run(Sliding(7))
        assert [d.code for d in cold.validation_warnings] == ["DQ323"]

        q2, source = query()
        warm = q2.run(Sliding(7), tracing=True)
        plan = warm.window_plan
        assert plan.segment_hits == plan.segments_merged > 0
        assert plan.partitions_rescanned == ()
        assert warm.validation_warnings == []
        counters = warm.run_trace.counters
        assert counters.get("partitions_scanned", 0) == 0
        assert counters["window.segment_hits"] == counters["window.spans"]
        assert counters["window.partitions"] == 7

        parts = source.partitions()
        frame = Sliding(7).resolve(q2.timeline())
        rescan = AnalysisRunner.do_analysis_run(
            source.subset([parts[i].path for i in frame.indices]), _ANALYZERS
        )
        assert _snapshot(warm) == _snapshot(cold) == _snapshot(rescan)

    def test_late_partition_invalidates_o_log_n_spans(self, daily):
        tmp_path, _, query = daily
        q, _ = query()
        q.run(Sliding(7))  # publish covers for days 0..9

        # day 10 arrives late
        day = DAY0 + datetime.timedelta(days=10)
        path = tmp_path / "ds" / f"part-{day.isoformat()}.parquet"
        _daily_table(np.random.default_rng(99)).to_parquet(
            str(path), row_group_size=128
        )

        q2, _ = query()
        plan = q2.plan(Sliding(7))
        n = len(plan.frame.indices)
        # only the spans covering the new day miss; the rest still hit
        assert 1 <= plan.segment_misses <= max(1, 2 * n.bit_length())
        assert plan.partitions_rescanned == (path.name,)
        ctx = q2.run(Sliding(7), tracing=True)
        assert ctx.run_trace.counters.get("partitions_scanned", 0) == 1

    def test_restated_partition_self_invalidates(self, daily):
        tmp_path, _, query = daily
        q, _ = query()
        q.run(Sliding(7))
        day = DAY0 + datetime.timedelta(days=8)
        path = tmp_path / "ds" / f"part-{day.isoformat()}.parquet"
        _daily_table(np.random.default_rng(1234), n=300).to_parquet(
            str(path), row_group_size=128
        )
        q2, source = query()
        plan = q2.plan(Sliding(7))
        assert plan.partitions_rescanned == (path.name,)
        ctx = q2.run(Sliding(7))
        parts = source.partitions()
        frame = Sliding(7).resolve(q2.timeline())
        rescan = AnalysisRunner.do_analysis_run(
            source.subset([parts[i].path for i in frame.indices]), _ANALYZERS
        )
        assert _snapshot(ctx) == _snapshot(rescan)

    def test_corrupt_segment_degrades_and_rebuilds(self, daily):
        tmp_path, _, query = daily
        q, _ = query()
        baseline = _snapshot(q.run(Sliding(7)))
        seg_files = glob.glob(
            str(tmp_path / "cache" / "**" / "*seg-L*"), recursive=True
        )
        assert seg_files
        with open(seg_files[0], "r+b") as fh:
            fh.seek(10)
            fh.write(b"\xde\xad\xbe\xef")
        q2, _ = query()
        with pytest.warns(RuntimeWarning, match="DQ323"):
            again = q2.run(Sliding(7))
        assert _snapshot(again) == baseline
        # the rewrite healed the store: clean warm pass now
        q3, _ = query()
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            healed = q3.run(Sliding(7))
        assert _snapshot(healed) == baseline

    def test_states_returns_a_signed_bag(self, daily):
        _, _, query = daily
        q, _ = query()
        bag = q.states(LastN(5, unit="partitions"))
        assert len(bag) == len(_ANALYZERS)
        assert bag.signature == q.signature()
        assert bag.label
        mean_state = bag.get(Mean("x"))
        assert mean_state is not None
        assert math.isfinite(mean_state.metric_value())

    def test_admission_cost_carries_window_fields(self, daily):
        _, _, query = daily
        q, _ = query()
        q.run(Sliding(7))  # warm the covers
        q2, _ = query()
        cost = q2.admission_cost(Sliding(7))
        assert cost.window_spec.startswith("sliding(7")
        assert cost.window_segments_merged > 0
        assert cost.window_partitions_rescanned == 0
        assert cost.saved_window_bytes > 0
        assert cost.predicted_scan_bytes == 0


# ---------------------------------------------------------------------------
# EXPLAIN + drift pins over a window cost
# ---------------------------------------------------------------------------


class TestWindowExplainAndPins:
    def test_explain_renders_the_windows_line(self, daily):
        from deequ_tpu_torch.lint.explain import render_explain

        _, _, query = daily
        q, _ = query()
        q.run(Sliding(7))
        q2, _ = query()
        cost = q2.admission_cost(Sliding(7))
        text = render_explain(cost, diagnostics=[])
        assert "windows:" in text
        assert "sliding(7" in text
        assert "segment merges" in text

    def test_cost_drift_pins_window_counters(self, daily):
        from deequ_tpu_torch.lint.cost import cost_drift

        _, _, query = daily
        q, _ = query()
        q.run(Sliding(7))
        q2, _ = query()
        cost = q2.admission_cost(Sliding(7))
        ctx = q2.run(Sliding(7), tracing=True)
        drift = cost_drift(cost, ctx.run_trace)
        assert drift["drift.window_segments_merged"] == 0.0
        assert drift["drift.window_partitions_rescanned"] == 0.0


# ---------------------------------------------------------------------------
# telemetry: the window series the sentinel watches
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# the service: submit_window
# ---------------------------------------------------------------------------


class TestServiceSubmitWindow:
    def test_submit_window_happy_path(self, daily):
        from deequ_tpu_torch.service.service import DQService

        tmp_path, repo, _ = daily
        source = Table.scan_parquet_dataset(str(tmp_path / "ds"))
        with DQService(workers=1, state_repository=repo) as svc:
            handle = svc.submit_window("tenant-a", "t", source, window=Sliding(7), analyzers=_ANALYZERS)
            assert handle.wait(120)
            assert handle.status == "done", (handle.reason, handle.error)
            plan = handle.result.window_plan
            assert plan.segments_merged > 0
        # the second submission is warm: interactive, no rescan
        with DQService(workers=1, state_repository=repo) as svc:
            handle = svc.submit_window("tenant-a", "t", source, window=Sliding(7), analyzers=_ANALYZERS)
            assert handle.wait(120)
            assert handle.status == "done", (handle.reason, handle.error)
            assert handle.result.window_plan.partitions_rescanned == ()

    def test_submit_window_requires_a_repository(self, daily):
        from deequ_tpu_torch.service.codes import DQ_REJECTED
        from deequ_tpu_torch.service.service import DQService

        tmp_path, _, _ = daily
        source = Table.scan_parquet_dataset(str(tmp_path / "ds"))
        with DQService(workers=1) as svc:
            handle = svc.submit_window("tenant-a", "t", source, window=Sliding(7), analyzers=_ANALYZERS)
            assert handle.status == "rejected"
            assert handle.code == DQ_REJECTED


class TestWindowTelemetry:
    def test_segment_hit_ratio_derived_from_trace(self, daily):
        from deequ_tpu_torch.observe.telemetry import engine_metric_record

        _, _, query = daily
        q, _ = query()
        q.run(Sliding(7))
        q2, _ = query()
        ctx = q2.run(Sliding(7), tracing=True)
        rec = engine_metric_record(ctx.run_trace, None)
        assert rec["engine.window.segment_hit_ratio"] == 1.0

    def test_record_window_run_flattens_drift(self, daily):
        from deequ_tpu_torch.checks import CheckLevel, DriftCheck
        from deequ_tpu_torch.repository import InMemoryMetricsRepository
        from deequ_tpu_torch.repository.engine import (
            engine_series,
            record_window_run,
        )

        _, _, query = daily
        q, _ = query()
        ctx = q.run(Sliding(7), tracing=True)
        timeline = q.timeline()
        current = Sliding(5).resolve(timeline)
        baseline = current.shifted(5, timeline)
        check = DriftCheck(CheckLevel.ERROR, "wow").has_no_mean_drift(
            "x", max_relative_delta=0.5
        )
        result = check.evaluate(
            current=q.states(current), baseline=q.states(baseline)
        )
        repo = InMemoryMetricsRepository()
        record_window_run(
            repo,
            ctx.run_trace,
            drift_result=result,
            suite="windows",
            dataset="t",
        )
        [pt] = engine_series(repo, "engine.drift.failed_constraints")
        assert pt.metric_value == 0.0
        [pt] = engine_series(repo, "engine.drift.value_max")
        assert 0.0 <= pt.metric_value < 0.5
        [pt] = engine_series(repo, "engine.window.segment_hit_ratio")
        assert 0.0 <= pt.metric_value <= 1.0


# ---------------------------------------------------------------------------
# the JAX package's windows over the same partitions
# ---------------------------------------------------------------------------


_JAX_KNOBS = {
    "DEEQU_TPU_PLACEMENT": "device",
    "DEEQU_TPU_ENCODED_FOLD": "0",
}


@pytest.mark.parametrize("spec", [("Sliding", 7), ("Tumbling", 4), ("LastN", 10)], ids=str)
def test_window_metrics_equal_the_jax_window_query(spec, tmp_path, monkeypatch):
    """Each package fills its own repository from the same ten daily
    partitions and answers the same window cold, then warm: float sums
    within 1e-12 relative, everything else exact (ROADMAP section 3)."""
    import deequ_tpu.analyzers as J
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.repository.states import FileSystemStateRepository as JRepo
    from deequ_tpu import windows as jwin
    from deequ_tpu.windows import WindowQuery as JWindowQuery
    from torch_stream_helpers import assert_metric_equal

    kind, size = spec
    window, jwindow = globals()[kind](size), getattr(jwin, kind)(size)

    for key, value in _JAX_KNOBS.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("DEEQU_TPU_STATE_CACHE", raising=False)
    _write_daily_dataset(tmp_path / "ds", 10, seed=4)
    janalyzers = [getattr(J, type(a).__name__)(*_args(a)) for a in _ANALYZERS]
    assert [repr(a) for a in janalyzers] == [repr(a) for a in _ANALYZERS]
    jq = JWindowQuery(JTable.scan_parquet_dataset(str(tmp_path / "ds")), janalyzers,
                      repository=JRepo(str(tmp_path / "jcache")), dataset="t")
    pq_ = WindowQuery(Table.scan_parquet_dataset(str(tmp_path / "ds")), _ANALYZERS,
                      repository=FileSystemStateRepository(str(tmp_path / "pcache")), dataset="t")
    for _ in ("cold", "warm"):
        jctx, pctx = jq.run(jwindow), pq_.run(window)
        jplan, plan = jctx.window_plan, pctx.window_plan
        assert (plan.spec_text, plan.frame.lo, plan.frame.hi, plan.frame.indices) == (
            jplan.spec_text, jplan.frame.lo, jplan.frame.hi, jplan.frame.indices)
        assert (plan.segments_merged, plan.segment_hits, plan.partitions_rescanned) == (
            jplan.segments_merged, jplan.segment_hits, jplan.partitions_rescanned)
        assert [(s.span, s.fingerprint) for s in plan.spans] == [(s.span, s.fingerprint) for s in jplan.spans]
        for ja, pa in zip(janalyzers, _ANALYZERS):
            assert_metric_equal(jctx.metric_map[ja], pctx.metric_map[pa], repr(pa))


def _args(analyzer):
    """The constructor arguments of the analyzers in `_ANALYZERS`."""
    name = type(analyzer).__name__
    if name == "Size":
        return ()
    if name == "ApproxQuantile":
        return (analyzer.column, analyzer.quantile)
    return (analyzer.column,)


def test_equal_states_give_equal_segment_bytes(monkeypatch):
    """A partition's states computed by the JAX package and carried into
    the port (deequ_tpu_torch/interop.py) encode to the same DQST bytes,
    and a span of them to the same DQSG bytes, fingerprint and key."""
    import dataclasses

    import deequ_tpu.analyzers as J
    from deequ_tpu.data.table import ColumnType as JType
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.ops.fused import FusedScanPass as JPass
    from deequ_tpu.repository.states import encode_states as jencode_states
    from deequ_tpu.windows import segments as jseg
    from deequ_tpu_torch.interop import state_from_reference

    def carried(state):
        if type(state).__name__ == "ApproxQuantileState":
            k, n, levels = state.digest.to_arrays()
            fields = {"k": k, "n": n, "levels": levels, "rng_state": state.digest.rng_state_bytes()}
        else:
            fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
        return state_from_reference(type(state).__name__, fields)

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    janalyzers = [getattr(J, type(a).__name__)(*_args(a)) for a in _ANALYZERS]
    jentries, pentries, members = [], [], []
    for i in range(4):
        table = _daily_table(np.random.default_rng(70 + i))
        jtable = JTable.from_pydict(table.to_pydict(), types={
            "x": JType.DOUBLE, "y": JType.DOUBLE, "g": JType.LONG})
        jstates = [r.state for r in JPass(janalyzers).run(jtable)]
        jblob = jencode_states(list(zip(janalyzers, jstates)))
        pblob = encode_states(list(zip(_ANALYZERS, [carried(s) for s in jstates])))
        assert pblob == jblob
        name, bucket = f"part-{i}", 100 + i
        jentries.append((name, bucket, jblob))
        pentries.append((name, bucket, pblob))
        members.append((bucket, f"fp{i:02d}"))
    assert encode_segment(2, 100, "sig", pentries) == jseg.encode_segment(2, 100, "sig", jentries)
    assert span_fingerprint(2, 100, members) == jseg.span_fingerprint(2, 100, members)
    fp = span_fingerprint(2, 100, members)
    assert segment_key(2, fp) == jseg.segment_key(2, fp)
    assert (SEGMENT_MAGIC, SEGMENT_FORMAT_VERSION) == (jseg.SEGMENT_MAGIC, jseg.SEGMENT_FORMAT_VERSION)
    for lo, hi in [(0, 1), (3, 17), (100, 107), (5, 1029)]:
        assert aligned_cover(lo, hi) == jseg.aligned_cover(lo, hi)


def test_window_specs_equal_jax_over_a_daily_timeline():
    from deequ_tpu import windows as jwin

    names = [f"ev-{(DAY0 + datetime.timedelta(days=d)).isoformat()}.parquet" for d in range(0, 60, 1) if d % 9]
    tl = Timeline.derive([_P(n) for n in names])
    jtl = jwin.Timeline.derive([_P(n) for n in names])
    assert (tl.names, tl.buckets, tl.axis) == (jtl.names, jtl.buckets, jtl.axis)
    for spec, jspec in [(Sliding(7), jwin.Sliding(7)), (Sliding(5, step=3), jwin.Sliding(5, step=3)),
                        (Tumbling(7, origin=DAY0.toordinal()), jwin.Tumbling(7, origin=DAY0.toordinal())),
                        (LastN(14), jwin.LastN(14)), (LastN(4, unit="partitions"), jwin.LastN(4, unit="partitions"))]:
        assert repr(spec) == repr(jspec)
        frames, jframes = spec.series(tl), jspec.series(jtl)
        assert [(f.label, f.lo, f.hi, f.indices) for f in frames] == [
            (f.label, f.lo, f.hi, f.indices) for f in jframes
        ]
        r, jr = spec.resolve(tl), jspec.resolve(jtl)
        assert (r.label, r.lo, r.hi, r.indices) == (jr.label, jr.lo, jr.hi, jr.indices)
