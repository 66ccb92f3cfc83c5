"""Observability subsystem (deequ_tpu_torch.observe) tests.

Covers the trace primitives (no-op fast path, span nesting, thread
isolation + worker attachment), Chrome-trace export schema (B/E nesting
discipline, required fields, multihost merge), the golden run report,
counter parity with ExecutionStats (bit-for-bit), the family-kernel
span-per-(where, cap, dtype) invariant, and the differential guarantee
that tracing never changes metric values.

Port-mapped from tests/test_observe.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import json
import threading

import numpy as np
import pytest

from deequ_tpu_torch import observe
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.observe.spans import _NOOP, Span
from deequ_tpu_torch.ops import native, runtime

pytestmark = pytest.mark.usefixtures("cpu_default")

needs_native = pytest.mark.skipif(
    not native.available(), reason="native kernels unavailable"
)


def _small_table(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return Table.from_numpy(
        {
            "x": rng.standard_normal(n),
            "y": rng.random(n) * 100.0,
            "flag": rng.random(n) < 0.5,
        }
    )


def _scan_analyzers():
    from deequ_tpu_torch.analyzers import Maximum, Mean, Minimum, StandardDeviation

    return [Mean("x"), StandardDeviation("x"), Minimum("y"), Maximum("y")]


def _run_analysis(table, tracing=None):
    from deequ_tpu_torch.runners import AnalysisRunner

    builder = AnalysisRunner.on_data(table).add_analyzers(_scan_analyzers())
    if tracing is not None:
        builder = builder.with_tracing(tracing)
    return builder.run()


# -- no-op fast path ---------------------------------------------------------


class TestNoopFastPath:
    def test_span_returns_falsy_singleton_when_untraced(self):
        sp = observe.span("anything", cat="dispatch", rows=7)
        assert sp is _NOOP
        assert not sp
        with sp as inner:
            assert inner is _NOOP
        # inert attribute surface
        assert sp.set(rows=1) is _NOOP
        assert sp.add("rows", 1) is _NOOP

    def test_annotate_and_counters_safe_when_untraced(self):
        observe.annotate(rows=1)  # must not raise
        assert observe.current_tracer() is None
        assert observe.current_span() is None

    def test_traced_run_disabled_yields_falsy_handle(self):
        with observe.traced_run("run", enable=False) as handle:
            assert not handle
            assert observe.span("x") is _NOOP
        assert handle.trace is None


# -- span tree ---------------------------------------------------------------


class TestSpanTree:
    def test_nesting_and_attrs(self):
        with observe.tracing() as tracer:
            with observe.span("outer", cat="scan") as outer:
                with observe.span("inner", cat="dispatch", rows=3) as inner:
                    observe.annotate(extra=1)
        assert tracer.roots == [outer]
        assert outer.children == [inner]
        assert inner.attrs == {"rows": 3, "extra": 1}
        assert inner.t0 >= outer.t0
        assert inner.t1 <= outer.t1 or inner.duration_s <= outer.duration_s

    def test_error_annotated_on_exception(self):
        with observe.tracing() as tracer:
            with pytest.raises(ValueError):
                with observe.span("boom"):
                    raise ValueError("x")
        assert tracer.roots[0].attrs["error"] == "ValueError"

    def test_tracer_count_lands_on_current_span(self):
        with observe.tracing() as tracer:
            with observe.span("s") as sp:
                tracer.count("device_passes", label="p1")
                tracer.count("device_passes")
        assert tracer.counters == {"device_passes": 2}
        assert tracer.labels == ["p1"]
        assert sp.attrs["device_passes"] == 2

    def test_attached_adopts_dispatcher_context(self):
        results = {}

        def worker(tracer, parent):
            with observe.attached(tracer, parent):
                with observe.span("worker_span", cat="dispatch") as sp:
                    results["span"] = sp

        with observe.tracing() as tracer:
            with observe.span("dispatcher") as parent:
                t = threading.Thread(
                    target=worker,
                    args=(observe.current_tracer(), observe.current_span()),
                )
                t.start()
                t.join()
        assert results["span"] in parent.children
        # worker thread gets its own tid for the exporter
        assert results["span"].tid != parent.tid

    def test_attached_none_is_noop(self):
        with observe.attached(None, None):
            assert observe.span("x") is _NOOP


# -- thread isolation (satellite: two monitored scans on two threads) --------


class TestThreadLocalIsolation:
    def test_two_monitored_scans_on_separate_threads(self):
        table = _small_table()
        _run_analysis(table)  # warm up compilation outside the threads

        barrier = threading.Barrier(2)
        out = {}

        def scan(tag, reps):
            with runtime.monitored() as stats:
                barrier.wait(timeout=30)
                for _ in range(reps):
                    _run_analysis(_small_table(seed=hash(tag) % 100))
            out[tag] = stats

        t_a = threading.Thread(target=scan, args=("a", 2))
        t_b = threading.Thread(target=scan, args=("b", 1))
        t_a.start(), t_b.start()
        t_a.join(), t_b.join()

        # each thread's stats count ONLY its own passes — no cross-talk
        # through the thread-local sink stack
        assert out["a"].device_passes == 2
        assert out["b"].device_passes == 1
        assert len(out["a"].pass_labels) == 2
        assert len(out["b"].pass_labels) == 1

    def test_tracing_is_thread_local(self):
        seen = {}

        def other():
            seen["tracer"] = observe.current_tracer()
            seen["span"] = observe.span("x")

        with observe.tracing():
            with observe.span("main"):
                t = threading.Thread(target=other)
                t.start()
                t.join()
        assert seen["tracer"] is None
        assert seen["span"] is _NOOP


# -- Chrome-trace export schema ----------------------------------------------


def _check_event_schema(doc):
    events = doc["traceEvents"]
    assert doc["displayTimeUnit"] == "ms"
    assert "process_index" in doc["metadata"]
    stacks = {}
    saw_meta = False
    for event in events:
        assert event["ph"] in ("B", "E", "M")
        if event["ph"] == "M":
            saw_meta = True
            assert event["name"] == "process_name"
            continue
        for field in ("ts", "pid", "tid", "name"):
            assert field in event, (field, event)
        assert isinstance(event["ts"], float) and event["ts"] >= 0.0
        stack = stacks.setdefault((event["pid"], event["tid"]), [])
        if event["ph"] == "B":
            assert "args" in event and "cpu_ms" in event["args"]
            stack.append((event["name"], event["ts"]))
        else:
            name, begin_ts = stack.pop()  # E must close the innermost B
            assert name == event["name"]
            assert event["ts"] >= begin_ts
    assert saw_meta
    assert all(not stack for stack in stacks.values()), "unclosed B events"


class TestChromeTraceExport:
    def test_traced_verification_run_schema(self):
        from deequ_tpu_torch.checks.check import Check, CheckLevel
        from deequ_tpu_torch.verification.suite import VerificationSuite

        check = (
            Check(CheckLevel.ERROR, "basics")
            .is_complete("x")
            .has_min("y", lambda v: v >= 0.0)
        )
        result = (
            VerificationSuite.on_data(_small_table())
            .add_check(check)
            .with_tracing(True)
            .run()
        )
        trace = result.run_trace
        assert trace is not None
        doc = trace.to_chrome_trace()
        _check_event_schema(doc)
        json.loads(json.dumps(doc))  # valid JSON end to end
        names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "B"}
        assert {"verification_suite", "analysis_run", "constraint_eval"} <= names
        assert {"plan_validate", "plan_fuse", "fused_scan"} <= names

    def test_write_and_reload(self, tmp_path):
        path = str(tmp_path / "trace.json")
        ctx = _run_analysis(_small_table(), tracing=path)
        assert ctx.run_trace.path == path
        with open(path, encoding="utf-8") as f:
            doc = json.load(f)
        _check_event_schema(doc)

    def test_merge_chrome_traces_repids_collisions(self, tmp_path):
        root_a, root_b = Span("run_a"), Span("run_b")
        for root in (root_a, root_b):
            root.t0, root.t1 = 0.0, 0.001
        path_a = observe.write_chrome_trace(str(tmp_path / "a.json"), [root_a])
        path_b = observe.write_chrome_trace(str(tmp_path / "b.json"), [root_b])
        out = str(tmp_path / "merged.json")
        merged = observe.merge_chrome_traces([path_a, path_b], out)
        pids = {e["pid"] for e in merged["traceEvents"]}
        assert len(pids) == 2  # same recorded index, re-pidded apart
        with open(out, encoding="utf-8") as f:
            assert len(json.load(f)["metadata"]["merged_from"]) == 2

    def test_env_knob(self, tmp_path, monkeypatch):
        out = str(tmp_path / "env_trace.json")
        monkeypatch.setenv(observe.ENV_KNOB, "1")
        monkeypatch.setenv(observe.ENV_OUT, out)
        ctx = _run_analysis(_small_table())  # tracing=None → env decides
        assert ctx.run_trace is not None
        with open(out, encoding="utf-8") as f:
            _check_event_schema(json.load(f))

    @pytest.mark.parametrize("value", ["", "0", "false", "off", "no"])
    def test_env_knob_falsey(self, value, monkeypatch):
        monkeypatch.setenv(observe.ENV_KNOB, value)
        assert not observe.env_enabled()
        ctx = _run_analysis(_small_table())
        assert ctx.run_trace is None


# -- golden run report --------------------------------------------------------


def _mk_span(name, cat, t0, t1, cpu=None, **attrs):
    s = Span(name, cat, attrs)
    s.t0, s.t1 = t0, t1
    s.cpu0, s.cpu1 = 0.0, (cpu if cpu is not None else 0.0)
    return s


def _golden_forest():
    root = _mk_span("analysis_run", "run", 0.0, 0.1, cpu=0.08, analyzers=3)
    plan = _mk_span("plan_fuse", "plan", 0.0, 0.01)
    scan = _mk_span("fused_scan", "scan", 0.01, 0.09)
    scan.children += [
        _mk_span("dispatch", "dispatch", 0.01, 0.03, rows=500),
        _mk_span("dispatch", "dispatch", 0.03, 0.05, rows=500),
        _mk_span("transfer", "transfer", 0.05, 0.07, bytes=1024),
        _mk_span("merge", "merge", 0.07, 0.08),
    ]
    root.children += [plan, scan]
    return root


GOLDEN_REPORT = (
    "deequ_tpu run report — analysis_run\n"
    "wall 100.0 ms | cpu 80.0 ms | device_passes 1\n"
    "analysis_run                                    100.0 ms  analyzers=3\n"
    "├─ plan_fuse                                     10.0 ms  [plan]\n"
    "└─ fused_scan                                    80.0 ms  [scan]\n"
    "   ├─ dispatch ×2                                40.0 ms  [dispatch]\n"
    "   ├─ transfer                                   20.0 ms  [transfer]  bytes=1024\n"
    "   └─ merge                                      10.0 ms  [merge]\n"
    "phases (self-time): dispatch 0.040s | transfer 0.020s | run 0.010s"
    " | plan 0.010s | merge 0.010s | scan 0.010s"
)


class TestRunReport:
    def test_golden_rendering(self):
        out = observe.render_report(
            [_golden_forest()], counters={"device_passes": 1}
        )
        assert out == GOLDEN_REPORT

    def test_phase_seconds_buckets_are_disjoint_self_time(self):
        phases = observe.phase_seconds([_golden_forest()])
        for phase in observe.PHASES:
            assert phase in phases
        assert phases["dispatch"] == pytest.approx(0.04)
        assert phases["transfer"] == pytest.approx(0.02)
        # disjoint self-times sum to the root's wall time
        assert sum(phases.values()) == pytest.approx(0.1)

    def test_empty_forest(self):
        assert "no spans" in observe.render_report([])

    def test_live_run_report_renders(self):
        ctx = _run_analysis(_small_table(), tracing=True)
        text = ctx.run_trace.report()
        assert text.startswith("deequ_tpu run report — analysis_run")
        assert "device_passes 1" in text
        assert "phases (self-time):" in text


# -- counter parity with ExecutionStats (bit-for-bit) -------------------------


class TestCounterParity:
    def test_trace_counters_match_execution_stats(self):
        with runtime.monitored() as stats:
            ctx = _run_analysis(_small_table(), tracing=True)
        trace = ctx.run_trace
        assert trace.counters.get("device_passes", 0) == stats.device_passes
        assert trace.counters.get("device_launches", 0) == stats.device_launches
        assert trace.counters.get("group_passes", 0) == stats.group_passes
        # ...and the run root span carries the same deltas as attributes
        for key, value in trace.counters.items():
            assert trace.root.attrs[key] == value

    def test_grouping_counts_match(self):
        from deequ_tpu_torch.analyzers import Uniqueness
        from deequ_tpu_torch.runners import AnalysisRunner

        table = Table.from_pydict(
            {"att1": ["a", "b", "a", "c", "b", "a"]}
        )
        with runtime.monitored() as stats:
            ctx = (
                AnalysisRunner.on_data(table)
                .add_analyzer(Uniqueness(["att1"]))
                .with_tracing(True)
                .run()
            )
        assert stats.group_passes == 1
        assert ctx.run_trace.counters.get("group_passes", 0) == 1
        names = {s.name for s in ctx.run_trace.spans()}
        assert {"grouping", "group_pass", "freq_agg"} <= names


# -- one family_kernel dispatch per (where, cap, dtype) group -----------------


@needs_native
class TestFamilyKernelSpans:
    def test_one_span_per_family_group(self, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
        from deequ_tpu_torch.analyzers import (
            ApproxCountDistinct,
            ApproxQuantile,
            ApproxQuantiles,
            Mean,
            StandardDeviation,
        )
        from deequ_tpu_torch.runners import AnalysisRunner

        rng = np.random.default_rng(7)
        n = 200_000  # family kernels only engage on high-cardinality cols
        table = Table.from_numpy(
            {
                "a": rng.lognormal(1.0, 0.7, n),
                "b": rng.random(n) * 1000.0,
                "c": rng.standard_normal(n) * 50.0,
                "flag": rng.random(n) < 0.5,
            }
        )
        analyzers = []
        for col in ("a", "b", "c"):
            analyzers += [
                ApproxQuantiles(col, (0.25, 0.5, 0.75)),
                Mean(col),
                StandardDeviation(col),
                ApproxCountDistinct(col),
            ]
        analyzers.append(ApproxQuantile("a", 0.5, where="flag"))
        with runtime.monitored() as stats:
            ctx = (
                AnalysisRunner.on_data(table)
                .add_analyzers(analyzers)
                .with_tracing(True)
                .run()
            )
        fams = [
            s for s in ctx.run_trace.spans() if s.name == "family_kernel"
        ]
        keys = [
            (s.attrs["where"], s.attrs["cap"], s.attrs["dtype"])
            for s in fams
        ]
        # exactly ONE kernel dispatch span per (where, cap, dtype) family
        assert len(keys) == len(set(keys))
        wheres = {k[0] for k in keys}
        assert wheres == {"where:<all>", "where:flag"}
        batched = {s.attrs["where"]: s.attrs for s in fams}
        assert batched["where:<all>"]["columns"] == 3
        assert batched["where:<all>"]["batched"] is True
        assert batched["where:flag"]["columns"] == 1
        # the whole multi-family run is still ONE fused scan pass
        assert stats.device_passes == 1
        assert ctx.run_trace.counters["device_passes"] == 1


# -- differential: tracing never changes metric values ------------------------


class TestTracingIsInert:
    def test_metrics_bit_identical_with_and_without_tracing(self):
        from deequ_tpu_torch.analyzers import (
            Completeness,
            Maximum,
            Mean,
            Minimum,
            StandardDeviation,
            Uniqueness,
        )
        from deequ_tpu_torch.runners import AnalysisRunner

        def run(tracing):
            table = Table.from_pydict(
                {
                    "x": [float(i) * 1.7 for i in range(1000)],
                    "g": [str(i % 7) for i in range(1000)],
                }
            )
            builder = AnalysisRunner.on_data(table).add_analyzers(
                [
                    Mean("x"),
                    StandardDeviation("x"),
                    Minimum("x"),
                    Maximum("x"),
                    Completeness("x"),
                    Uniqueness(["g"]),
                ]
            )
            if tracing is not None:
                builder = builder.with_tracing(tracing)
            ctx = builder.run()
            return {
                repr(a): m.value.get()
                for a, m in ctx.metric_map.items()
                if m.value.is_success
            }

        plain = run(None)
        traced = run(True)
        off = run(False)
        assert plain.keys() == traced.keys() == off.keys()
        for key in plain:
            assert plain[key] == traced[key] == off[key], key  # bit-identical


# -- read-ahead fold into pipeline occupancy -------------


class TestReadaheadOccupancy:
    """The native reader's read-ahead window (`page_read` spans +
    `readahead_hit` attrs on `page_decode`) folds into
    `pipeline_occupancy` as a synthetic "read" row, promoted to the
    bottleneck slot when prefetch misses dominate."""

    def _forest(self, hits, misses):
        root = _mk_span("analysis_run", "run", 0.0, 1.0)
        decode = _mk_span("pipe_stage", "pipeline", 0.0, 1.0, stage="decode")
        decode.children.append(_mk_span("pipe_item", "pipeline", 0.0, 0.4))
        fold = _mk_span("pipe_stage", "pipeline", 0.0, 1.0, stage="fold")
        fold.children.append(_mk_span("pipe_item", "pipeline", 0.0, 0.9))
        root.children += [decode, fold]
        root.children += [
            _mk_span("page_read", "io", 0.0, 0.3),
            _mk_span("page_read", "io", 0.3, 0.5),
        ]
        for i in range(hits):
            root.children.append(
                _mk_span("page_decode", "io", 0.5, 0.6, readahead_hit=True)
            )
        for i in range(misses):
            root.children.append(
                _mk_span("page_decode", "io", 0.6, 0.7, readahead_hit=False)
            )
        return root

    def test_miss_dominated_promotes_read_to_bottleneck(self):
        rows = observe.pipeline_occupancy([self._forest(hits=1, misses=3)])
        assert rows[0]["stage"] == "read"
        assert rows[0]["readahead_hits"] == 1
        assert rows[0]["readahead_misses"] == 3
        assert rows[0]["items"] == 2  # two page_read fetches
        # fetch wall is the widest stage's wall; busy is the fetch time
        assert rows[0]["wall_s"] == pytest.approx(1.0)
        assert rows[0]["busy_s"] == pytest.approx(0.5)
        assert rows[0]["occupancy"] == pytest.approx(0.5)

    def test_hit_dominated_read_row_trails(self):
        rows = observe.pipeline_occupancy([self._forest(hits=3, misses=1)])
        assert rows[0]["stage"] == "fold"  # busiest pipe stage leads
        assert rows[-1]["stage"] == "read"
        assert rows[-1]["readahead_hits"] == 3

    def test_no_pipe_stages_means_no_occupancy_rows(self):
        """Serial native-reader runs record page_read spans but no pipe
        stages; the occupancy table stays empty (its golden contract)."""
        root = _mk_span("analysis_run", "run", 0.0, 1.0)
        root.children.append(_mk_span("page_read", "io", 0.0, 0.3))
        assert observe.pipeline_occupancy([root]) == []

    def test_render_report_carries_readahead_suffix(self):
        text = observe.render_report([self._forest(hits=1, misses=3)])
        assert "readahead 1h/3m" in text
        assert "read" in text.split("bottleneck")[0]  # promoted row
