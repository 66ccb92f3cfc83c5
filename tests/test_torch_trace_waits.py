"""The port's waits, input builds, spill spans and device-trace clock
(observe/spans.py `waiting`, ops/pipeline.py, data/source.py,
ops/fused.py `HostInputs` and `program_timer`, analyzers/freq_spill.py,
observe/export.py `on_span_clock`), on the CPU."""

from __future__ import annotations

import threading
import time
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import deequ_tpu_torch.analyzers as an
from deequ_tpu_torch import observe
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.observe.spans import Span
from deequ_tpu_torch.ops import fused
from deequ_tpu_torch.runners import AnalysisRunner

BATCH = 2_000
N_BATCHES = 5


@pytest.fixture
def parquet_path(tmp_path):
    rng = np.random.default_rng(3)
    n = BATCH * N_BATCHES
    path = str(tmp_path / "waits.parquet")
    pq.write_table(pa.table({
        "x": rng.normal(size=n),
        "s": np.array([f"s{i % 11}" for i in range(n)], dtype=object),
        "id": np.array([f"id_{i:06d}" for i in range(n)], dtype=object),
    }), path, row_group_size=BATCH, compression="NONE")
    return path


@pytest.fixture(autouse=True)
def _pipelined(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PIPELINE", "1")
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


def _traced_scan(path, analyzers):
    return (AnalysisRunner.on_data(Table.scan_parquet(path, batch_rows=BATCH), device="cpu")
            .add_analyzers(analyzers).with_tracing(True).run())


def _spans(ctx, name):
    return [sp for sp in ctx.run_trace.spans() if sp.name == name]


def test_the_fold_records_its_waits_for_a_slow_prep(parquet_path, monkeypatch):
    sleep_s = 0.05
    prep = fused._BatchScan.prep

    def slow_prep(self, batch, precompute=False):
        time.sleep(sleep_s)
        return prep(self, batch, precompute)

    monkeypatch.setattr(fused._BatchScan, "prep", slow_prep)
    ctx = _traced_scan(parquet_path, [an.Mean("x")])
    fold = next(sp for sp in _spans(ctx, "pipe_stage") if sp.attrs["stage"] == "fold")
    waits = [sp for sp in fold.children if sp.name == "pipe_wait"]
    assert waits and all(sp.attrs["on"] == "prep" and sp.tid == fold.tid for sp in waits)
    assert sum(sp.duration_s for sp in waits) >= (N_BATCHES - 1) * sleep_s
    # the fold's items and waits close its timeline
    items = sum(sp.duration_s for sp in fold.children
                if sp.name == "pipe_item" and sp.tid == fold.tid)
    assert items + sum(sp.duration_s for sp in waits) <= fold.duration_s


def test_wait_spans_are_leaves_that_nothing_hangs_under(parquet_path):
    ctx = _traced_scan(parquet_path, [an.Mean("x"), an.Completeness("s")])
    waits = _spans(ctx, "pipe_wait")
    assert waits and all(sp.cat == "wait" and not sp.children for sp in waits)
    assert {sp.attrs["on"] for sp in waits} >= {"prep", "decode"}
    stages = {sp.attrs["stage"]: sp for sp in _spans(ctx, "pipe_stage")}
    # the decode thread starts during the prep thread's first wait for a
    # batch, and hangs under the prep stage, not under the wait
    assert stages["decode"] in stages["prep"].children
    assert stages["prep"] in stages["fold"].children
    for sp in ctx.run_trace.spans():
        if sp.name == "pipe_wait" and sp.attrs.get("on") == "decode":
            assert sp.tid == stages["prep"].tid


def test_untraced_waits_and_launches_make_nothing(monkeypatch):
    assert observe.waiting("prep") is observe.spans._NOOP
    assert observe.waiting("decode", blocked=True) is observe.spans._NOOP
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda **kw: made.append(kw) or object())
    card = SimpleNamespace(type="cuda")
    assert fused.program_timer(card) is None
    with observe.tracing():
        assert fused.program_timer(card) is None  # no span open: no dispatch to time
        with observe.span("dispatch", cat="dispatch"):
            assert fused.program_timer(torch.device("cpu")) is None
            assert made == []
            start, end = fused.program_timer(card)
    assert made == [{"enable_timing": True}] * 2


def test_an_untraced_scan_makes_no_timing_event(parquet_path, monkeypatch):
    made = []
    real = torch.cuda.Event
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **kw: made.append(kw) or real(*a, **kw))
    ctx = (AnalysisRunner.on_data(Table.scan_parquet(parquet_path, batch_rows=BATCH), device="cpu")
           .add_analyzers([an.Mean("x")]).run())
    assert ctx.run_trace is None and made == []
    traced = _traced_scan(parquet_path, [an.Mean("x")])
    # on the CPU a traced scan times nothing on a device either
    assert made == []
    assert all("device_ms" not in sp.attrs for sp in _spans(traced, "transfer"))


def test_a_string_where_records_its_build_seconds(parquet_path):
    ctx = _traced_scan(parquet_path, [an.Completeness("x", where="s = 's3'")])
    keys = {key for sp in ctx.run_trace.spans() for key in sp.attrs if key.startswith("build_s:")}
    where_keys = [key for key in keys if "s = 's3'" in key]
    assert where_keys, sorted(keys)
    builds = observe.report.build_seconds(ctx.run_trace.root)
    assert builds[where_keys[0][len("build_s:"):]] > 0
    total = sum(sp.attrs.get("build_s", 0.0) for sp in ctx.run_trace.spans())
    assert total == pytest.approx(sum(builds.values()))
    assert "input builds (top" in ctx.run_trace.report()


def test_a_spilled_grouping_records_its_spill_spans(parquet_path, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_MAX_GROUPS_IN_MEMORY", "1000")
    ctx = _traced_scan(parquet_path, [an.Uniqueness(["id"])])
    assert ctx.metric(an.Uniqueness(["id"])).value.get() == 1.0
    for name in ("spill_write", "spill_finalize", "spill_read"):
        spans = _spans(ctx, name)
        assert spans and all(sp.cat == "group" for sp in spans), name
    writes = _spans(ctx, "spill_write")
    assert sum(sp.attrs["rows"] for sp in writes) == BATCH * N_BATCHES
    assert all(sp.attrs["bytes"] > 0 for sp in writes)
    # the grouping pass's waits for decoded batches
    group_pass = _spans(ctx, "group_pass")[0]
    assert any(sp.name == "pipe_wait" and sp.attrs["on"] == "decode"
               for sp in group_pass.children)


def test_a_profiler_trace_lands_on_the_span_clock():
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with observe.tracing() as tracer:
            time.sleep(0.01)
            with observe.span("outer", cat="scan") as outer:
                time.sleep(0.02)
                with record_function("inside"):
                    time.sleep(0.005)
                time.sleep(0.02)
    doc = {"traceEvents": [dict(e) for e in _profiler_events(prof)]}
    events = observe.on_span_clock(doc)
    inside = next(e for e in events if e.get("name") == "inside")
    start_us, end_us = (outer.t0 - tracer.epoch) * 1e6, (outer.t1 - tracer.epoch) * 1e6
    assert start_us <= inside["ts"] and inside["ts"] + inside["dur"] <= end_us
    merged = observe.chrome_trace(tracer.roots, epoch=tracer.epoch, pid=0, device_trace=doc)
    span_pids = {e["pid"] for e in merged["traceEvents"] if e.get("name") == "outer"}
    device_pids = {e["pid"] for e in merged["traceEvents"] if e.get("name") == "inside"}
    assert span_pids == {0} and device_pids and not device_pids & span_pids


def _profiler_events(prof):
    import json
    import os
    import tempfile

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            return json.load(f)["traceEvents"]
    finally:
        os.unlink(path)


def test_a_trace_without_the_marker_is_refused():
    with pytest.raises(ValueError, match="deequ.trace_epoch"):
        observe.on_span_clock({"traceEvents": [{"ph": "X", "name": "k", "ts": 1.0, "dur": 1.0}]})


def _span(name, cat, t0, t1, tid, **attrs):
    sp = Span(name, cat, attrs)
    sp.t0, sp.t1, sp.tid = t0, t1, tid
    return sp


def test_phase_seconds_subtracts_only_the_same_threads_children():
    root = _span("fold", "pipeline", 0.0, 1.0, tid=1)
    root.children += [
        _span("prep", "pipeline", 0.0, 1.0, tid=2),  # another thread, beside the fold
        _span("pipe_item", "pipeline", 0.1, 0.4, tid=1),
        _span("pipe_wait", "wait", 0.4, 0.9, tid=1, on="prep"),
    ]
    phases = observe.phase_seconds([root])
    assert phases["wait"] == pytest.approx(0.5)
    # the fold's own 0.2 s plus its item's 0.3 s plus the prep thread's 1.0 s
    assert phases["pipeline"] == pytest.approx(1.5)
    assert observe.report.wait_seconds([root]) == {"prep": pytest.approx(0.5)}
    text = observe.render_report([root])
    assert "waits on: prep 0.500s" in text


def test_a_blocked_put_opens_a_wait_only_when_it_blocks():
    """A pipeline whose consumer is slow: the stage's puts that find the
    queue full are `pipe_wait` leaves on the fold, `blocked=True`."""
    from deequ_tpu_torch.ops import pipeline

    with observe.tracing() as tracer:
        with observe.span("consumer", cat="pipeline") as consumer:
            for _ in pipeline.staged(range(6), lambda x: x, name="prep", depth=1):
                time.sleep(0.01)
    blocked = [sp for sp in consumer.walk() if sp.name == "pipe_wait" and sp.attrs.get("blocked")]
    assert blocked and all(sp.attrs["on"] == "fold" for sp in blocked)
    assert all(sp.tid != threading.get_ident() for sp in blocked)
    gets = [sp for sp in consumer.children if sp.name == "pipe_wait" and not sp.attrs.get("blocked")]
    assert len(gets) == 7  # six items and the end
    assert tracer.roots == [consumer]
