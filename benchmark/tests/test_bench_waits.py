"""The readers of the port's waits, input builds, spill and per-batch program
times (`benchmark/waits.py` and its six metrics) over synthetic run
records, and on the card the fused program's `device_ms` on every batch."""

from __future__ import annotations

import threading

import pytest

from benchmark import core
from benchmark.core import Iteration, RunRecord
from benchmark.trace import DeviceRecord

NEW_METRICS = ("pipeline.wait_s.scan", "source.wait_s.scan", "pipeline.build_s.scan",
               "fused.program_span_s.scan", "grouping.spill_s.scan", "device.idle_wait_share.scan")


class FakeSpan:
    def __init__(self, name, t0, t1, tid=0, children=(), **attrs):
        self.name, self.t0, self.t1, self.tid = name, t0, t1, tid
        self.cat = None
        self.children = list(children)
        self.attrs = attrs


def _read(name, run):
    return core.load_module("metrics", name).read(run)


def _request(start, tid, spilled=True):
    """One request on thread `tid`: the fold waits 0.3 s for prep, the prep
    thread 0.2 s for decode and 0.1 s on a full queue; builds of 0.25 s
    and 0.15 s; two batches of 4 ms and 6 ms on the device; 0.5 s of spill,
    or a group pass that did not spill."""
    s = start
    prep = FakeSpan("pipe_stage", s, s + 2, tid=tid + 1, stage="prep", children=[
        FakeSpan("pipe_wait", s + 0.1, s + 0.3, tid=tid + 1, on="decode"),
        FakeSpan("pipe_item", s + 0.3, s + 0.8, tid=tid + 1, build_s=0.25, **{"build_s:x": 0.25}),
        FakeSpan("pipe_wait", s + 0.8, s + 0.9, tid=tid + 1, on="fold", blocked=True),
    ])
    fold = FakeSpan("pipe_stage", s, s + 2, tid=tid, stage="fold", children=[
        prep,
        FakeSpan("pipe_wait", s, s + 0.3, tid=tid, on="prep"),
        FakeSpan("pipe_item", s + 0.3, s + 1.0, tid=tid, build_s=0.15, **{"build_s:y": 0.15}),
    ])
    root = FakeSpan("analysis_run", s, s + 3, tid=tid, children=[
        fold,
        FakeSpan("transfer", s + 1.0, s + 1.1, tid=tid, device_ms=4.0),
        FakeSpan("transfer", s + 1.1, s + 1.2, tid=tid, device_ms=6.0),
        FakeSpan("grouping", s + 2, s + 3, tid=tid, children=[
            FakeSpan("group_pass", s + 2.0, s + 2.4, tid=tid, spilled=True),
            FakeSpan("spill_write", s + 2.0, s + 2.2, tid=tid, rows=10, bytes=100),
            FakeSpan("spill_finalize", s + 2.2, s + 2.4, tid=tid),
            FakeSpan("spill_read", s + 2.4, s + 2.5, tid=tid, rows=10),
        ] if spilled else [
            FakeSpan("group_pass", s + 2.0, s + 2.4, tid=tid, spilled=False),
        ]),
    ])
    return Iteration(start, start + 3, 100, 3.0, True, roots=[root])


def _run(tid=None, device=None):
    tid = threading.get_ident() if tid is None else tid
    its = [_request(0.0, tid), _request(10.0, tid)]
    return RunRecord(1.0, its, (0.0, 13.0), 0, True, device)


def test_span_readers_give_per_request_seconds():
    run = _run()
    assert _read("pipeline.wait_s.scan", run) == pytest.approx(0.3)
    assert _read("source.wait_s.scan", run) == pytest.approx(0.2)
    assert _read("pipeline.build_s.scan", run) == pytest.approx(0.4)
    assert _read("fused.program_span_s.scan", run) == pytest.approx(0.010)
    assert _read("grouping.spill_s.scan", run) == pytest.approx(0.5)


def test_an_unspilled_group_pass_reads_no_spill_time():
    """Group passes that say they did not spill read 0 s of spill, not
    nothing; a run whose requests spilled in one of two reads half."""
    unspilled = [_request(0.0, 1, spilled=False), _request(10.0, 1, spilled=False)]
    assert _read("grouping.spill_s.scan", RunRecord(1.0, unspilled, (0.0, 13.0), 0, True)) == 0.0
    mixed = [_request(0.0, 1), _request(10.0, 1, spilled=False)]
    assert _read("grouping.spill_s.scan", RunRecord(1.0, mixed, (0.0, 13.0), 0, True)) \
        == pytest.approx(0.25)


def test_readers_find_nothing_in_an_older_programs_spans():
    """A program with no wait, build, spill or device-time records (the
    one before them) gives None from every new reader, never 0."""
    bare = [Iteration(0.0, 1.0, 100, 1.0, True,
                      roots=[FakeSpan("analysis_run", 0.0, 1.0, children=[
                          FakeSpan("pipe_stage", 0.0, 1.0, stage="fold"),
                          FakeSpan("transfer", 0.5, 0.6, bytes=8),
                          FakeSpan("group_pass", 0.6, 0.9, columns="k")])])]
    device = DeviceRecord([(0.1, 0.2, "k")], (0.0, 1.0))
    run = RunRecord(1.0, bare, (0.0, 1.0), 0, True, device)
    for name in NEW_METRICS:
        assert _read(name, run) is None, name
    untraced = RunRecord(1.0, _run().iterations, (0.0, 13.0), 0, False)
    for name in NEW_METRICS:
        assert _read(name, untraced) is None, name


def test_idle_wait_share_counts_each_gap_over_its_whole_length():
    # busy 0.0-0.1 and 0.35-1.0 in the first request's window: idle
    # 0.1-0.35 (0.25 s, under the fold's wait until 0.3) and after 1.0
    device = DeviceRecord([(0.0, 0.1, "a"), (0.35, 1.0, "b"), (10.0, 13.0, "c")], (0.0, 13.0))
    run = _run(device=device)
    idle = 0.25 + 9.0  # 0.1-0.35 and 1.0-10.0
    waited = 0.2  # 0.1-0.3; the second request's wait lies under busy device time
    assert _read("device.idle_wait_share.scan", run) == pytest.approx(100.0 * waited / idle)
    # the waits of another thread (the prep thread's) are not the requester's
    other = _run(tid=threading.get_ident() + 7, device=device)
    assert _read("device.idle_wait_share.scan", other) is None


@pytest.mark.card
def test_every_batch_of_a_traced_device_scan_has_its_device_time(tmp_path):
    """On the card, a traced streamed scan times the fused program of
    every batch: `device_ms` present and positive on every `transfer`."""
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the program's timing events are CUDA events")
    from deequ_tpu_torch import AnalysisRunner, Table
    from deequ_tpu_torch.analyzers import ApproxCountDistinct, Mean, StandardDeviation

    rng = np.random.default_rng(5)
    n = 1 << 20
    path = str(tmp_path / "device.parquet")
    pq.write_table(pa.table({"x": rng.normal(size=n), "k": rng.integers(0, 1000, n)}), path,
                   row_group_size=1 << 18, compression="ZSTD")
    ctx = (AnalysisRunner.on_data(Table.scan_parquet(path, batch_rows=1 << 18), device="cuda")
           .add_analyzers([Mean("x"), StandardDeviation("x"), ApproxCountDistinct("k")])
           .with_tracing(True).run())
    transfers = [sp for sp in ctx.run_trace.spans() if sp.name == "transfer"]
    assert len(transfers) == 4
    assert all(sp.attrs.get("device_ms", 0.0) > 0.0 for sp in transfers), \
        [sp.attrs for sp in transfers]
