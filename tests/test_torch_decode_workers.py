"""The streamed source's concurrency in the port, held against the JAX
package on the CPU.

Port-mapped from the parallel-decode cases of tests/test_decode_fastpath.py
(parallel batches equal serial ones, the worker knob), the stall knob of
tests/test_streaming_source.py, the shutdown cases of
tests/test_pipeline_shutdown.py (abandon, injected worker death) and the
workers 1-against-3 differentials of tests/test_suite_differential_fuzz.py,
over the port's three decode routes: serial, the worker pool (pyarrow)
and the C reader's read-ahead slots with its decode workers. Each knob
(`DEEQU_TPU_DECODE_WORKERS`, `DEEQU_TPU_PIPELINE_DEPTH`,
`DEEQU_TPU_SOURCE_STALL_MS`) parses as the JAX package's; under default
knobs the EXPLAIN text, the telemetry's worker count and the decode span
counts equal the JAX package's. Metrics: bit for bit within the port
across worker counts and routes; against the JAX package float sums
within 1e-12 relative, everything else exact.
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import os
import threading
import time
import types

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import test_suite_differential_fuzz as fuzz
from deequ_tpu_torch.data.source import JOIN_TIMEOUT_S, ParquetSource
from deequ_tpu_torch.observe import counters
from deequ_tpu_torch.ops import native, pipeline, runtime
from torch_stream_helpers import assert_metric_equal, bits, plain_route, port_random_check

pytestmark = pytest.mark.usefixtures("cpu_default")

KNOBS = {
    "DEEQU_TPU_DECODE_WORKERS": "decode_workers",
    "DEEQU_TPU_PIPELINE_DEPTH": "pipeline_depth",
    "DEEQU_TPU_SOURCE_STALL_MS": "source_stall_s",
}

#: the decode routes' switches (the placement is the run's)
ROUTES = {
    "pyarrow": {"DEEQU_TPU_NATIVE_READER": "0", "DEEQU_TPU_WIRE_FUSED": "0",
                "DEEQU_TPU_ENCODED_FOLD": "0", "DEEQU_TPU_PLACEMENT": "device"},
    "reader": {"DEEQU_TPU_NATIVE_READER": "1", "DEEQU_TPU_WIRE_FUSED": "0",
               "DEEQU_TPU_ENCODED_FOLD": "0", "DEEQU_TPU_PLACEMENT": "device"},
    "wire": {"DEEQU_TPU_NATIVE_READER": "0", "DEEQU_TPU_WIRE_FUSED": "1",
             "DEEQU_TPU_ENCODED_FOLD": "0", "DEEQU_TPU_PLACEMENT": "device"},
    "encfold": {"DEEQU_TPU_NATIVE_READER": "1", "DEEQU_TPU_WIRE_FUSED": "1",
                "DEEQU_TPU_ENCODED_FOLD": "1", "DEEQU_TPU_PLACEMENT": "host"},
}


def _threads(prefix: str):
    return [t for t in threading.enumerate() if t.name.startswith(prefix) and t.is_alive()]


def _wait_no_engine_threads(timeout: float = JOIN_TIMEOUT_S) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not _threads("deequ-decode") and not _threads("deequ-read-ahead"):
            return True
        time.sleep(0.02)
    return False


def _open_fd_targets():
    fd_dir = "/proc/self/fd"
    if not os.path.isdir(fd_dir):  # pragma: no cover - not Linux
        return None
    targets = []
    for fd in os.listdir(fd_dir):
        try:
            targets.append(os.readlink(os.path.join(fd_dir, fd)))
        except OSError:
            continue
    return targets


def _table_bits(table):
    return bits(table.to_pydict())


# -- the knobs ----------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "", "3", "0", "-2", "65", "x", "garbage", "-5", "2.5"])
@pytest.mark.parametrize("knob", sorted(KNOBS))
def test_knob_parses_as_the_jax_package(knob, value, monkeypatch):
    from deequ_tpu.ops import runtime as jruntime

    if value is None:
        monkeypatch.delenv(knob, raising=False)
    else:
        monkeypatch.setenv(knob, value)
    got, want = getattr(runtime, KNOBS[knob])(), getattr(jruntime, KNOBS[knob])()
    assert (type(got), got) == (type(want), want), (knob, value)


def test_defaults_equal_the_jax_package(monkeypatch):
    from deequ_tpu.ops import runtime as jruntime

    for knob in KNOBS:
        monkeypatch.delenv(knob, raising=False)
    assert runtime.DEFAULT_PIPELINE_DEPTH == jruntime.DEFAULT_PIPELINE_DEPTH == 2
    assert runtime.decode_workers() == min(os.cpu_count() or 1, 4)
    assert runtime.pipeline_depth() == 2
    assert runtime.source_stall_s() == 0.0


def _queue_sizes(module, monkeypatch):
    """The maxsize of every queue `module` makes from now on."""
    import queue

    sizes = []

    class Recording(queue.Queue):
        def __init__(self, maxsize=0):
            sizes.append(maxsize)
            super().__init__(maxsize)

    monkeypatch.setattr(module, "queue", types.SimpleNamespace(
        Queue=Recording, Full=queue.Full, Empty=queue.Empty))
    return sizes


def test_pipeline_depth_reaches_the_queue_and_the_cost_model(tmp_path, monkeypatch):
    """Under DEEQU_TPU_PIPELINE_DEPTH=4 the staged queue holds 4 prepped
    batches and EXPLAIN's stream pipeline reads depth 4, in both
    packages: the knob EXPLAIN's DQ305 tells the user to raise is the
    one the queue reads (ROADMAP fault 12)."""
    import deequ_tpu.analyzers as jan
    import deequ_tpu_torch.analyzers as an
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.lint import explain_plan as jexplain
    from deequ_tpu.ops import pipeline as jpipeline
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.lint import explain_plan

    monkeypatch.setenv("DEEQU_TPU_PIPELINE_DEPTH", "4")
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    for module in (pipeline, jpipeline):
        sizes = _queue_sizes(module, monkeypatch)
        assert list(module.staged(iter(range(6)), lambda x: 2 * x, name="t-depth")) == [
            0, 2, 4, 6, 8, 10]
        assert sizes == [4], module.__name__
    path = str(tmp_path / "d.parquet")
    pq.write_table(pa.table({"v": np.arange(4000, dtype=np.float64)}), path, row_group_size=1000)
    got = explain_plan(Table.scan_parquet(path, batch_rows=1000), [an.Mean("v")], device="cpu")
    want = jexplain(JTable.scan_parquet(path, batch_rows=1000), [jan.Mean("v")])
    assert got.cost.pipeline.queue_depth == want.cost.pipeline.queue_depth == 4
    assert "depth: 4" in got.render()


# -- parallel batches equal serial ones ---------------------------------------


def _mixed_groups_file(tmp_path):
    """Tiny row groups around large ones, with nulls and a string column."""
    rng = np.random.default_rng(9)
    parts = [17, 13, 900, 11, 7, 600, 23]
    tables = []
    for k in parts:
        v = rng.random(k)
        s = np.array(["a", "bb", "c"], dtype=object)[rng.integers(0, 3, k)]
        tables.append(pa.table({
            "v": pa.array(v, mask=rng.random(k) < 0.1),
            "i": pa.array(rng.integers(-9, 9, k)),
            "s": pa.array(s, mask=rng.random(k) < 0.2),
        }))
    path = str(tmp_path / "mixed.parquet")
    with pq.ParquetWriter(path, tables[0].schema) as w:
        for t in tables:
            w.write_table(t, row_group_size=max(parts))
    return path


@pytest.mark.parametrize("workers", [2, 3, 8])
def test_parallel_batches_equal_serial_ones(tmp_path, workers):
    from deequ_tpu.data.source import ParquetSource as JSource

    path = _mixed_groups_file(tmp_path)
    src = ParquetSource(path, batch_rows=512)
    serial = [_table_bits(b) for b in src._iter_tables_serial(512)]
    assert [_table_bits(b) for b in src._iter_tables_parallel(512, workers)] == serial
    fast = src.with_decode_fastpath(["v", "i", "s"])
    assert [_table_bits(b) for b in fast._iter_tables_parallel(512, workers)] == serial
    if native.available():
        reader = fast.with_native_reader(["v", "i"])
        metas = reader._reader_chunk_meta(frozenset({"v", "i"}))
        assert metas
        assert [_table_bits(b) for b in reader._iter_tables_native(512, workers, metas)] == serial
    jserial = [b.num_rows for b in JSource(path, batch_rows=512)._iter_tables_serial(512)]
    assert [len(b["v"]) for b in serial] == jserial


@pytest.mark.parametrize("reader", [False, True], ids=["arrow", "reader"])
def test_dictionary_crossing_row_groups_at_any_worker_count(tmp_path, monkeypatch, reader):
    """Each row group carries its own dictionary; the codes stay per batch
    consistent on every route at one worker and at three."""
    rng = np.random.default_rng(0)
    n = 2000
    path = str(tmp_path / "dict.parquet")
    pq.write_table(pa.table({
        "x": rng.normal(size=n),
        "i": pa.array(rng.integers(0, 100, n), type=pa.int16()),
        "s": pa.array([f"v{k}" if k % 7 else None for k in rng.integers(0, 50, n)]),
        "b": rng.random(n) < 0.5,
    }), path, row_group_size=100)

    def strings(workers, fastpath):
        monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", workers)
        src = ParquetSource(path, batch_rows=512)
        if fastpath:
            src = src.with_decode_fastpath(["s", "x", "i", "b"])
            if reader:
                src = src.with_native_reader(["x", "i", "b"])
        return [_table_bits(batch) for batch in src.batches(512)]

    base = strings("1", False)
    assert strings("1", True) == base
    assert strings("3", True) == base
    assert strings("3", False) == base


def test_source_stall_knob_is_inert_on_results(tmp_path, monkeypatch):
    """The stall delays the reading thread and changes nothing it yields,
    on every route; the metrics equal the JAX package's."""
    import deequ_tpu.analyzers as jan
    import deequ_tpu_torch.analyzers as an
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.runners import AnalysisRunner as JRunner
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.runners import AnalysisRunner

    rng = np.random.default_rng(3)
    n = 30_000
    path = str(tmp_path / "stalled.parquet")
    pq.write_table(pa.table({
        "x": rng.normal(0, 1, n),
        "c": np.array(["p", "q"], dtype=object)[rng.integers(0, 2, n)],
    }), path, row_group_size=10_000)

    def metrics():
        ctx = (AnalysisRunner.on_data(Table.scan_parquet(path), device="cpu")
               .add_analyzers([an.Size(), an.Mean("x")]).run())
        return bits([m.value.get() for m in ctx.metric_map.values()])

    monkeypatch.setenv("DEEQU_TPU_SOURCE_STALL_MS", "2.5")
    stalled = {}
    for route, workers in (("serial", "1"), ("pool", "3")):
        monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", workers)
        stalled[route] = metrics()
    monkeypatch.delenv("DEEQU_TPU_SOURCE_STALL_MS")
    assert stalled["serial"] == stalled["pool"] == metrics()
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    jctx = (JRunner.on_data(JTable.scan_parquet(path)).with_engine("single")
            .add_analyzers([jan.Size(), jan.Mean("x")]).run())
    pctx = (AnalysisRunner.on_data(Table.scan_parquet(path), device="cpu")
            .add_analyzers([an.Size(), an.Mean("x")]).run())
    for ja, pa_ in zip(jctx.metric_map, pctx.metric_map):
        assert_metric_equal(jctx.metric_map[ja], pctx.metric_map[pa_], repr(pa_))


def test_stall_is_paid_per_round_of_gets_on_the_read_ahead_slots(tmp_path, monkeypatch):
    """The C reader's slots pay the modelled latency once per round of
    READER_INFLIGHT_GETS GETs, several units at once; the serial route
    pays it per row group, one after another."""
    if not native.available():
        pytest.skip("the C library does not build here")
    path = str(tmp_path / "stall.parquet")
    pq.write_table(pa.table({"x": np.arange(40_000, dtype=np.float64)}), path,
                   row_group_size=10_000, compression="NONE")
    sleeps = []
    real_sleep = time.sleep
    monkeypatch.setattr("deequ_tpu_torch.data.source.time",
                        types.SimpleNamespace(sleep=lambda s: sleeps.append(s) or real_sleep(s)))
    monkeypatch.setenv("DEEQU_TPU_SOURCE_STALL_MS", "1")
    src = ParquetSource(path, batch_rows=10_000)
    list(src._iter_tables_serial(10_000))
    assert sleeps == [0.001] * 4
    sleeps.clear()
    reader = src.with_decode_fastpath(["x"]).with_native_reader(["x"])
    metas = reader._reader_chunk_meta(frozenset({"x"}))
    list(reader._iter_tables_native(10_000, 2, metas))
    assert sleeps == [0.001] * 4  # one round per unit of one group


# -- shutdown: abandon and worker death -------------------------------------


@pytest.fixture
def parquet_path(tmp_path):
    path = str(tmp_path / "shutdown.parquet")
    pq.write_table(pa.table({"x": np.arange(200_000, dtype=np.float64)}), path,
                   row_group_size=10_000, compression="NONE")
    return path


def _route_source(parquet_path, route, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", "1" if route == "serial" else "3")
    src = ParquetSource(parquet_path, batch_rows=10_000)
    if route == "fetch-pool":
        if not native.available():
            pytest.skip("the C library does not build here")
        src = src.with_decode_fastpath(["x"]).with_native_reader(["x"])
    return src


@pytest.mark.parametrize("route", ["serial", "pool", "fetch-pool"])
def test_consumer_abandon_leaves_no_thread_and_no_open_file(parquet_path, route, monkeypatch):
    """An early close joins every thread and closes every file. A
    read-ahead slot still inside its modelled GET when the close resolves
    its unit is no fault: the fault telemetry counts no fallback unit."""
    from deequ_tpu_torch import observe

    targets = _open_fd_targets()
    src = _route_source(parquet_path, route, monkeypatch)
    monkeypatch.setenv("DEEQU_TPU_SOURCE_STALL_MS", "20")  # slots mid-GET at the close
    with observe.tracing() as tracer:
        gen = src.batches(10_000)
        assert next(gen).num_rows == 10_000
        assert _threads("deequ-decode"), "the decode thread should be running"
        if route != "serial":
            assert _threads("deequ-decode-worker")
        if route == "fetch-pool":
            assert _threads("deequ-read-ahead")
        gen.close()  # 19 batches unread
    assert _wait_no_engine_threads(), [t.name for t in threading.enumerate()]
    assert tracer.counters.get("fault.fallback_units", 0) == 0
    assert tracer.counters.get("fault.observed", 0) == 0
    if targets is not None:
        assert parquet_path not in _open_fd_targets(), "a file stayed open after the abandon"


@pytest.mark.parametrize("route", ["pool", "fetch-pool"])
def test_injected_worker_death_contained_and_leak_free(parquet_path, route, monkeypatch):
    """A decode worker killed mid-unit decodes its unit again inline: the
    same batches, every thread joined, no file left open."""
    from deequ_tpu_torch.testing import faults

    clean = [_table_bits(t) for t in _route_source(parquet_path, route, monkeypatch).batches(10_000)]
    monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", "2")
    with faults.install("seed=7,decode.worker:1.0:1") as plan:
        got = [_table_bits(t) for t in _route_source(parquet_path, route, monkeypatch).batches(10_000)]
    assert plan.injected.get("decode.worker", 0) == 1, "the fault never fired"
    assert got == clean
    assert _wait_no_engine_threads()
    targets = _open_fd_targets()
    if targets is not None:
        assert parquet_path not in targets, "a file stayed open past the fault"


def test_a_second_worker_death_propagates(parquet_path, monkeypatch):
    from deequ_tpu_torch.testing import faults

    monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", "2")
    with faults.install("seed=7,decode.worker:1.0"):
        with pytest.raises(faults.InjectedFaultError):
            list(ParquetSource(parquet_path, batch_rows=10_000).batches(10_000))
    assert _wait_no_engine_threads()


# -- workers 1 against 3 over the fuzz layouts, on each route ----------------


def _draw(layout: str, seed: int, port: bool):
    """The fuzz draw of a layout: its table and checks (JAX or port)."""
    rng = np.random.default_rng(14_000 + seed)
    table = fuzz.LAYOUTS[layout](rng)
    roles = fuzz.layout_roles(layout, rng)
    make = port_random_check(fuzz) if port else fuzz.random_check
    checks = [make(rng, roles) for _ in range(int(rng.integers(1, 3)))]
    return table, checks


def _suite_result(path, rows, checks, tracing=False):
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.verification.suite import VerificationSuite

    builder = VerificationSuite.on_data(Table.scan_parquet(path, batch_rows=max(64, rows // 5)),
                                        device="cpu")
    for check in checks:
        builder = builder.add_check(check)
    return builder.with_engine("single").with_tracing(tracing).run()


@pytest.mark.parametrize("route", sorted(ROUTES))
@pytest.mark.parametrize("layout", ["narrow", "wide", "lineitem"])
def test_workers_one_against_three_on_each_route(layout, route, tmp_path, monkeypatch):
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.verification import VerificationSuite as JSuite
    from deequ_tpu_torch import observe

    if route in ("reader", "encfold") and not native.available():
        pytest.skip("the C library does not build here")
    table, jchecks = _draw(layout, 1, port=False)
    _, pchecks = _draw(layout, 1, port=True)
    rows = table.num_rows
    path = str(tmp_path / "w.parquet")
    table.to_parquet(path, row_group_size=max(64, rows // 7), dictionary_encode_strings=True)
    pq.write_table(pq.read_table(path), path, compression="NONE",
                   row_group_size=max(64, rows // 7), data_page_size=4096)
    for key, value in ROUTES[route].items():
        monkeypatch.setenv(key, value)

    monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", "1")
    one = bits(fuzz.suite_snapshot(_suite_result(path, rows, pchecks)))
    monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", "3")
    traced = _suite_result(path, rows, pchecks, tracing=True)
    assert bits(fuzz.suite_snapshot(traced)) == one, (layout, route)
    counts = observe.span_name_counts(traced.run_trace, ["decode_unit", "page_read", "page_decode"])
    if route in ("reader", "encfold"):
        assert counts.get("page_decode", 0) > 0 and counts["page_decode"] == counts["page_read"]
    else:
        assert counts.get("decode_unit", 0) > 0, "the worker pool never engaged"

    with monkeypatch.context() as jm:
        if route == "encfold":
            # the JAX host fold shares the port's C routes (its library on)
            jm.setenv("DEEQU_TPU_PLACEMENT", "host")
        else:
            plain_route(jm)
        jm.setenv("DEEQU_TPU_DECODE_WORKERS", "3")
        jbuilder = JSuite().on_data(JTable.scan_parquet(path, batch_rows=max(64, rows // 5)))
        for check in jchecks:
            jbuilder = jbuilder.add_check(check)
        jresult = jbuilder.with_engine("single").run()
    assert traced.status.name == jresult.status.name
    jmetrics = {repr(a): m for a, m in jresult.metrics.items()}
    pmetrics = {repr(a): m for a, m in traced.metrics.items()}
    assert pmetrics.keys() == jmetrics.keys()
    for key, jm_ in jmetrics.items():
        assert_metric_equal(jm_, pmetrics[key], key)


# -- default knobs: the same plan, telemetry and spans as the JAX package ----


def test_default_knobs_explain_telemetry_and_spans_equal_jax(tmp_path, monkeypatch):
    import deequ_tpu.analyzers as jan
    import deequ_tpu_torch.analyzers as an
    from deequ_tpu import observe as jobserve
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.lint import explain_plan as jexplain
    from deequ_tpu.observe.telemetry import engine_metric_record as jrecord
    from deequ_tpu.runners import AnalysisRunner as JRunner
    from deequ_tpu_torch import observe
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.lint import explain_plan
    from deequ_tpu_torch.observe.telemetry import engine_metric_record
    from deequ_tpu_torch.runners import AnalysisRunner
    from test_torch_lint_differential import _static_lines

    for knob in (*KNOBS, "DEEQU_TPU_NATIVE_READER", "DEEQU_TPU_DECODE_FASTPATH",
                 "DEEQU_TPU_WIRE_FUSED", "DEEQU_TPU_ENCODED_FOLD", "DEEQU_TPU_PIPELINE"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    rng = np.random.default_rng(12)
    n = 12_000
    path = str(tmp_path / "default.parquet")
    pq.write_table(pa.table({
        "v": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.05),
        "q": rng.integers(1, 50, n),
        "s": np.array([f"s{i % 7}" for i in range(n)], dtype=object),
    }), path, row_group_size=2000, compression="NONE")

    def suite(mod):
        return [mod.Size(), mod.Completeness("s"), mod.Mean("v"), mod.Maximum("q"),
                mod.ApproxCountDistinct("q")]

    got = explain_plan(Table.scan_parquet(path, batch_rows=4000), suite(an), device="cpu")
    want = jexplain(JTable.scan_parquet(path, batch_rows=4000), suite(jan))
    assert _static_lines(got.render()) == _static_lines(want.render())
    workers = runtime.decode_workers()
    decode_lines = [line.strip() for line in got.render().splitlines()
                    if line.strip().startswith(("decode:", "reader:"))]
    assert len(decode_lines) == 2
    assert all(f"{workers} worker(s)" in line for line in decode_lines)

    pctx = (AnalysisRunner.on_data(Table.scan_parquet(path, batch_rows=4000), device="cpu")
            .add_analyzers(suite(an)).with_tracing(True).run())
    jctx = (JRunner.on_data(JTable.scan_parquet(path, batch_rows=4000)).with_engine("single")
            .add_analyzers(suite(jan)).with_tracing(True).run())
    names = ["decode_unit", "page_read", "page_decode"]
    pspans = observe.span_name_counts(pctx.run_trace, names)
    assert pspans == jobserve.span_name_counts(jctx.run_trace, names)
    assert sum(pspans.values()) > 0
    prec, jrec = engine_metric_record(pctx.run_trace), jrecord(jctx.run_trace)
    assert prec["engine.decode_workers"] == jrec["engine.decode_workers"] == float(workers)
    for ja, pa_ in zip(jctx.metric_map, pctx.metric_map):
        assert_metric_equal(jctx.metric_map[ja], pctx.metric_map[pa_], repr(pa_))


def test_a_traced_reader_scan_reports_the_read_stage(tmp_path, monkeypatch):
    """The run report folds the read-ahead slots' `page_read` spans and
    the decode's `readahead_hit` into a synthetic "read" stage, as the
    JAX package's report does over its own run."""
    import deequ_tpu_torch.analyzers as an
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.observe.report import pipeline_occupancy
    from deequ_tpu_torch.runners import AnalysisRunner

    if not native.available():
        pytest.skip("the C library does not build here")
    monkeypatch.setenv("DEEQU_TPU_PIPELINE", "1")
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    path = str(tmp_path / "read.parquet")
    pq.write_table(pa.table({"x": np.arange(40_000, dtype=np.float64)}), path,
                   row_group_size=10_000, compression="NONE")
    ctx = (AnalysisRunner.on_data(Table.scan_parquet(path, batch_rows=10_000), device="cpu")
           .add_analyzers([an.Mean("x")]).with_tracing(True).run())
    rows = {row["stage"]: row for row in pipeline_occupancy(ctx.run_trace.root)}
    assert "read" in rows, sorted(rows)
    read = rows["read"]
    assert read["items"] == 4
    assert read["readahead_hits"] + read["readahead_misses"] == 4
    assert "readahead" in ctx.run_trace.report()

    import deequ_tpu.analyzers as jan
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.observe.report import pipeline_occupancy as jpipeline_occupancy
    from deequ_tpu.runners import AnalysisRunner as JRunner

    jctx = (JRunner.on_data(JTable.scan_parquet(path, batch_rows=10_000)).with_engine("single")
            .add_analyzers([jan.Mean("x")]).with_tracing(True).run())
    jread = {row["stage"]: row for row in jpipeline_occupancy(jctx.run_trace.root)}["read"]
    assert sorted(jread) == sorted(read)
    assert jread["items"] == read["items"]
    assert jread["readahead_hits"] + jread["readahead_misses"] == 4


def test_a_failed_read_ahead_slot_reads_its_unit_through_pyarrow(parquet_path, monkeypatch):
    """A read-ahead slot that fails outside the retried pread is
    contained: its unit reads through pyarrow, the batches do not move,
    and the fault telemetry counts one fallback unit."""
    from deequ_tpu_torch import observe

    src = _route_source(parquet_path, "fetch-pool", monkeypatch)
    clean = [_table_bits(t) for t in src.batches(10_000)]
    real = ParquetSource._fetch_unit
    calls = []

    def failing(self, *args):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("a slot fails")
        return real(self, *args)

    monkeypatch.setattr(ParquetSource, "_fetch_unit", failing)
    with observe.tracing() as tracer:
        got = [_table_bits(t) for t in src.batches(10_000)]
    assert got == clean
    assert tracer.counters.get("fault.fallback_units", 0) == 1
    assert _wait_no_engine_threads()


def test_decode_workers_count_into_one_monitored_block_without_losing_an_update():
    """Decode workers record their units' encoded-fold counts into the
    scan thread's `monitored()` block at once; the counts stay exact
    under contention (more threads than cores, a short switch interval)."""
    import sys

    from deequ_tpu_torch.data.source import _WorkerContext

    threads_n, calls = 4 * (os.cpu_count() or 1), 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with runtime.monitored() as stats:
            context = _WorkerContext()

            def work():
                with context():
                    for _ in range(calls):
                        counters.record_encfold(1, 1, 1, 1, 1, 1)

            threads = [threading.Thread(target=work) for _ in range(threads_n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    want = threads_n * calls
    assert (stats.encfold_chunks, stats.encfold_runs, stats.encfold_bytes_saved) == (want, want, want)
