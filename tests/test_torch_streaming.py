"""Streamed Parquet through the port: `Table.scan_parquet` and
`scan_parquet_dataset` on device="cpu" against the JAX package's on its
plain pyarrow route (torch_stream_helpers.PLAIN_ROUTE_ENV, its C host
library off), and against the port's own in-memory runs.

Tolerances: counts, minima, maxima, HLL estimates, quantiles, histograms
and check statuses equal; float sums (Mean, Sum, StandardDeviation,
Correlation, Entropy, MutualInformation) within 1e-12 relative, since
torch and XLA add in other orders. Against the in-memory run, whose
single batch is split otherwise, sums agree within 1e-9 and sketches
within their error. Within the port, runs with the pipeline on or off
give the same bits. Port-mapped from
tests/test_streaming_source.py, tests/test_pipeline_shutdown.py and
tests/test_suite_differential_fuzz.py."""

from __future__ import annotations

import collections
import os
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu_torch.analyzers as P
import test_suite_differential_fuzz as fuzz
from deequ_tpu.checks import Check as JCheck
from deequ_tpu.checks import CheckLevel as JLevel
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.profiles import ColumnProfilerRunner as JProfiler
from deequ_tpu.runners.analysis_runner import AnalysisRunner as JRunner
from deequ_tpu.verification import VerificationSuite as JSuite
from deequ_tpu_torch import ColumnProfilerRunner as PProfiler
from deequ_tpu_torch.checks.check import Check as PCheck
from deequ_tpu_torch.checks.check import CheckLevel as PLevel
from deequ_tpu_torch.core.controller import RunCancelled, RunController
from deequ_tpu_torch.core.exceptions import NoSuchColumnException, WrongColumnTypeException
from deequ_tpu_torch.data import source as psource
from deequ_tpu_torch.data.table import Column, ColumnType
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.ops import fused as pfused
from deequ_tpu_torch.ops import pipeline, runtime
from deequ_tpu_torch.profiles import column_profiler
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner as PRunner
from deequ_tpu_torch.verification.suite import VerificationSuite as PSuite
from torch_stream_helpers import (
    assert_contexts_equal,
    assert_metric_equal,
    bits,
    plain_route,
    port_random_check,
    port_table,
    write_parquet,
)

N = 6000
GROUP = 1000
BATCH = 2048


@pytest.fixture(autouse=True)
def _plain_route(monkeypatch):
    plain_route(monkeypatch)


@pytest.fixture(scope="module")
def parquet_path(tmp_path_factory):
    rng = np.random.default_rng(7)
    x = rng.normal(5.0, 2.0, N)
    x[rng.random(N) < 0.05] = np.nan
    cats = np.array(["red", "green", "blue", None], dtype=object)
    columns = {
        "x": x,
        "qty": rng.integers(0, 50, N),
        "cat": cats[rng.integers(0, 4, N)],
        "code": [str(v) for v in rng.integers(0, 500, N)],
    }
    return write_parquet(tmp_path_factory.mktemp("pq"), "data.parquet", columns, GROUP)


def analyzers(m):
    return [
        m.Size(),
        m.Completeness("x"),
        m.Mean("x"),
        m.Maximum("x"),
        m.Minimum("qty"),
        m.Sum("qty"),
        m.StandardDeviation("x"),
        m.Correlation("x", "qty"),
        m.ApproxCountDistinct("qty"),
        m.ApproxCountDistinct("cat"),
        m.ApproxQuantile("x", 0.5),
        m.ApproxQuantiles("qty", [0.1, 0.5, 0.9]),
        m.DataType("code"),
        m.PatternMatch("cat", r"^re"),
        m.Compliance("big", "x > 6"),
        m.Mean("code"),
        m.Uniqueness(["cat"]),
        m.Distinctness(["cat"]),
        m.UniqueValueRatio(["code"]),
        m.Entropy("cat"),
        m.CountDistinct(["cat", "qty"]),
        m.MutualInformation("cat", "qty"),
        m.Histogram("cat"),
        m.Histogram("code", max_detail_bins=20),
    ]


def run_both(jdata, pdata, jan=None, pan=None):
    jan = jan or analyzers(J)
    pan = pan or analyzers(P)
    jctx = JRunner.on_data(jdata).with_engine("single").add_analyzers(jan).run()
    pctx = PRunner.on_data(pdata, device="cpu").add_analyzers(pan).run()
    return jctx, pctx, jan, pan


class TestStreamingParity:
    def test_all_analyzers_equal_jax(self, parquet_path):
        assert_contexts_equal(
            *run_both(
                JTable.scan_parquet(parquet_path, batch_rows=BATCH),
                PTable.scan_parquet(parquet_path, batch_rows=BATCH),
            )
        )

    def test_all_analyzers_match_in_memory(self, parquet_path):
        pan = analyzers(P)
        streamed = PRunner.on_data(PTable.scan_parquet(parquet_path, batch_rows=BATCH), device="cpu")
        memory = PRunner.on_data(PTable.from_parquet(parquet_path), device="cpu")
        cs = streamed.add_analyzers(pan).run()
        cm = memory.add_analyzers(pan).run()
        for a in pan:
            ms, mm = cs.metric_map[a], cm.metric_map[a]
            assert ms.value.is_success == mm.value.is_success, (a, ms.value, mm.value)
            if not mm.value.is_success:
                assert str(ms.value.exception) == str(mm.value.exception)
                continue
            vs, vm = ms.value.get(), mm.value.get()
            if repr(a).startswith("ApproxQuantile"):
                # the sketch's compactions depend on the batching
                assert vs == pytest.approx(vm, abs=1.0), a
            elif isinstance(vs, float):
                assert vs == pytest.approx(vm, rel=1e-9), a
            else:
                assert (vs.values if hasattr(vs, "values") else vs) == (
                    vm.values if hasattr(vm, "values") else vm
                ), a

    def test_profiler_equals_jax_and_in_memory(self, parquet_path):
        from test_torch_profiler import assert_same_profiles

        source = PTable.scan_parquet(parquet_path, batch_rows=BATCH)
        pp = PProfiler.on_data(source, device="cpu").run()
        jp = JProfiler.on_data(JTable.scan_parquet(parquet_path, batch_rows=BATCH)).with_engine(
            "single"
        ).run()
        assert_same_profiles(jp, pp)
        pm = PProfiler.on_data(PTable.from_parquet(parquet_path), device="cpu").run()
        assert pp.num_records == pm.num_records == N
        for name in ("x", "qty", "cat", "code"):
            s, m = pp.profiles[name], pm.profiles[name]
            assert s.data_type == m.data_type, name
            assert s.completeness == m.completeness, name
            assert s.approximate_num_distinct_values == m.approximate_num_distinct_values
            if getattr(s, "mean", None) is not None:
                assert s.mean == pytest.approx(m.mean, rel=1e-9)
        hs, hm = pp.profiles["cat"].histogram, pm.profiles["cat"].histogram
        assert {k: v.absolute for k, v in hs.values.items()} == {
            k: v.absolute for k, v in hm.values.items()
        }

    def test_verification_suite_on_source(self, parquet_path):
        def check(m, level):
            return (
                m(level.ERROR, "stream checks")
                .has_size(lambda s: s == N)
                .has_completeness("x", lambda v: 0.9 < v < 1.0)
                .has_entropy("cat", lambda v: v > 0.5)
                .is_unique("code")
                .has_mean("qty", lambda v: v > 100)
            )

        jc, pc = check(JCheck, JLevel), check(PCheck, PLevel)
        jr = JSuite.on_data(JTable.scan_parquet(parquet_path, batch_rows=BATCH)).add_check(jc)
        jr = jr.with_engine("single").run()
        pr = (
            PSuite.on_data(PTable.scan_parquet(parquet_path, batch_rows=BATCH), device="cpu")
            .add_check(pc)
            .run()
        )
        assert pr.status.name == jr.status.name == "ERROR"
        assert [(str(c.constraint), c.status.name, c.message) for c in pr.check_results[pc].constraint_results] == [
            (str(c.constraint), c.status.name, c.message) for c in jr.check_results[jc].constraint_results
        ]

    def test_source_schema_and_preconditions(self, parquet_path):
        source = PTable.scan_parquet(parquet_path)
        assert source.num_rows == N
        assert source.schema == [
            ("x", ColumnType.DOUBLE), ("qty", ColumnType.LONG),
            ("cat", ColumnType.STRING), ("code", ColumnType.STRING),
        ]
        with pytest.raises(NoSuchColumnException):
            source.column("nope")
        ctx = PRunner.on_data(source, device="cpu").add_analyzers([P.Minimum("cat")]).run()
        assert isinstance(ctx.metric_map[P.Minimum("cat")].value.exception, WrongColumnTypeException)

    def test_empty_parquet(self, tmp_path):
        path = str(tmp_path / "empty.parquet")
        pq.write_table(pa.table({"a": pa.array([], type=pa.float64())}), path)
        jan, pan = [J.Size(), J.Mean("a"), J.Histogram("a")], [P.Size(), P.Mean("a"), P.Histogram("a")]
        jctx, pctx, _, _ = run_both(JTable.scan_parquet(path), PTable.scan_parquet(path), jan, pan)
        assert pctx.metric_map[P.Size()].value.get() == 0.0
        assert pctx.metric_map[P.Mean("a")].value.is_failure  # empty state
        assert_contexts_equal(jctx, pctx, jan, pan)

    def test_bounded_prefetch(self, parquet_path):
        """Decode runs at most (queue 2) + 1 batches ahead of the consumer."""

        class Counting(psource.ParquetSource):
            decoded = 0

            def _iter_tables(self, batch_size):
                for t in super()._iter_tables(batch_size):
                    self.decoded += 1
                    yield t

        source = Counting(parquet_path, batch_rows=500)  # 12 batches
        gen = source.batches(500)
        next(gen)
        time.sleep(0.3)  # every chance to run ahead
        assert source.decoded <= 4
        assert 1 + sum(1 for _ in gen) == 12
        assert source.decoded == 12

    def test_column_projection_and_pruning(self, parquet_path, monkeypatch):
        source = PTable.scan_parquet(parquet_path, columns=["x", "cat"])
        assert source.column_names == ["x", "cat"]
        seen = []
        original = psource.ParquetSource.with_columns

        def spy(self, names):
            seen.append(sorted(names))
            return original(self, names)

        monkeypatch.setattr(psource.ParquetSource, "with_columns", spy)
        ctx = PRunner.on_data(source, device="cpu").add_analyzers([P.Completeness("cat")]).run()
        assert ctx.metric_map[P.Completeness("cat")].value.get() == pytest.approx(0.75, abs=0.05)
        assert seen == [["cat"]]  # the pass decodes only what it reads
        assert pfused.prune_table_columns(source, {}).column_names == ["x"]

    def test_mapped_source_undeclared_fn_is_not_pruned(self, parquet_path):
        def scale_x_by_qty(batch):
            x, qty = batch.column("x"), batch.column("qty")  # qty is not analyzed
            return batch.with_column(
                Column("x", ColumnType.DOUBLE, x.values * qty.values.astype(np.float64),
                       x.valid & qty.valid)
            )

        def mean(data):
            ctx = PRunner.on_data(data, device="cpu").add_analyzers([P.Mean("x")]).run()
            return ctx.metric_map[P.Mean("x")].value.get()

        expected = mean(psource.MappedSource(PTable.scan_parquet(parquet_path), scale_x_by_qty))
        undeclared = psource.MappedSource(PTable.scan_parquet(parquet_path), scale_x_by_qty)
        assert undeclared.with_columns(["x"]) is undeclared
        assert mean(undeclared.with_columns(["x"])) == expected
        declared = psource.MappedSource(
            PTable.scan_parquet(parquet_path), scale_x_by_qty, fn_columns=["x", "qty"]
        )
        assert mean(declared.with_columns(["x"])) == expected
        assert declared.with_columns(["x"]).base.column_names == ["x", "qty"]

    def test_timestamp_and_decimal_parity(self, tmp_path):
        import decimal

        rng = np.random.default_rng(5)
        n = 3000
        stamps = (rng.integers(1_500_000_000, 1_700_000_000, n) * 1_000_000).astype("datetime64[us]")
        ts = pa.array([None if i % 17 == 0 else v for i, v in enumerate(stamps)])
        dec = pa.array(
            [
                None if i % 13 == 0
                else decimal.Decimal(f"{rng.integers(0, 10000)}.{rng.integers(0, 100):02d}")
                for i in range(n)
            ],
            type=pa.decimal128(12, 2),
        )
        path = str(tmp_path / "tsdec.parquet")
        pq.write_table(pa.table({"ts": ts, "dec": dec}), path, row_group_size=700)

        def make(m):
            return [m.Completeness("ts"), m.Completeness("dec"), m.Mean("dec"), m.Minimum("dec"),
                    m.Maximum("dec"), m.Minimum("ts"), m.ApproxCountDistinct("ts")]

        jan, pan = make(J), make(P)
        assert_contexts_equal(
            *run_both(JTable.scan_parquet(path, batch_rows=BATCH), PTable.scan_parquet(path, batch_rows=BATCH), jan, pan)
        )
        memory = PRunner.on_data(PTable.from_parquet(path), device="cpu").add_analyzers(pan).run()
        streamed = PRunner.on_data(PTable.scan_parquet(path), device="cpu").add_analyzers(pan).run()
        for a in pan:
            assert_metric_equal(memory.metric_map[a], streamed.metric_map[a], repr(a), rtol=1e-12)
        assert memory.metric_map[pan[0]].value.get() == sum(1 for i in range(n) if i % 17) / n
        assert isinstance(memory.metric_map[pan[5]].value.exception, WrongColumnTypeException)

    def test_tiny_row_groups_coalesce(self, tmp_path):
        """Tiny row groups coalesce into batch-sized chunks, in the JAX
        package's batch boundaries."""
        rng = np.random.default_rng(1)
        n = 20_000
        labels = np.array(["p", "q", "r"], dtype=object)[rng.integers(0, 3, n)]
        path = write_parquet(tmp_path, "tiny.parquet", {"x": rng.normal(0, 1, n), "c": labels}, 200)
        source = PTable.scan_parquet(path, batch_rows=8192)
        rows = [b.num_rows for b in source.batches(8192)]
        jrows = [b.num_rows for b in JTable.scan_parquet(path, batch_rows=8192).batches(8192)]
        assert rows == jrows and sum(rows) == n and len(rows) < 10
        pan = [P.Size(), P.Mean("x"), P.Histogram("c")]
        ctx = PRunner.on_data(source, device="cpu").add_analyzers(pan).run()
        assert ctx.metric_map[pan[0]].value.get() == n
        hist = {k: v.absolute for k, v in ctx.metric_map[pan[2]].value.get().values.items()}
        assert hist == dict(collections.Counter(labels.tolist()))


# -- partitioned datasets -------------------------------------------------------


@pytest.fixture(scope="module")
def dataset_dir(tmp_path_factory):
    """Three partitions, written out of name order."""
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("dataset")
    cats = np.array(["a", "b", "c", None], dtype=object)
    for name, n in (("part-2.parquet", 1500), ("part-0.parquet", 2500), ("part-1.parquet", 900)):
        x = rng.normal(1.0, 3.0, n)
        x[rng.random(n) < 0.1] = np.nan
        write_parquet(root, name, {"x": x, "k": rng.integers(0, 300, n), "c": cats[rng.integers(0, 4, n)]}, 400)
    return str(root)


def dataset_analyzers(m):
    return [m.Size(), m.Mean("x"), m.StandardDeviation("x"), m.Maximum("k"),
            m.ApproxCountDistinct("k"), m.ApproxQuantile("x", 0.25), m.Completeness("c"),
            m.Uniqueness(["k"]), m.Entropy("c"), m.Histogram("c")]


def test_scan_parquet_dataset_equals_jax(dataset_dir):
    source = PTable.scan_parquet_dataset(dataset_dir, batch_rows=1024)
    assert [p.name for p in source.partitions()] == ["part-0.parquet", "part-1.parquet", "part-2.parquet"]
    assert source.num_rows == 4900
    jan, pan = dataset_analyzers(J), dataset_analyzers(P)
    assert_contexts_equal(
        *run_both(JTable.scan_parquet_dataset(dataset_dir, batch_rows=1024), source, jan, pan)
    )


def test_scan_parquet_dataset_folds_each_partition(dataset_dir):
    """Each partition folds on its own, and the states merge in name order."""
    pan = dataset_analyzers(P)
    shareable = [a for a in pan if isinstance(a, P.ScanShareableAnalyzer)]
    source = PTable.scan_parquet_dataset(dataset_dir, batch_rows=1024)
    with runtime.monitored() as stats:
        results = pfused.FusedScanPass(shareable, device="cpu").run(source)
    assert stats.device_passes == 3
    parts = [pfused.FusedScanPass(shareable, device="cpu").run(p.source()) for p in source.partitions()]
    for i, result in enumerate(results):
        merged = parts[0][i]
        for part in parts[1:]:
            merged = pfused._merge_partition_results(merged, part[i])
        analyzer = result.analyzer
        got = analyzer.compute_metric_from(result.state).value.get()
        assert bits(got) == bits(analyzer.compute_metric_from(merged.state).value.get())


# -- pipeline on/off: the same bits ---------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_on_and_off_bit_identical(seed, tmp_path, monkeypatch):
    rng = np.random.default_rng(500 + seed)
    table = fuzz.random_table(rng)
    check = port_random_check(fuzz)(rng)
    n = len(table.column("x"))
    path = str(tmp_path / "fuzz.parquet")
    table.to_parquet(path, row_group_size=max(64, n // 7), dictionary_encode_strings=True)

    def run(pipeline_env):
        monkeypatch.setenv("DEEQU_TPU_PIPELINE", pipeline_env)
        data = PTable.scan_parquet(path, batch_rows=max(64, n // 5))
        result = PSuite.on_data(data, device="cpu").add_check(check).run()
        profile = PProfiler.on_data(PTable.scan_parquet(path, batch_rows=max(64, n // 5)), device="cpu").run()
        return bits(fuzz.suite_snapshot(result)), profile.to_json()

    baseline = run("0")
    assert run("1") == baseline
    assert run("0") == baseline


# -- shutdown: abandoned consumers, failing producers --------------------------


def _threads(prefix):
    return [t for t in threading.enumerate() if t.name.startswith(prefix) and t.is_alive()]


def _wait_no_threads(prefix, timeout=psource.JOIN_TIMEOUT_S):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not _threads(prefix):
            return True
        time.sleep(0.02)
    return False


def _open_files(path):
    fd_dir = "/proc/self/fd"
    if not os.path.isdir(fd_dir):
        return 0
    count = 0
    for fd in os.listdir(fd_dir):
        try:
            count += os.readlink(os.path.join(fd_dir, fd)) == path
        except OSError:
            continue
    return count


@pytest.fixture
def long_path(tmp_path):
    return write_parquet(tmp_path, "long.parquet", {"x": np.arange(50_000, dtype=np.float64)}, 2_500)


@pytest.mark.parametrize("read", [1, 12])
def test_consumer_abandon_joins_decode_and_closes_file(long_path, read):
    gen = PTable.scan_parquet(long_path, batch_rows=2_500).batches(2_500)
    for _ in range(read):
        assert next(gen).num_rows == 2_500
    assert _threads("deequ-decode")
    gen.close()  # 20 - read batches unread
    assert _wait_no_threads("deequ-decode")
    assert _open_files(os.path.realpath(long_path)) == 0


def test_staged_over_batches_abandon_unwinds_every_stage(long_path):
    items = pipeline.staged(
        PTable.scan_parquet(long_path, batch_rows=2_500).batches(2_500), lambda b: b.num_rows
    )
    assert next(items) == 2_500
    assert _threads("deequ-pipe-prep") and _threads("deequ-decode")
    items.close()
    assert _wait_no_threads("deequ-pipe-prep") and _wait_no_threads("deequ-decode")
    assert _open_files(os.path.realpath(long_path)) == 0


def test_staged_reraises_a_failing_stage_after_cleanup():
    closed = threading.Event()

    def upstream():
        try:
            for i in range(100):
                yield i
        finally:
            closed.set()

    def fn(i):
        if i == 3:
            raise ValueError("prep failed")
        return i

    got = []
    with pytest.raises(ValueError, match="prep failed"):
        for item in pipeline.staged(upstream(), fn):
            got.append(item)
    assert got == [0, 1, 2] and closed.is_set()
    assert _wait_no_threads("deequ-pipe-prep")


def test_injected_stage_fault_contained_in_staged():
    """A stage fn raising once mid-batch redoes in place — the stream
    sees every item exactly once and the stage thread still joins
    (port-mapped from tests/test_pipeline_shutdown.py)."""
    from deequ_tpu_torch.testing import faults

    with faults.install("seed=1,pipeline.stage:1.0:1") as plan:
        got = list(pipeline.staged(iter(range(50)), lambda x: x * 2, name="t-chaos"))
    assert plan.injected.get("pipeline.stage", 0) == 1
    assert got == [x * 2 for x in range(50)]
    assert _wait_no_threads("deequ-pipe-t-chaos")


def test_source_reraises_a_failing_decode(tmp_path):
    class Failing(psource.DataSource):
        def _schema(self):
            return [("x", ColumnType.DOUBLE)]

        @property
        def num_rows(self):
            return 128

        def _iter_tables(self, batch_size):
            yield PTable.from_numpy({"x": np.arange(64.0)})
            raise OSError("disk went away")

    with pytest.raises(OSError, match="disk went away"):
        PRunner.on_data(Failing(), device="cpu").add_analyzers([P.Mean("x")]).run()
    assert _wait_no_threads("deequ-decode") and _wait_no_threads("deequ-pipe-prep")


# -- cooperative cancel and deadline --------------------------------------------


@pytest.mark.parametrize("pipeline_env", ["0", "1"])
def test_cancel_raises_at_a_batch_boundary(long_path, pipeline_env, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PIPELINE", pipeline_env)
    controller = RunController()
    mean = P.Mean("x")
    original = mean.merge_agg

    def merge_then_cancel(a, b):  # the second batch's fold trips the token
        controller.cancel()
        return original(a, b)

    object.__setattr__(mean, "merge_agg", merge_then_cancel)
    with pytest.raises(RunCancelled) as info:
        PRunner.on_data(PTable.scan_parquet(long_path, batch_rows=2_500), device="cpu").add_analyzers(
            [mean]
        ).with_controller(controller).run()
    assert info.value.code == "DQ401"
    assert 2 <= info.value.progress["batches"] < 20
    assert _wait_no_threads("deequ-pipe-prep") and _wait_no_threads("deequ-decode")
    assert _open_files(os.path.realpath(long_path)) == 0


def test_deadline_raises_run_cancelled(long_path):
    check = PCheck(PLevel.ERROR, "c").has_size(lambda n: n > 0)
    builder = PSuite.on_data(PTable.scan_parquet(long_path, batch_rows=2_500), device="cpu")
    with pytest.raises(RunCancelled) as info:
        builder.add_check(check).with_deadline(-1.0).run()
    assert info.value.code == "DQ402" and info.value.progress == {"batches": 0, "rows": 0}


def test_cancel_at_a_partition_boundary(dataset_dir, monkeypatch):
    controller = RunController()
    original = pfused._merge_partition_results

    def merge_then_cancel(a, b):  # the second partition's merge trips the token
        controller.cancel()
        return original(a, b)

    monkeypatch.setattr(pfused, "_merge_partition_results", merge_then_cancel)
    with pytest.raises(RunCancelled) as info:
        PRunner.on_data(PTable.scan_parquet_dataset(dataset_dir), device="cpu").add_analyzers(
            [P.Size()]
        ).with_controller(controller).run()
    assert info.value.code == "DQ401"
    assert info.value.progress == {
        "partitions_done": 2, "partitions_total": 3, "partitions_cached": 0,
    }


# -- the profiler's straggler pass ----------------------------------------------


def test_streamed_rotating_values_fall_back_to_straggler_pass(tmp_path, monkeypatch):
    """Rotating per-batch dictionaries abort the fused low-cardinality
    counts. With the default threshold no histogram is wanted; with a
    threshold above the distinct count (and the counts' cap below it) the
    histogram pass counts the stragglers over the stream, and the
    histogram equals the JAX package's."""
    rows = []
    for g in range(6):
        rows.extend([f"g{g}_v{i}" for i in range(200)] * 5)
    path = write_parquet(tmp_path, "rot.parquet", {"s": rows, "x": list(range(len(rows)))}, 1000)
    pp = PProfiler.on_data(PTable.scan_parquet(path, batch_rows=1000), device="cpu").run()
    assert pp.profiles["s"].histogram is None  # 1200 distinct > 120

    class SmallCap(column_profiler._LowCardCounts):
        """Counts capped at 100 distinct values whatever the threshold."""

        def __init__(self, column, cap):
            super().__init__(column, 100)

    monkeypatch.setattr(column_profiler, "_LowCardCounts", SmallCap)
    with runtime.monitored() as stats:
        pp = PProfiler.on_data(PTable.scan_parquet(path, batch_rows=1000), device="cpu")
        pp = pp.with_low_cardinality_histogram_threshold(5000).run()
    jp = JProfiler.on_data(JTable.scan_parquet(path, batch_rows=1000)).with_engine("single")
    jp = jp.with_low_cardinality_histogram_threshold(5000).run()
    assert stats.group_passes == 1  # the straggler pass ran
    hist = {k: v.absolute for k, v in pp.profiles["s"].histogram.values.items()}
    assert hist == dict(collections.Counter(rows))
    assert hist == {k: v.absolute for k, v in jp.profiles["s"].histogram.values.items()}


# -- the suite fuzzer's shapes, in memory against streamed ----------------------


@pytest.mark.parametrize("seed", range(10))
def test_suite_agrees_streamed_vs_in_memory(seed, tmp_path):
    rng = np.random.default_rng(9000 + seed)
    jtable = fuzz.random_table(rng)
    checks = [port_random_check(fuzz)(rng) for _ in range(int(rng.integers(1, 3)))]
    n = len(jtable.column("x"))
    path = str(tmp_path / "fuzz.parquet")
    jtable.to_parquet(path, row_group_size=max(64, n // 7), dictionary_encode_strings=True)

    def run(data):
        builder = PSuite.on_data(data, device="cpu")
        for check in checks:
            builder = builder.add_check(check)
        return fuzz.suite_snapshot(builder.run())

    in_memory = run(port_table(jtable))
    streamed = run(PTable.scan_parquet(path, batch_rows=max(64, n // 5)))
    fuzz.assert_snapshots_agree(in_memory, streamed, "memory-vs-stream")


# -- the same batches streamed and in memory: the same bits ----------------------


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_streamed_equals_in_memory_bit_for_bit_when_batches_match(seed, tmp_path):
    """Tiny row groups coalesce into the one batch the in-memory run
    folds, so the streamed profile and suite give its bits exactly (the
    card run holds the same at 4,194,304-row batches)."""
    rng = np.random.default_rng(seed)
    jtable = fuzz.random_table(rng)
    n = len(jtable.column("x"))
    path = str(tmp_path / "same.parquet")
    jtable.to_parquet(path, row_group_size=max(1, n // 10), dictionary_encode_strings=True)
    source = PTable.scan_parquet(path, batch_rows=n)
    assert [b.num_rows for b in source.batches(n)] == [n]
    memory = port_table(jtable)
    checks = [port_random_check(fuzz)(rng) for _ in range(3)]

    def suite(data):
        builder = PSuite.on_data(data, device="cpu")
        for check in checks:
            builder = builder.add_check(check)
        return bits(fuzz.suite_snapshot(builder.run()))

    def profile(data):
        profiles = PProfiler.on_data(data, device="cpu").run()
        return bits({
            name: (p.completeness, p.approximate_num_distinct_values, p.data_type,
                   getattr(p, "mean", None), getattr(p, "sum", None), getattr(p, "std_dev", None),
                   getattr(p, "approx_percentiles", None),
                   None if p.histogram is None else {k: v.absolute for k, v in p.histogram.values.items()})
            for name, p in profiles.profiles.items()
        })

    assert suite(source) == suite(memory)
    assert profile(source) == profile(memory)
