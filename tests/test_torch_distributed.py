"""The port's mesh-sharded scan (deequ_tpu_torch/parallel/distributed.py)
against the JAX package's 8-device CPU mesh (tests/conftest.py), on the
same seeded data: the port's `data_mesh(["cpu"] * 8)` shards each batch
as the JAX mesh does, so counts, minima, maxima, HLL registers, quantiles
and verdicts are equal, and float sums within 1e-12 relative (torch and
XLA add inside a shard in other orders). Port-mapped copies of
tests/test_distributed.py, test_stream_mesh.py, test_engine_selection.py
and test_placement.py::test_distributed_host_placement_parity, with the
engine selection of runners/engine.py and `sharded_bincount`.

Both packages run with DEEQU_TPU_PLACEMENT=device: the JAX package's
"auto" placement measures its link and may answer "host-discrete"
under load."""

from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as J
import deequ_tpu_torch.analyzers as P
from deequ_tpu import Check as JCheck
from deequ_tpu import CheckLevel as JLevel
from deequ_tpu.data.source import ParquetSource as JParquetSource
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.parallel import DistributedScanPass as JDistributedScanPass
from deequ_tpu.parallel import data_mesh as jdata_mesh
from deequ_tpu.profiles.runner import ColumnProfilerRunner as JProfiler
from deequ_tpu.runners.analysis_runner import AnalysisRunner as JRunner
from deequ_tpu.verification import VerificationSuite as JSuite
from deequ_tpu_torch import Check as PCheck
from deequ_tpu_torch import CheckLevel as PLevel
from deequ_tpu_torch import ColumnProfilerRunner as PProfiler
from deequ_tpu_torch import VerificationSuite as PSuite
from deequ_tpu_torch.data.source import ParquetSource as PParquetSource
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.ops import runtime as pruntime
from deequ_tpu_torch.parallel import DistributedScanPass, data_mesh, run_distributed_analysis
from deequ_tpu_torch.parallel.distributed import DeviceMesh, sharded_bincount
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner as PRunner
from deequ_tpu_torch.runners.engine import AUTO_MIN_ROWS, resolve_engine
from torch_stream_helpers import assert_contexts_equal, plain_route, write_parquet

INEXACT = ("Mean", "Sum", "StandardDeviation", "Correlation", "Entropy", "MutualInformation")


@pytest.fixture(autouse=True)
def _device_placement(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


def test_the_jax_mesh_has_eight_devices():
    assert len(jax.devices()) == 8, "tests/conftest.py provides 8 virtual CPU devices"


def cpu_mesh(n=8):
    return data_mesh(["cpu"] * n)


def both(name, *args, **kwargs):
    """The same analyzer from both packages."""
    return getattr(J, name)(*args, **kwargs), getattr(P, name)(*args, **kwargs)


def scan_pair():
    specs = [
        ("Size",), ("Completeness", "x"), ("Mean", "x"), ("Minimum", "x"), ("Maximum", "x"),
        ("Sum", "x"), ("StandardDeviation", "x"), ("Correlation", "x", "y"),
        ("ApproxCountDistinct", "x"), ("ApproxQuantile", "x", 0.5),
        ("ApproxQuantiles", "x", (0.1, 0.5, 0.9)),
    ]
    pairs = [both(*s) for s in specs]
    return [j for j, _ in pairs], [p for _, p in pairs]


def xy_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, n)
    y = 0.5 * x + rng.normal(0, 1, n)
    x[::11] = np.nan
    return {"x": x, "y": y}


def assert_states_equal(jresults, presults):
    """Pass results of both packages: metrics equal, float sums within
    1e-12, and the HLL registers of ApproxCountDistinct equal."""
    for j, p in zip(jresults, presults):
        assert repr(j.analyzer) == repr(p.analyzer)
        jm = j.analyzer.compute_metric_from(j.state_or_raise())
        pm = p.analyzer.compute_metric_from(p.state_or_raise(), None)
        jv, pv = jm.value.get(), pm.value.get()
        if repr(p.analyzer).startswith(INEXACT):
            assert pv == pytest.approx(jv, rel=1e-12), repr(p.analyzer)
        else:
            assert pv == jv, (repr(p.analyzer), pv, jv)
        if repr(p.analyzer).startswith("ApproxCountDistinct"):
            assert np.array_equal(p.state.registers, j.state.registers)


@pytest.mark.parametrize(
    "n,per_device",
    [(10_000, 1 << 21), (20_011, 1 << 21), (1001, 1 << 21), (4096, 64), (20_011, 300)],
    ids=["even", "padded-20011", "uneven-1001", "many-batches", "ragged-shards"],
)
def test_mesh_equals_jax_mesh(n, per_device):
    janalyzers, panalyzers = scan_pair()
    data = xy_data(n)
    jres = JDistributedScanPass(
        janalyzers, mesh=jdata_mesh(), batch_size_per_device=per_device
    ).run(JTable.from_numpy(data))
    with pruntime.monitored() as stats:
        pres = DistributedScanPass(
            panalyzers, mesh=cpu_mesh(), batch_size_per_device=per_device
        ).run(PTable.from_numpy(data))
    assert_states_equal(jres, pres)
    batches = -(-n // (8 * per_device))
    assert stats.mesh_passes == 1 and stats.mesh_shards == 8
    assert stats.device_launches == 8 * batches


def test_padding_shards_fold_to_the_identity():
    """20,011 rows over 8 shards of 4,096 rows: the last shards hold only
    padding, so K1's extremes, K3's registers and a quantile shard with
    n = 0 must fold away."""
    janalyzers, panalyzers = scan_pair()
    data = xy_data(20_011, seed=5)
    jres = JDistributedScanPass(janalyzers, mesh=jdata_mesh(), batch_size_per_device=4096).run(
        JTable.from_numpy(data)
    )
    pres = DistributedScanPass(panalyzers, mesh=cpu_mesh(), batch_size_per_device=4096).run(
        PTable.from_numpy(data)
    )
    assert_states_equal(jres, pres)
    single = P.ApproxCountDistinct("x")
    from deequ_tpu_torch.ops.fused import FusedScanPass

    solo = FusedScanPass([single], device="cpu").run(PTable.from_numpy(data))[0]
    assert np.array_equal(solo.state.registers, pres[8].state.registers)


def test_two_mesh_runs_agree_bit_for_bit():
    _, panalyzers = scan_pair()
    table = PTable.from_numpy(xy_data(9_000, seed=2))
    runs = [
        DistributedScanPass(panalyzers, mesh=cpu_mesh(), batch_size_per_device=512).run(table)
        for _ in range(2)
    ]
    for a, b in zip(*runs):
        assert a.state == b.state


def test_datatype_on_mesh():
    t = PTable.from_pydict({"s": (["1", "2.5", "true", "abc", None] * 100)})
    context = run_distributed_analysis(t, [P.DataType("s")], mesh=cpu_mesh())
    dist = context.metric_map[P.DataType("s")].value.get()
    for label in ("Integral", "Fractional", "Boolean", "String", "Unknown"):
        assert dist[label].absolute == 100


def engine_table_data(n=20_011, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 3.0, n)
    x[rng.random(n) < 0.04] = np.nan
    cats = np.array(["alpha", "beta", "gamma", "delta", None], dtype=object)
    return {
        "x": x,
        "y": 0.3 * x + rng.normal(0, 1, n),
        "qty": rng.integers(0, 30, n),
        "cat": cats[rng.integers(0, 5, n)],
        "code": np.array([str(v) for v in rng.integers(0, 800, n)], dtype=object),
    }


def all_analyzers(mod):
    """Every analyzer family (tests/test_engine_selection.py's 21)."""
    return [
        mod.Size(), mod.Completeness("x"), mod.Compliance("x big", "x >= 10"),
        mod.PatternMatch("cat", r"^(alp|bet)"), mod.Mean("x"), mod.Minimum("x"),
        mod.Maximum("x"), mod.Sum("x"), mod.StandardDeviation("x"), mod.Correlation("x", "y"),
        mod.DataType("code"), mod.ApproxCountDistinct("code"), mod.ApproxQuantile("x", 0.5),
        mod.ApproxQuantiles("x", (0.25, 0.5, 0.75)), mod.Uniqueness(["cat"]),
        mod.Distinctness(["cat"]), mod.UniqueValueRatio(["cat"]), mod.CountDistinct(["cat", "qty"]),
        mod.Entropy("cat"), mod.MutualInformation("cat", "qty"), mod.Histogram("cat"),
    ]


def test_all_21_analyzers_equal_jax_mesh():
    data = engine_table_data()
    ja, pa = all_analyzers(J), all_analyzers(P)
    jctx = JRunner.on_data(JTable.from_numpy(data)).add_analyzers(ja).with_engine("distributed").run()
    with pruntime.monitored() as stats:
        pctx = (
            PRunner.on_data(PTable.from_numpy(data), device="cpu")
            .add_analyzers(pa)
            .with_engine("distributed", cpu_mesh())
            .run()
        )
    assert_contexts_equal(jctx, pctx, ja, pa)
    assert stats.mesh_passes == 1
    # the frequency family counts its groups through sharded_bincount
    assert stats.group_passes >= 1


def engine_checks(check_cls, level):
    return (
        check_cls(level, "engine")
        .has_size(lambda n: n == 20_011)
        .is_complete("x")
        .has_completeness("x", lambda c: c > 0.9)
        .has_mean("x", lambda v: 9.5 < v < 10.5)
        .has_min("x", lambda v: v > -10)
        .has_max("x", lambda v: v < 20)
        .has_approx_count_distinct("code", lambda v: v > 700)
        .has_approx_quantile("x", 0.5, lambda v: 9 < v < 11)
        .is_unique("code")
        .has_uniqueness(["cat"], lambda u: u == 0.0)
    )


def test_verification_suite_distributed_equals_jax():
    data = engine_table_data()
    jres = (
        JSuite.on_data(JTable.from_numpy(data))
        .add_check(engine_checks(JCheck, JLevel.ERROR))
        .add_required_analyzers(all_analyzers(J))
        .with_engine("distributed")
        .run()
    )
    pres = (
        PSuite.on_data(PTable.from_numpy(data), device="cpu")
        .add_check(engine_checks(PCheck, PLevel.ERROR))
        .add_required_analyzers(all_analyzers(P))
        .with_engine("distributed", cpu_mesh())
        .run()
    )
    assert pres.status.value == jres.status.value
    jrows, prows = jres.check_results_as_rows(), pres.check_results_as_rows()
    assert [(r["constraint"], r["constraint_status"]) for r in prows] == [
        (r["constraint"], r["constraint_status"]) for r in jrows
    ]
    jm = {repr(a): m for a, m in jres.metrics.items()}
    pm = {repr(a): m for a, m in pres.metrics.items()}
    assert sorted(pm) == sorted(jm)
    for key, j in jm.items():
        jv, pv = j.value.get(), pm[key].value.get()
        if key.startswith(INEXACT):
            assert pv == pytest.approx(jv, rel=1e-12), key
        elif hasattr(jv, "number_of_bins"):
            assert {k: v.absolute for k, v in pv.values.items()} == {
                k: v.absolute for k, v in jv.values.items()
            }
        else:
            assert pv == jv, key


def test_jax_default_auto_engine_equals_port_mesh():
    """The JAX package's default engine ("auto") takes its 8-device mesh
    at AUTO_MIN_ROWS rows and more: the port's 8-shard CPU mesh gives its
    results (the port's own "auto" on the CPU stays single-device)."""
    n = AUTO_MIN_ROWS + 3_001
    data = xy_data(n, seed=9)
    ja, pa = scan_pair()
    jctx = JRunner.on_data(JTable.from_numpy(data)).add_analyzers(ja).run()
    pctx = (
        PRunner.on_data(PTable.from_numpy(data), device="cpu")
        .add_analyzers(pa)
        .with_engine("distributed", cpu_mesh())
        .run()
    )
    assert_contexts_equal(jctx, pctx, ja, pa)
    with pruntime.monitored() as stats:
        PRunner.on_data(PTable.from_numpy(data), device="cpu").add_analyzers(pa).run()
    assert stats.mesh_passes == 0


def test_profiler_distributed_equals_jax(monkeypatch):
    """A profile over the mesh equals the JAX package's mesh profile (the
    C host libraries off on both sides, as the port's profiler tests
    run: then every string statistic is bit-equal)."""
    from deequ_tpu.ops import native as jnative
    from deequ_tpu_torch.ops import native as pnative

    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jnative, "_TRIED", True)
    monkeypatch.setenv("DEEQU_TPU_NO_NATIVE", "1")
    pnative.reset()
    data = engine_table_data(n=6_007, seed=4)
    jp = JProfiler.on_data(JTable.from_numpy(data)).with_engine("distributed").run()
    pp = PProfiler.on_data(PTable.from_numpy(data), device="cpu").with_engine(
        "distributed", cpu_mesh()
    ).run()
    pnative.reset()
    jcols = json.loads(jp.to_json())["columns"]
    pcols = json.loads(pp.to_json())["columns"]
    assert [c["column"] for c in pcols] == [c["column"] for c in jcols]
    for jc, pc in zip(jcols, pcols):
        for key, value in jc.items():
            if key in ("mean", "sum", "stdDev"):
                assert pc[key] == pytest.approx(value, rel=1e-12), (jc["column"], key)
            else:
                assert pc[key] == value, (jc["column"], key)


@pytest.fixture(scope="module")
def stream_path(tmp_path_factory):
    import pyarrow as pa

    rng = np.random.default_rng(3)
    n = 50_000
    x = rng.normal(5.0, 3.0, n)
    x[::17] = np.nan
    cat = np.array(["red", "green", "blue", None], dtype=object)[rng.integers(0, 4, n)]
    return write_parquet(
        tmp_path_factory.mktemp("streammesh"),
        "data.parquet",
        {
            "x": pa.array(x, mask=np.isnan(x)),
            "cat": pa.array(list(cat)),
            "g": pa.array(rng.integers(0, 500, n)),
        },
        row_group_size=12_500,
    )


def stream_analyzers(mod):
    return [
        mod.Size(), mod.Completeness("x"), mod.Mean("x"), mod.Minimum("x"), mod.Maximum("x"),
        mod.Sum("x"), mod.StandardDeviation("x"), mod.ApproxCountDistinct("g"),
        mod.ApproxCountDistinct("cat"), mod.ApproxQuantiles("x", (0.25, 0.5, 0.75)),
    ]


@pytest.mark.parametrize("pipeline", ["1", "0"], ids=["pipelined", "serial"])
def test_streamed_mesh_equals_jax(stream_path, monkeypatch, pipeline):
    """The streamed branch: DistributedScanPass over a ParquetSource, its
    prep on the pipeline's stage thread (or on the caller), equals the
    JAX mesh over its ParquetSource."""
    plain_route(monkeypatch)
    monkeypatch.setenv("DEEQU_TPU_PIPELINE", pipeline)
    ja, pa = stream_analyzers(J), stream_analyzers(P)
    jres = JDistributedScanPass(ja, mesh=jdata_mesh(), batch_size_per_device=1 << 11).run(
        JParquetSource(stream_path, batch_rows=1 << 14)
    )
    pres = DistributedScanPass(pa, mesh=cpu_mesh(), batch_size_per_device=1 << 11).run(
        PParquetSource(stream_path, batch_rows=1 << 14)
    )
    assert_states_equal(jres, pres)


def test_streamed_grouping_on_mesh_equals_jax(stream_path, monkeypatch):
    plain_route(monkeypatch)
    ja = [J.Uniqueness(("g",)), J.Entropy("cat"), J.CountDistinct(("cat",)), J.Uniqueness(("cat", "g"))]
    pa = [P.Uniqueness(("g",)), P.Entropy("cat"), P.CountDistinct(("cat",)), P.Uniqueness(("cat", "g"))]
    jctx = JRunner.do_analysis_run(
        JParquetSource(stream_path, batch_rows=1 << 14), ja, engine="distributed", mesh=jdata_mesh()
    )
    pctx = PRunner.do_analysis_run(
        PParquetSource(stream_path, batch_rows=1 << 14), pa, "cpu",
        engine="distributed", mesh=cpu_mesh(),
    )
    assert_contexts_equal(jctx, pctx, ja, pa)


def test_host_placement_on_mesh(monkeypatch):
    """Host-placed members under every placement fold beside the mesh:
    the metrics equal the all-device mesh run (float sums within 1e-12),
    and under host-all nothing is launched."""
    rng = np.random.default_rng(7)
    table = PTable.from_numpy({"x": rng.normal(size=4000), "g": rng.integers(0, 30, 4000)})
    analyzers = [
        P.Size(), P.Completeness("x"), P.ApproxCountDistinct("g"), P.Mean("x"),
        P.StandardDeviation("x"), P.ApproxQuantile("x", 0.5),
    ]
    contexts = {}
    for mode in ("device", "host-discrete", "host-all"):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", mode)
        with pruntime.monitored() as stats:
            contexts[mode] = run_distributed_analysis(
                table, analyzers, mesh=cpu_mesh(), batch_size_per_device=256
            )
        assert stats.placements == [mode]
        if mode == "host-all":
            assert stats.device_launches == 0
    for mode in ("host-discrete", "host-all"):
        for a in analyzers:
            got = contexts[mode].metric_map[a].value.get()
            want = contexts["device"].metric_map[a].value.get()
            if repr(a).startswith("ApproxQuantile"):
                # the host fold samples whole batches, the mesh each shard
                assert got == pytest.approx(want, abs=0.1), (mode, a)
            else:
                assert got == pytest.approx(want, rel=1e-12), (mode, a)


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sharded_bincount_equals_numpy(shards):
    rng = np.random.default_rng(shards)
    codes = rng.integers(-1, 50, 10_007)
    with pruntime.monitored() as stats:
        got = sharded_bincount(codes, 50, cpu_mesh(shards))
    assert stats.device_launches == shards  # one per shard
    want = np.bincount(codes[codes >= 0], minlength=50)
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    assert np.array_equal(sharded_bincount(np.full(5, -1), 3, cpu_mesh(shards)), np.zeros(3))


class TestResolveEngine:
    def test_cases(self):
        cpu = torch.device("cpu")
        assert resolve_engine("auto", num_rows=100, device=cpu) is None
        assert resolve_engine("auto", num_rows=AUTO_MIN_ROWS * 4, device=cpu) is None
        assert resolve_engine("single", num_rows=10**9, device=cpu) is None
        assert resolve_engine("distributed", num_rows=1, device=cpu) == DeviceMesh([cpu])
        mesh = cpu_mesh(4)
        assert resolve_engine("distributed", mesh, num_rows=1, device=cpu) is mesh
        assert resolve_engine("auto", mesh, num_rows=AUTO_MIN_ROWS, device=cpu) is mesh
        assert resolve_engine("auto", mesh, num_rows=AUTO_MIN_ROWS - 1, device=cpu) is None
        with pytest.raises(ValueError):
            resolve_engine("warp")

    def test_no_cuda_raises(self):
        if torch.cuda.is_available():
            pytest.skip("a CUDA device is present")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_engine("distributed", num_rows=1)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data_mesh()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DistributedScanPass([P.Size()])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            data_mesh(["cuda"] * 2)

    def test_mesh_shape(self):
        mesh = cpu_mesh(8)
        assert mesh.size == 8 and mesh.device_type == "cpu"
        assert mesh == cpu_mesh(8) and hash(mesh) == hash(cpu_mesh(8))
        assert mesh != cpu_mesh(4)
        with pytest.raises(ValueError):
            DeviceMesh([])
        with pytest.raises(ValueError):
            DeviceMesh([torch.device("cpu"), torch.device("meta")])
