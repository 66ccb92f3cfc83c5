"""The port's host-fold placements against the JAX package's, on the CPU.

`runtime.placement_mode` (device, host-discrete, host-all; auto probes a
CUDA link and keeps the measurement on disk), the host routes of the
scan-shareable analyzers (`host_reduce`, the quantiles' `host_batch`)
and the fused pass's placement of its members, on the same seeded
inputs in both packages. Port-mapped from tests/test_placement.py and
the placement half of tests/test_differential_random.py.

Tolerances: counts, minima, maxima, HLL registers, quantiles and check
statuses equal; float sums (Mean, Sum, StandardDeviation, Correlation,
Entropy) within 1e-12 relative. Quantiles compare exactly: under every
placement both packages decimate the same sample (the C selection on
the host, a full float64 sort or the port's hist16 route on the device)
and carry the same sketch seeds.

Also the two faults this slice repairs: the port's CPU plan signature
equals the JAX package's under the default knobs (it hashed no
"encfold" tag), and `StateRepository.merge_range` resolves its device as
the runners do.

Left out: `test_distributed_host_placement_parity` (the 8-device mesh,
ROADMAP queue 1 item 7).
"""

from __future__ import annotations

import dataclasses
import json
import types

import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as J
import deequ_tpu_torch.analyzers as P
import test_differential_random as differential
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops import native as jax_native
from deequ_tpu.ops.fused import FusedScanPass as JFused
from deequ_tpu.repository.states import plan_signature_for as jax_plan_signature_for
from deequ_tpu.runners.analysis_runner import AnalysisRunner as JRunner
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import native, runtime
from deequ_tpu_torch.ops.fused import FusedScanPass, plan_scan_members
from deequ_tpu_torch.repository.states import InMemoryStateRepository, plan_signature_for
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from torch_stream_helpers import assert_metric_equal, port_table

PLACEMENTS = ("device", "host-discrete", "host-all")


@pytest.fixture(autouse=True)
def _libraries_on(monkeypatch):
    """Both C libraries on and no placement forced, whatever an earlier
    test of this worker did."""
    monkeypatch.delenv("DEEQU_TPU_NO_NATIVE", raising=False)
    monkeypatch.delenv("DEEQU_TPU_PLACEMENT", raising=False)
    native.reset()
    yield
    native.reset()


def port_analyzer(a):
    """The port's analyzer with a JAX analyzer's class and fields."""
    if isinstance(a, J.ApproxQuantiles):
        return P.ApproxQuantiles(a.column, a.quantiles, a.relative_error)
    cls = getattr(P, type(a).__name__)
    return cls(**{f.name: getattr(a, f.name) for f in dataclasses.fields(a)})


def _mixed_data():
    rng = np.random.default_rng(42)
    x = rng.normal(10.0, 3.0, 5000)
    x[::7] = np.nan
    return {
        "x": x,
        "n": rng.integers(0, 1000, 5000),
        "s": np.array(
            [["alpha", "42", "3.14", "true", None][i % 5] for i in range(5000)], dtype=object
        ),
    }


def _analyzers(m):
    return [
        m.Size(),
        m.Size(where="n > 500"),
        m.Completeness("x"),
        m.Completeness("x", where="n > 500"),
        m.Compliance("big n", "n >= 100"),
        m.PatternMatch("s", r"^\d+$"),
        m.ApproxCountDistinct("n"),
        m.ApproxCountDistinct("s"),
        m.DataType("s"),
        # the non-discrete members stay on the device under host-discrete
        m.Mean("x"),
        m.Minimum("x"),
        m.Maximum("x"),
        m.Sum("x"),
        m.StandardDeviation("x"),
        m.ApproxQuantile("x", 0.5),
        m.Correlation("x", "n"),
    ]


def _port_metrics(analyzers, placement, monkeypatch, batch_size=1024):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    results = FusedScanPass(analyzers, batch_size=batch_size, device="cpu").run(
        Table.from_numpy(_mixed_data())
    )
    return {
        repr(r.analyzer): r.analyzer.compute_metric_from(r.state_or_raise()) for r in results
    }


def _jax_metrics(analyzers, placement, monkeypatch, batch_size=1024):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host" if placement == "host-all" else placement)
    results = JFused(analyzers, batch_size=batch_size).run(JTable.from_numpy(_mixed_data()))
    return {
        repr(r.analyzer): r.analyzer.compute_metric_from(r.state_or_raise()) for r in results
    }


# -- placement_mode ---------------------------------------------------------------


@pytest.mark.parametrize(
    "env,expect",
    [("device", "device"), ("host", "host-all"), ("host-all", "host-all"),
     ("host-discrete", "host-discrete"), ("auto", "device"), (None, "device")],
)
def test_placement_mode_names_equal_jax(monkeypatch, env, expect):
    from deequ_tpu.ops import runtime as jax_runtime

    if env is None:
        monkeypatch.delenv("DEEQU_TPU_PLACEMENT", raising=False)
    else:
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", env)
    # a CPU run has no link: auto places as "device", as the JAX package's
    # CPU backend classifies itself when its probe sees a memcpy link
    # (its answer is a measurement, taken under this run's load: pinned)
    monkeypatch.setattr(jax_runtime, "_PLACEMENT_CACHE", "device")
    assert runtime.placement_mode("cpu") == expect == jax_runtime.placement_mode()


def test_unknown_placement_raises(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "sideways")
    with pytest.raises(ValueError, match="sideways"):
        runtime.placement_mode("cpu")


def test_cpu_run_needs_no_probe(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a CPU run must not measure a link")

    monkeypatch.setattr(runtime, "measure_device_bandwidth", boom)
    assert runtime.placement_mode("cpu") == "device"


@pytest.mark.parametrize(
    "bandwidth,expect",
    [(5e9, "device"), (2e9, "device"), (500e6, "host-discrete"), (100e6, "host-discrete"),
     (99e6, "host-all"), (1e6, "host-all")],
)
def test_classification_thresholds_equal_jax(bandwidth, expect):
    from deequ_tpu.ops import runtime as jax_runtime

    assert runtime.PLACEMENT_DEVICE_ALL_BANDWIDTH == jax_runtime.PLACEMENT_DEVICE_ALL_BANDWIDTH
    assert runtime.PLACEMENT_BANDWIDTH_FLOOR == jax_runtime.PLACEMENT_BANDWIDTH_FLOOR
    assert runtime.PLACEMENT_CACHE_TTL_S == jax_runtime.PLACEMENT_CACHE_TTL_S
    assert runtime.classify_bandwidth(bandwidth) == expect


class _FakeCuda:
    """A resolved CUDA device for `placement_mode` on a CPU-only box."""

    type = "cuda"


class TestPlacementDiskCache:
    """The probe's measurement persists per host and card with a TTL in
    the port's own cache directory; a corrupt cache never breaks
    placement_mode; a probe that fails raises."""

    KEY = "host:NVIDIA H100 80GB HBM3"

    @pytest.fixture(autouse=True)
    def _fresh(self, monkeypatch, tmp_path):
        monkeypatch.setenv("DEEQU_TPU_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(runtime, "_PLACEMENT_CACHE", {})
        monkeypatch.setattr(runtime, "resolve_device", lambda device=None: _FakeCuda())
        monkeypatch.setattr(runtime, "_platform_key", lambda device: self.KEY)
        self.path = tmp_path / "deequ_tpu_torch" / "placement.json"

    def test_cache_is_the_ports_own(self, tmp_path):
        from deequ_tpu.ops import runtime as jax_runtime

        runtime._save_bandwidth_to_disk(self.KEY, 123456789.0)
        assert self.path.exists()
        assert str(tmp_path / "deequ_tpu_torch") == runtime.cache_dir()
        assert jax_runtime._placement_cache_path() != str(self.path)

    def test_round_trip(self):
        runtime._save_bandwidth_to_disk(self.KEY, 123456789.0)
        assert runtime._load_bandwidth_from_disk(self.KEY) == 123456789.0
        assert runtime._load_bandwidth_from_disk("other:card") is None

    def test_auto_probes_once_then_reads_the_cache(self, monkeypatch):
        calls = []

        def measure(device, *a, **k):
            calls.append(device)
            return 5e9

        monkeypatch.setattr(runtime, "measure_device_bandwidth", measure)
        assert runtime.placement_mode() == "device"
        assert len(calls) == 1
        assert json.loads(self.path.read_text())[self.KEY]["bandwidth"] == 5e9
        runtime._PLACEMENT_CACHE.clear()  # a new process
        assert runtime.placement_mode() == "device"
        assert len(calls) == 1

    def test_probe_skipped_when_cached(self, monkeypatch):
        runtime._save_bandwidth_to_disk(self.KEY, 5e9)

        def boom(*a, **k):
            raise AssertionError("probe must not run when cached")

        monkeypatch.setattr(runtime, "measure_device_bandwidth", boom)
        assert runtime.placement_mode() == "device"

    def test_expired_entry_reprobes(self, monkeypatch):
        runtime._save_bandwidth_to_disk(self.KEY, 5e9)
        later = runtime.time.time() + runtime.PLACEMENT_CACHE_TTL_S + 1
        monkeypatch.setattr(runtime.time, "time", lambda: later)
        assert runtime._load_bandwidth_from_disk(self.KEY) is None

    @pytest.mark.parametrize(
        "content",
        ["null", '["device"]', '{"x": "y"', '{"a": 1}',
         '{"host:NVIDIA H100 80GB HBM3": {"bandwidth": -5, "ts": 0}}'],
    )
    def test_corrupt_cache_is_ignored(self, content):
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.path.write_text(content)
        assert runtime._load_bandwidth_from_disk(self.KEY) is None
        runtime._save_bandwidth_to_disk(self.KEY, 1e6)
        assert runtime._load_bandwidth_from_disk(self.KEY) == 1e6

    def test_classification_uses_current_thresholds(self):
        runtime._save_bandwidth_to_disk(self.KEY, 500e6)  # a mid-speed link
        assert runtime.placement_mode() == "host-discrete"

    def test_a_failed_probe_raises(self, monkeypatch):
        """The JAX probe answers "host-all" for any exception; the port's
        raises, so a CUDA run never leaves the card on its own."""

        def broken(*a, **k):
            raise RuntimeError("CUDA error: the link went away")

        monkeypatch.setattr(runtime, "measure_device_bandwidth", broken)
        with pytest.raises(RuntimeError, match="link went away"):
            runtime.placement_mode()
        assert not self.path.exists()


# -- the member plan ---------------------------------------------------------------


@pytest.mark.parametrize("mode", PLACEMENTS)
def test_member_plan_equals_jax(mode):
    from deequ_tpu.ops.fused import plan_scan_members as jax_plan

    janalyzers = _analyzers(J)
    panalyzers = [port_analyzer(a) for a in janalyzers]
    jp, pp = jax_plan(janalyzers, mode), plan_scan_members(panalyzers, mode)
    for name in ("merge_idx", "assisted_idx", "host_idx", "host_assisted_idx", "device_keys",
                 "assisted_keys", "host_keys"):
        assert getattr(pp, name) == getattr(jp, name), name
    assert pp.packed_only_keys == jp.packed_only_keys
    assert pp.mode == jp.mode == mode


def test_discrete_flags_equal_jax():
    for ja in _analyzers(J):
        pa = port_analyzer(ja)
        assert getattr(pa, "discrete_inputs", False) == getattr(ja, "discrete_inputs", False), ja


# -- port-mapped: tests/test_placement.py -------------------------------------------


@pytest.mark.parametrize("library", ["on", "off"])
@pytest.mark.parametrize("placement", PLACEMENTS)
def test_metrics_equal_jax_under_each_placement(placement, library, monkeypatch):
    """With both C libraries on, the host folds share their C routes;
    with both off, their numpy routes."""
    if library == "off":
        jax_native.available()
        monkeypatch.setattr(jax_native, "_LIB", None)
        monkeypatch.setattr(jax_native, "_TRIED", True)
        monkeypatch.setenv("DEEQU_TPU_NO_NATIVE", "1")
        native.reset()
    jax_ = _jax_metrics(_analyzers(J), placement, monkeypatch)
    port = _port_metrics(_analyzers(P), placement, monkeypatch)
    assert list(port) == list(jax_)
    for key in jax_:
        assert_metric_equal(jax_[key], port[key], key)


def test_host_placement_matches_device(monkeypatch):
    """Within the port: the host folds against the device fold (here the
    kernels' plain versions). Quantiles equal exactly: the C selection
    gives the sample the hist16 route gives."""
    device = _port_metrics(_analyzers(P), "device", monkeypatch)
    for placement in ("host-all", "host-discrete"):
        host = _port_metrics(_analyzers(P), placement, monkeypatch)
        assert device.keys() == host.keys()
        for key in device:
            assert_metric_equal(device[key], host[key], key)


def test_host_placement_skips_device_for_all_discrete(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
    discrete_only = [a for a in _analyzers(P) if getattr(a, "discrete_inputs", False)]
    with runtime.monitored() as stats:
        results = FusedScanPass(discrete_only, batch_size=1024, device="cpu").run(
            Table.from_numpy(_mixed_data())
        )
    assert all(r.error is None for r in results)
    # still ONE logical pass over the data, but no device program
    assert stats.device_passes == 1
    assert stats.device_launches == 0
    assert stats.placements == ["host-all"]


def test_host_discrete_runs_the_value_members_on_the_device(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host-discrete")
    analyzers = _analyzers(P)
    with runtime.monitored() as stats:
        FusedScanPass(analyzers, batch_size=1024, device="cpu").run(Table.from_numpy(_mixed_data()))
    discrete = sum(getattr(a, "discrete_inputs", False) for a in analyzers)
    assert (stats.device_members, stats.host_members) == (len(analyzers) - discrete, discrete)
    assert stats.device_launches == 5  # 5,000 rows in batches of 1,024


def test_host_placement_isolates_failures(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
    results = FusedScanPass(
        [P.Completeness("x"), P.Compliance("bad", "nonexistent_col > 1"), P.Size()],
        batch_size=1024, device="cpu",
    ).run(Table.from_numpy(_mixed_data()))
    jresults = JFused(
        [J.Completeness("x"), J.Compliance("bad", "nonexistent_col > 1"), J.Size()],
        batch_size=1024,
    ).run(JTable.from_numpy(_mixed_data()))
    assert results[0].error is None
    assert results[1].error is not None  # fails alone
    assert type(results[1].error).__name__ == type(jresults[1].error).__name__
    assert results[2].error is None


def test_host_all_runs_everything_without_device(monkeypatch):
    """Below the bandwidth floor EVERY analyzer, the device-assisted
    quantile sketch too, folds on the host: no launch, one pass."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
    with runtime.monitored() as stats:
        results = FusedScanPass(_analyzers(P), batch_size=1024, device="cpu").run(
            Table.from_numpy(_mixed_data())
        )
    assert all(r.error is None for r in results)
    assert stats.device_passes == 1
    assert stats.device_launches == 0
    assert (stats.device_members, stats.host_members) == (0, len(results))


def test_pure_host_fold_takes_one_batch_of_an_in_memory_table(monkeypatch):
    """With no explicit batch size, host-all folds an in-memory table as
    one batch (the default size bounds the device copy), as the JAX
    package does: its sketch then equals a one-batch device run's."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host-all")
    seen = []
    real = Table.batches

    def spy(self, size):
        seen.append(size)
        return real(self, size)

    monkeypatch.setattr(Table, "batches", spy)
    FusedScanPass([P.ApproxQuantile("x", 0.5)], device="cpu").run(Table.from_numpy(_mixed_data()))
    FusedScanPass([P.ApproxQuantile("x", 0.5)], batch_size=1024, device="cpu").run(
        Table.from_numpy(_mixed_data())
    )
    assert seen == [1 << 22, 1024]


# -- port-mapped: the placement half of tests/test_differential_random.py -------------


def _snapshot(ctx, analyzers):
    out = {}
    for analyzer in analyzers:
        out[repr(analyzer)] = ctx.metric_map[analyzer]
    return out


def _port_random_analyzers(rng):
    """The JAX test's `random_analyzers` over the port's classes: the same
    code and the same draws."""
    fn = differential.random_analyzers
    scope = dict(fn.__globals__)
    scope.update({name: getattr(P, name) for name in dir(P) if name[:1].isupper()})
    return types.FunctionType(fn.__code__, scope, fn.__name__, fn.__defaults__)(rng)


@pytest.mark.parametrize("seed", range(0, differential.N_TRIALS, 3))
def test_placements_agree_with_jax_on_random_input(seed, monkeypatch):
    rng = np.random.default_rng(2000 + seed)
    jtable = differential.random_table(rng)
    state = rng.bit_generator.state
    janalyzers = differential.random_analyzers(rng)
    rng.bit_generator.state = state
    panalyzers = _port_random_analyzers(rng)
    assert [repr(a) for a in panalyzers] == [repr(a) for a in janalyzers]
    snaps = {}
    for placement in PLACEMENTS:
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
        pctx = AnalysisRunner.do_analysis_run(port_table(jtable), panalyzers, device="cpu")
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host" if placement == "host-all" else placement)
        jctx = JRunner.do_analysis_run(jtable, janalyzers, engine="single")
        for ja, pa in zip(janalyzers, panalyzers):
            assert_metric_equal(jctx.metric_map[ja], pctx.metric_map[pa], repr(pa))
        snaps[placement] = _snapshot(pctx, panalyzers)
    # within the port, as the JAX test holds its placements: sums within
    # 1e-9; one in-memory batch under every placement here, so the
    # quantile sketches are equal too
    for placement in ("host-discrete", "device"):
        for key, metric in snaps["host-all"].items():
            assert_metric_equal(metric, snaps[placement][key], key, rtol=1e-9)


# -- the two faults --------------------------------------------------------------


def _encfold_sets():
    # the analyzer sets of tests/test_encoded_fold.py::test_plan_signature_keyed_on_fold_mode
    # and of the fault's report
    return [lambda m: [m.Mean("code")], lambda m: [m.Size(), m.Mean("x")]]


@pytest.mark.parametrize("library", ["on", "off"])
@pytest.mark.parametrize("fold", ["1", "0"])
@pytest.mark.parametrize("analyzers", _encfold_sets(), ids=["mean-code", "size-mean-x"])
def test_plan_signature_equals_jax_under_default_knobs(analyzers, fold, library, monkeypatch):
    """Before this slice the port hashed `fold_variant` alone ("" on the
    CPU) while the JAX package hashed "encfold" whenever the encoded fold
    could engage: no entry of a shared state repository was shared."""
    from deequ_tpu.ops import runtime as jax_runtime

    monkeypatch.delenv("DEEQU_TPU_PLACEMENT", raising=False)
    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", fold)
    # the placement both hash: "device", the JAX package's classification
    # of its CPU link when its probe is not slowed by this run's load
    monkeypatch.setattr(jax_runtime, "_PLACEMENT_CACHE", "device")
    if library == "off":
        # the JAX package reads its switch at its first load only: load
        # it, then take it away (tests/test_no_native_fallback.py)
        jax_native.available()
        monkeypatch.setattr(jax_native, "_LIB", None)
        monkeypatch.setattr(jax_native, "_TRIED", True)
        monkeypatch.setenv("DEEQU_TPU_NO_NATIVE", "1")
        native.reset()
    expect_tag = fold == "1" and library == "on"
    assert ("encfold" in runtime.fold_signature_variant(torch.device("cpu"))) == expect_tag
    assert jax_runtime.fold_signature_variant() == runtime.fold_signature_variant(
        torch.device("cpu")
    )
    assert plan_signature_for(analyzers(P), device="cpu") == jax_plan_signature_for(
        analyzers(J)
    )


def test_fold_signature_variant_on_the_card():
    cuda = torch.device("cuda", 0)
    assert runtime.fold_signature_variant(cuda) == "cuda-folds+encfold"


def test_merge_range_resolves_its_device_as_the_runners_do(monkeypatch):
    """Without a device, `merge_range` runs on CUDA, and raises when no
    CUDA device is present, as the runners do; with device="cpu" it
    answers. Before this slice it always reduced on the CPU."""
    repo = InMemoryStateRepository()
    analyzers = [P.Size(), P.Mean("x")]
    table = Table.from_numpy({"x": np.arange(10.0)})
    states = [r.state for r in FusedScanPass(analyzers, device="cpu").run(table)]
    repo.save_states("ds", "f1", "sig", list(zip(analyzers, states)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repo.merge_range("ds", ["f1"], analyzers, "sig")
    ranged = repo.merge_range("ds", ["f1"], analyzers, "sig", device="cpu")
    assert ranged.metric_map[P.Size()].value.get() == 10.0
    assert ranged.metric_map[P.Mean("x")].value.get() == 4.5


# -- the profiler under the host placements ------------------------------------------


def _profile_data(seed: int, n: int):
    rng = np.random.default_rng(seed)
    num = rng.normal(10, 3, n)
    num[rng.random(n) < 0.1] = np.nan
    return {
        "num": num,
        "qty": rng.integers(1, 51, n),
        "code": np.array([str(v) for v in rng.integers(-50, 50, n)], dtype=object),
        "cat": np.array(["α", "beta", "", "Ωmega", None], dtype=object)[rng.integers(0, 5, n)],
        "wide": rng.integers(0, 1 << 40, n),
        "flag": rng.random(n) < 0.3,
    }


@pytest.mark.parametrize("counts_fastpath", [True, False], ids=["counts", "rows"])
@pytest.mark.parametrize("placement", ["host-discrete", "host-all"])
def test_profiles_equal_jax_under_host_placements(placement, counts_fastpath, monkeypatch):
    """A profile's one pass with its members placed on the host (under
    host-all the numeric columns' 100-quantile sketches run the family
    kernels, and those with few values the counts route) gives the JAX
    package's profile: means, sums and deviations within 1e-12, all else
    exactly."""
    from deequ_tpu import Table as JTable
    from deequ_tpu.profiles.runner import ColumnProfilerRunner as JProfiler
    from deequ_tpu_torch import ColumnProfilerRunner

    if not counts_fastpath:
        monkeypatch.setenv("DEEQU_TPU_NO_COUNTS_FASTPATH", "1")
    data = _profile_data(5, 3000)
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host" if placement == "host-all" else placement)
    jp = JProfiler.on_data(JTable.from_numpy(data)).with_engine("single").run()
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    with runtime.monitored() as stats:
        pp = ColumnProfilerRunner.on_data(Table.from_numpy(data), device="cpu").run()
    assert stats.placements and set(stats.placements) == {placement}
    if placement == "host-all":
        assert stats.device_launches == 0
        assert stats.family_kernels + stats.family_shortcuts > 0
    jcols = json.loads(jp.to_json())["columns"]
    pcols = json.loads(pp.to_json())["columns"]
    assert [c["column"] for c in pcols] == [c["column"] for c in jcols]
    for jc, pc in zip(jcols, pcols):
        assert sorted(pc) == sorted(jc)
        for key, value in jc.items():
            if key in ("mean", "sum", "stdDev"):
                assert pc[key] == pytest.approx(value, rel=1e-12), (jc["column"], key)
            else:
                assert pc[key] == value, (jc["column"], key)
