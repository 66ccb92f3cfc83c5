"""ColumnProfilerRunner: the port on device="cpu" against the JAX
package's single-engine profile of the same seeded tables.

The JAX side runs with its device placement and, where the comparison is
exact, without its C host library: that library sums in long double, so
its bits differ from the numpy route the port takes.

Tolerances: every field of the profile JSON is equal (counts, types,
histograms, approximate distinct counts and quantiles) and so are the
sums, means and standard deviations that fold on the host (a string
column's, inferred numeric), bit for bit, with the JAX package's C
library off. The sums, means and standard deviations that fold on the
device (a schema-numeric column's) are taken in another order by torch
than by XLA: they agree within 1e-12 relative. With the C library on,
every sum, mean and standard deviation agrees within 1e-9 relative."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

import deequ_tpu.ops.fused as jax_fused
import deequ_tpu_torch.ops.fused as port_fused
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops import native
from deequ_tpu.ops import runtime as jruntime
from deequ_tpu.profiles import ColumnProfilerRunner as JRunner
from deequ_tpu.profiles.internal_analyzers import LowCardCountsState as JLowCard
from deequ_tpu.profiles.internal_analyzers import _LowCardCounts as JLowCardCounts
from deequ_tpu.profiles.internal_analyzers import _OptimisticNumericStats as JOptimistic
from deequ_tpu.analyzers.scan import DataType as JDataType
from deequ_tpu_torch import ColumnProfilerRunner as PRunner
from deequ_tpu_torch import Table as PTable
from deequ_tpu_torch.analyzers import DataType as PDataType
from deequ_tpu_torch.interop import state_from_reference
from deequ_tpu_torch.ops import counts_family as pcounts
from deequ_tpu_torch.ops import runtime as pruntime
from deequ_tpu_torch.profiles import NumericColumnProfile, StandardColumnProfile
from deequ_tpu_torch.profiles.internal_analyzers import LowCardCountsState
from deequ_tpu_torch.profiles.internal_analyzers import _LowCardCounts as PLowCardCounts
from deequ_tpu_torch.profiles.internal_analyzers import _OptimisticNumericStats as POptimistic

INEXACT = ("mean", "sum", "stdDev")


@pytest.fixture(autouse=True)
def _device_placement(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


@pytest.fixture
def no_native(monkeypatch):
    """The JAX package without its C host library (read once, at load)."""
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)


def example_table(n=120):
    """The table of tests/test_profiler_suggestions.py."""
    return {
        "id": list(range(n)),
        "name": [f"name_{i}" for i in range(n)],
        "status": [["active", "inactive", "pending"][i % 3] for i in range(n)],
        "amountStr": [str(i * 10) for i in range(n)],
        "score": [float(i) / 2 if i % 10 != 0 else None for i in range(n)],
        "flag": [bool(i % 2) for i in range(n)],
    }


def random_table(seed, n):
    """Mixed schema with nulls, numeric strings, empty strings and unicode,
    as the JAX package's differential profile test draws it."""
    rng = np.random.default_rng(seed)
    num = rng.normal(10, 3, n)
    num[rng.random(n) < 0.1] = np.nan
    return {
        "num": num,
        "code": np.array([str(v) for v in rng.integers(-50, 50, n)], dtype=object),
        "frac": np.array([f"{v:.2f}" for v in rng.normal(0, 5, n)], dtype=object),
        "cat": np.array(["α", "beta", "", "Ωmega", None], dtype=object)[rng.integers(0, 5, n)],
        "flag": np.where(rng.random(n) > 0.2, rng.random(n) < 0.5, None),
        "wide": rng.integers(0, 1 << 40, n),
    }


def profile_both(cols, build=lambda b: b, from_numpy=True, **kwargs):
    """-> (JAX profile, port profile, JAX pass counts, port pass counts)."""
    jt = JTable.from_numpy(cols) if from_numpy else JTable.from_pydict(cols)
    pt = PTable.from_numpy(cols) if from_numpy else PTable.from_pydict(cols)
    with jruntime.monitored() as jstats:
        jp = build(JRunner.on_data(jt).with_engine("single")).run()
    with pruntime.monitored() as pstats:
        pp = build(PRunner.on_data(pt, device="cpu")).run()

    def counts(stats):
        return (stats.device_passes, stats.group_passes, stats.jobs)

    return jp, pp, counts(jstats), counts(pstats)


def assert_same_profiles(jp, pp, rtol=None):
    """Equal JSON, except the sums, means and standard deviations within
    `rtol`, or, without it, those of device-folded columns within 1e-12."""
    jcols = json.loads(jp.to_json())["columns"]
    pcols = json.loads(pp.to_json())["columns"]
    assert [c["column"] for c in pcols] == [c["column"] for c in jcols]
    for jc, pc in zip(jcols, pcols):
        assert sorted(pc) == sorted(jc)
        host_folded = jc["isDataTypeInferred"] == "true"
        for key, value in jc.items():
            if key in INEXACT and (rtol is not None or not host_folded):
                assert pc[key] == pytest.approx(value, rel=rtol or 1e-12), (jc["column"], key)
            else:
                assert pc[key] == value, (jc["column"], key)


@pytest.mark.parametrize("counts_fastpath", [True, False], ids=["counts", "rows"])
@pytest.mark.parametrize("batch_size", [None, 50, 37], ids=["one", "three", "ragged"])
def test_example_profile_equals_jax(no_native, monkeypatch, batch_size, counts_fastpath):
    """The host members fold more than one batch when the batch is
    smaller than the table. Without the counts fast path
    (DEEQU_TPU_NO_COUNTS_FASTPATH), a numeric-looking string column's
    statistics come from its cast rows instead of its dictionary."""
    if not counts_fastpath:
        monkeypatch.setenv("DEEQU_TPU_NO_COUNTS_FASTPATH", "1")
    if batch_size is not None:
        monkeypatch.setattr(jax_fused, "DEFAULT_BATCH_SIZE", batch_size)
        monkeypatch.setattr(port_fused, "DEFAULT_BATCH_SIZE", batch_size)
    jp, pp, jn, pn = profile_both(example_table(), from_numpy=False)
    assert_same_profiles(jp, pp)
    assert pn == jn


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("batch_size", [None, 611], ids=["one", "multi"])
def test_random_profiles_equal_jax(no_native, monkeypatch, seed, batch_size):
    if batch_size is not None:
        monkeypatch.setattr(jax_fused, "DEFAULT_BATCH_SIZE", batch_size)
        monkeypatch.setattr(port_fused, "DEFAULT_BATCH_SIZE", batch_size)
    n = int(np.random.default_rng(100 + seed).integers(1500, 3000))
    jp, pp, jn, pn = profile_both(random_table(seed, n))
    assert_same_profiles(jp, pp)
    assert pn == jn


@pytest.mark.parametrize("seed", [0, 1])
def test_profiles_agree_with_the_jax_c_library_on(seed):
    if not native.available():
        pytest.skip("the JAX package's C host library does not build here")
    jp, pp, jn, pn = profile_both(random_table(seed, 2500))
    assert_same_profiles(jp, pp, rtol=1e-9)
    assert pn == jn


def test_pass_budget_equals_jax(no_native):
    """One fused pass: the inferred-numeric string's statistics ride pass
    1, and so do the histograms."""
    jp, pp, jn, pn = profile_both(example_table(), from_numpy=False)
    assert pn == jn == (1, 0, 1)
    assert pp.num_records == 120


def test_two_passes_without_numeric_strings(no_native):
    cols = {
        "id": list(range(50)),
        "score": [float(i) for i in range(50)],
        "status": [["a", "b"][i % 2] for i in range(50)],
    }
    jp, pp, jn, pn = profile_both(cols, from_numpy=False)
    assert pn == jn == (1, 0, 1)
    assert_same_profiles(jp, pp)
    assert pp.profiles["id"].mean == pytest.approx(24.5)
    assert pp.profiles["score"].maximum == 49.0


def test_profile_contents():
    """The JAX package's expectations (tests/test_profiler_suggestions.py)
    hold for the port."""
    profiles = PRunner.on_data(PTable.from_pydict(example_table()), device="cpu").run()
    id_profile = profiles.profiles["id"]
    assert isinstance(id_profile, NumericColumnProfile)
    assert id_profile.data_type == "Integral" and not id_profile.is_data_type_inferred
    assert id_profile.completeness == 1.0
    assert (id_profile.minimum, id_profile.maximum) == (0.0, 119.0)
    assert id_profile.mean == pytest.approx(59.5)
    assert id_profile.sum == pytest.approx(7140.0)
    assert len(id_profile.approx_percentiles) == 100
    amount = profiles.profiles["amountStr"]
    assert isinstance(amount, NumericColumnProfile)
    assert amount.data_type == "Integral" and amount.is_data_type_inferred
    assert (amount.minimum, amount.maximum) == (0.0, 1190.0)
    status = profiles.profiles["status"]
    assert isinstance(status, StandardColumnProfile)
    assert status.data_type == "String"
    assert status.histogram["active"].absolute == 40
    assert profiles.profiles["score"].completeness == pytest.approx(108 / 120)
    flag = profiles.profiles["flag"]
    assert flag.data_type == "Boolean" and flag.histogram["true"].absolute == 60


def test_restrict_to_columns(no_native):
    jp, pp, _, _ = profile_both(
        example_table(), lambda b: b.restrict_to_columns(["id", "status"]), from_numpy=False
    )
    assert set(pp.profiles) == {"id", "status"}
    assert_same_profiles(jp, pp)


@pytest.mark.parametrize("threshold", [2, 3, 120, 200])
def test_cardinality_threshold(no_native, threshold):
    jp, pp, jn, pn = profile_both(
        example_table(),
        lambda b: b.with_low_cardinality_histogram_threshold(threshold),
        from_numpy=False,
    )
    assert_same_profiles(jp, pp)
    assert pn == jn
    assert (pp.profiles["status"].histogram is None) == (threshold < 3)


def test_json_export(no_native, tmp_path):
    ppath, jpath = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    data = example_table()
    PRunner.on_data(PTable.from_pydict(data), device="cpu").save_column_profiles_json_to_path(
        ppath
    ).run()
    JRunner.on_data(JTable.from_pydict(data)).with_engine("single").save_column_profiles_json_to_path(
        jpath
    ).run()
    with open(ppath) as f:
        port = json.load(f)
    with open(jpath) as f:
        assert port == json.load(f)
    by_column = {c["column"]: c for c in port["columns"]}
    assert by_column["id"]["dataType"] == "Integral"
    assert "histogram" in by_column["status"]
    with pytest.raises(FileExistsError):
        PRunner.on_data(PTable.from_pydict(data), device="cpu").save_column_profiles_json_to_path(
            ppath
        ).run()


def test_regex_numeric_but_uncastable_falls_back_to_pass2(no_native):
    """'+ 5' matches the Integral regex but does not parse: the
    speculative statistics die and a real pass 2 runs on the cast."""
    cols = {"v": ["+ 5", "3", "7", None] * 30}
    jp, pp, jn, pn = profile_both(cols, from_numpy=False)
    assert pn == jn == (2, 0, 2)
    assert_same_profiles(jp, pp)
    p = pp.profiles["v"]
    assert p.data_type == "Integral"
    assert p.mean == pytest.approx(5.0)


EXAMPLE_RAW = {
    # examples/data_profiling_example.py's raw data
    "name": np.array(["thingA", "thingA", "thingB", "thingC", "thingD", "thingC", "thingC",
                      "thingE"], dtype=object),
    "count": np.array(["13.0", "5", None, None, "1.0", "7.0", "20", "20"], dtype=object),
    "status": np.array(["IN_TRANSIT", "DELAYED", "DELAYED", "IN_TRANSIT", "DELAYED", "UNKNOWN",
                        "UNKNOWN", "DELAYED"], dtype=object),
    "valuable": np.array(["true", "false", None, "false", "true", None, None, "false"],
                         dtype=object),
}


def test_data_profiling_example_equals_jax(no_native):
    jp, pp, jn, pn = profile_both(EXAMPLE_RAW)
    assert_same_profiles(jp, pp)
    assert pn == jn
    count = pp.profiles["count"]
    assert (count.data_type, count.completeness) == ("Fractional", 0.75)
    assert (count.minimum, count.maximum, count.mean, count.sum) == (1.0, 20.0, 11.0, 66.0)
    status = {k: v.absolute for k, v in pp.profiles["status"].histogram.values.items()}
    assert status == {"IN_TRANSIT": 2, "DELAYED": 4, "UNKNOWN": 2}
    assert pp.profiles["valuable"].data_type == "Boolean"
    assert pp.profiles["name"].approximate_num_distinct_values == 5


@pytest.mark.parametrize("column", ["status", "flag", "name"])
def test_low_card_counts_states_equal_jax(no_native, column):
    data = example_table()
    jt, pt = JTable.from_pydict(data), PTable.from_pydict(data)
    jstate = jax_fused.FusedScanPass([JLowCardCounts(column, 256)], batch_size=50).run(jt)[0]
    pstate = port_fused.FusedScanPass([PLowCardCounts(column, 256)], batch_size=50,
                                      device="cpu").run(pt)[0]
    js, ps = jstate.state_or_raise(), pstate.state_or_raise()
    assert ps == state_from_reference("LowCardCountsState", js.__dict__)
    assert (ps.counts, ps.null_count, ps.aborted) == (js.counts, js.null_count, js.aborted)


@pytest.mark.parametrize("column", ["amountStr", "name", "status"])
def test_optimistic_numeric_states_equal_jax(no_native, column):
    data = example_table()
    jt, pt = JTable.from_pydict(data), PTable.from_pydict(data)
    jres = jax_fused.FusedScanPass(
        [JLowCardCounts(column, 256), JOptimistic(column)], batch_size=50).run(jt)
    pres = port_fused.FusedScanPass(
        [PLowCardCounts(column, 256), POptimistic(column)], batch_size=50, device="cpu").run(pt)
    js, ps = jres[1].state_or_raise(), pres[1].state_or_raise()
    fields = ("n", "total", "minimum", "maximum", "m2", "dead")
    assert [getattr(ps, f) for f in fields] == [getattr(js, f) for f in fields]
    if js.digest is None:
        assert ps.digest is None
    else:
        k1, n1, l1 = js.digest.to_arrays()
        k2, n2, l2 = ps.digest.to_arrays()
        assert (k1, n1) == (k2, n2) and all(a.tobytes() == b.tobytes() for a, b in zip(l1, l2))
        digest = (k1, n1, l1)
        carried = state_from_reference(
            "OptimisticNumericState", {**{f: getattr(js, f) for f in fields}, "digest": digest})
        assert carried.digest.to_arrays()[1] == n2


def test_a_failed_host_input_fails_only_its_member(no_native):
    """An input that fails to build fails the host member that reads it;
    the device members of the pass keep their results."""
    pt = PTable.from_pydict(example_table())
    results = port_fused.FusedScanPass(
        [PDataType("status"), PLowCardCounts("missing", 256)], device="cpu").run(pt)
    assert results[0].error is None and results[0].state.num_string == 120
    assert results[1].error is not None


def test_data_type_state_carries_across():
    jt = JTable.from_pydict(example_table())
    js = jax_fused.FusedScanPass([JDataType("amountStr")]).run(jt)[0].state_or_raise()
    ps = state_from_reference("DataTypeHistogram", js.__dict__)
    assert ps.__dict__ == js.__dict__


def test_low_card_counts_cap_aborts_the_merge():
    state = None
    for batch in range(10):
        partial = LowCardCountsState(tuple((f"v{batch}_{i}", 1) for i in range(100)), 0, False, 300)
        state = partial if state is None else state.merge(partial)
        jpartial = JLowCard(tuple((f"v{batch}_{i}", 1) for i in range(100)), 0, False, 300)
        jstate = jpartial if batch == 0 else jstate.merge(jpartial)
        assert state.aborted == jstate.aborted
    assert state.aborted and state.counts == ()


@pytest.mark.parametrize("cap", [4, 64, 512])
def test_weighted_moments_and_sample_equal_jax(cap):
    from deequ_tpu.ops import counts_family as jcounts

    rng = np.random.default_rng(cap)
    values = np.sort(np.unique(rng.normal(0, 10, 300).round(2)))
    counts = rng.integers(1, 50, len(values))
    got = pcounts.weighted_moments_and_sample(values, counts, cap)
    want = jcounts.weighted_moments_and_sample(values, counts, cap)
    assert got[0] == want[0] and got[2:] == want[2:]
    assert got[1].tobytes() == want[1].tobytes()


def test_the_profiler_needs_cuda_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PRunner.on_data(PTable.from_pydict(example_table())).run()


@pytest.mark.parametrize("option", ["distributed"])
def test_unported_options_raise(option):
    """The distributed engine, once unported, now runs: over an 8-shard
    CPU mesh the profile equals the single-device one (counts, types and
    histograms exactly, float sums within 1e-12), and an unknown engine
    still raises."""
    from deequ_tpu_torch.parallel import data_mesh

    table = PTable.from_pydict(example_table())
    single = PRunner.on_data(table, device="cpu").with_engine("single").run()
    sharded = (
        PRunner.on_data(table, device="cpu").with_engine(option, data_mesh(["cpu"] * 8)).run()
    )
    got, want = json.loads(sharded.to_json()), json.loads(single.to_json())
    assert [c["column"] for c in got["columns"]] == [c["column"] for c in want["columns"]]
    for g, w in zip(got["columns"], want["columns"]):
        for key, value in w.items():
            if key in ("mean", "sum", "stdDev"):
                assert g[key] == pytest.approx(value, rel=1e-12), (w["column"], key)
            else:
                assert g[key] == value, (w["column"], key)
    with pytest.raises(ValueError):
        PRunner.on_data(table, device="cpu").with_engine("warp").run()


def _saved(repository, key):
    return {repr(a): m.value.get() for a, m in repository.load_by_key(key).metric_map.items()}


def test_repository_saves_what_the_jax_package_saves(no_native):
    """A profile saved to a metrics repository holds the JAX package's
    metrics: the same analyzers, counts exact, sums within 1e-12."""
    from deequ_tpu.repository import InMemoryMetricsRepository as JRepository
    from deequ_tpu.repository import ResultKey as JKey
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey

    jrepo, prepo = JRepository(), InMemoryMetricsRepository()
    JRunner.on_data(JTable.from_pydict(example_table())).with_engine("single").use_repository(
        jrepo).save_or_append_result(JKey(1, {"run": "a"})).run()
    PRunner.on_data(PTable.from_pydict(example_table()), device="cpu").use_repository(
        prepo).save_or_append_result(ResultKey(1, {"run": "a"})).run()
    jsaved, psaved = _saved(jrepo, JKey(1, {"run": "a"})), _saved(prepo, ResultKey(1, {"run": "a"}))
    assert sorted(psaved) == sorted(jsaved)
    for key, value in jsaved.items():
        if key.startswith(("Mean", "Sum", "StandardDeviation")):
            assert psaved[key] == pytest.approx(value, rel=1e-12)
        elif hasattr(value, "number_of_bins"):
            assert {k: v.absolute for k, v in psaved[key].values.items()} == {
                k: v.absolute for k, v in value.values.items()
            }
        else:
            assert psaved[key] == value, key


def test_reuse_existing_results_runs_only_the_internal_members(no_native):
    """A profile that reuses a saved key recomputes no saved metric: its
    one pass folds only the internal members (which are never saved),
    as the JAX package's does, and the profile is the same."""
    from deequ_tpu.repository import InMemoryMetricsRepository as JRepository
    from deequ_tpu.repository import ResultKey as JKey
    from deequ_tpu_torch.repository import InMemoryMetricsRepository, ResultKey

    def profiles(runner, table, repo, key, runtime):
        first = runner(table).use_repository(repo).save_or_append_result(key).run()
        with runtime.monitored() as stats:
            again = runner(table).use_repository(repo).reuse_existing_results_for_key(
                key, fail_if_results_missing=True).run()
        return first, again, (stats.device_passes, stats.group_passes)

    pfirst, pagain, pjobs = profiles(
        lambda t: PRunner.on_data(t, device="cpu"), PTable.from_pydict(example_table()),
        InMemoryMetricsRepository(), ResultKey(7, {}), pruntime)
    _jfirst, _jagain, jjobs = profiles(
        lambda t: JRunner.on_data(t).with_engine("single"), JTable.from_pydict(example_table()),
        JRepository(), JKey(7, {}), jruntime)
    assert json.loads(pagain.to_json()) == json.loads(pfirst.to_json())
    assert pjobs == jjobs == (1, 0)


def test_pass_counters_nest():
    """An inner `monitored()` block counts only its own passes, the outer
    one counts both runs, and the port counts as the JAX package does."""
    cols = {"a": np.arange(10.0), "s": np.array(list("abcabcabca"), dtype=object)}
    runs = {
        "jax": (jruntime, lambda: JRunner.on_data(JTable.from_numpy(cols))
                .with_engine("single").run()),
        "port": (pruntime, lambda: PRunner.on_data(PTable.from_numpy(cols), device="cpu").run()),
    }
    seen = {}
    for name, (runtime, run) in runs.items():
        with runtime.monitored() as outer:
            run()
            with runtime.monitored() as inner:
                run()
        assert inner.jobs >= 1
        assert (outer.device_passes, outer.group_passes) == (
            2 * inner.device_passes, 2 * inner.group_passes)
        seen[name] = (inner.device_passes, inner.group_passes)
    assert seen["port"] == seen["jax"]
