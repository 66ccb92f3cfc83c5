"""The port's observability against the JAX package's on the same seeded
numpy tables (under 131,072 rows, so the JAX package's "auto" engine
stays on its single pass; every port run on the CPU):

- the pass labels of `runtime.monitored()` are the JAX package's, label
  for label (the port's stats had no labels before the port took
  `observe.counters`);
- a traced run's `dispatch_signature` and `span_name_counts` are equal in
  both packages for the trace-differential scenarios;
- failure forensics samples the same rows (partition, row group, row
  index, values) in both packages: both seed the reservoir from the
  violating indices themselves;
- an audit-trail envelope and an engine telemetry record written by one
  package decode in the other;
- `engine_metric_record` of the same run has the same keys in both.
"""

from __future__ import annotations

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import deequ_tpu.observe as jobserve
from deequ_tpu.analyzers import (
    ApproxCountDistinct as JApproxCountDistinct,
    ApproxQuantile as JApproxQuantile,
    Completeness as JCompleteness,
    Distinctness as JDistinctness,
    Histogram as JHistogram,
    Maximum as JMaximum,
    Mean as JMean,
    Minimum as JMinimum,
    StandardDeviation as JStandardDeviation,
    Sum as JSum,
    Uniqueness as JUniqueness,
)
from deequ_tpu.checks.check import Check as JCheck
from deequ_tpu.checks.check import CheckLevel as JCheckLevel
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops import runtime as jruntime
from deequ_tpu.repository import engine as jengine
from deequ_tpu.repository.audit import load_audit_trail as jload_audit_trail
from deequ_tpu.repository.base import ResultKey as JResultKey
from deequ_tpu.repository.fs import FileSystemMetricsRepository as JRepository
from deequ_tpu.runners import AnalysisRunner as JRunner
from deequ_tpu.verification.suite import VerificationSuite as JSuite
from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Distinctness,
    Histogram,
    Maximum,
    Mean,
    Minimum,
    StandardDeviation,
    Sum,
    Uniqueness,
)
from deequ_tpu_torch.checks.check import Check, CheckLevel
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.repository import engine
from deequ_tpu_torch.repository.audit import load_audit_trail
from deequ_tpu_torch.repository.base import ResultKey
from deequ_tpu_torch.repository.fs import FileSystemMetricsRepository
from deequ_tpu_torch.runners import AnalysisRunner
from deequ_tpu_torch.verification.suite import VerificationSuite

PORT = {
    "ApproxCountDistinct": ApproxCountDistinct,
    "ApproxQuantile": ApproxQuantile,
    "Completeness": Completeness,
    "Distinctness": Distinctness,
    "Histogram": Histogram,
    "Maximum": Maximum,
    "Mean": Mean,
    "Minimum": Minimum,
    "StandardDeviation": StandardDeviation,
    "Sum": Sum,
    "Uniqueness": Uniqueness,
}
JAX = {
    "ApproxCountDistinct": JApproxCountDistinct,
    "ApproxQuantile": JApproxQuantile,
    "Completeness": JCompleteness,
    "Distinctness": JDistinctness,
    "Histogram": JHistogram,
    "Maximum": JMaximum,
    "Mean": JMean,
    "Minimum": JMinimum,
    "StandardDeviation": JStandardDeviation,
    "Sum": JSum,
    "Uniqueness": JUniqueness,
}

# the scenarios of tests/test_trace_differential.py: (placement, analyzers)
SCENARIOS = {
    "device_scan": (
        "device",
        [("Mean", ("price",)), ("StandardDeviation", ("price",)), ("Minimum", ("cost",)),
         ("Maximum", ("cost",)), ("Completeness", ("qty",)), ("Sum", ("qty",))],
    ),
    "host_all_families": (
        "host",
        [("ApproxQuantile", ("price", 0.5)), ("ApproxQuantile", ("cost", 0.5)),
         ("ApproxCountDistinct", ("price",)),
         ("ApproxQuantile", ("qty", 0.9), {"where": "qty > 10"}), ("Mean", ("price",))],
    ),
    "grouping_sets": (
        "device",
        [("Uniqueness", (["cat"],)), ("Distinctness", (["cat"],)),
         ("Uniqueness", (["cat", "qty"],))],
    ),
    "mixed": (
        "device",
        [("Mean", ("price",)), ("StandardDeviation", ("price",)), ("Histogram", ("cat",)),
         ("Uniqueness", (["cat"],)), ("Distinctness", (["qty"],))],
    ),
}


def _columns(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "price": rng.random(n) * 100.0,
        "cost": rng.standard_normal(n),
        "qty": rng.integers(0, 50, n),
        "cat": rng.integers(0, 8, n),
    }


def _build(registry, spec):
    out = []
    for entry in spec:
        name, args = entry[0], entry[1]
        kwargs = entry[2] if len(entry) > 2 else {}
        out.append(registry[name](*args, **kwargs))
    return out


@pytest.fixture
def pinned(monkeypatch):
    """The knobs both cost models state as assumptions, for both packages."""
    monkeypatch.setenv("DEEQU_TPU_NO_COUNTS_FASTPATH", "1")
    return monkeypatch


def _both_traced(spec, placement, pinned):
    pinned.setenv("DEEQU_TPU_PLACEMENT", placement)
    cols = _columns()
    jctx = (
        JRunner.on_data(JTable.from_numpy(cols)).add_analyzers(_build(JAX, spec))
        .with_engine("single").with_tracing(True).run()
    )
    pctx = (
        AnalysisRunner.on_data(Table.from_numpy(cols), device="cpu")
        .add_analyzers(_build(PORT, spec)).with_tracing(True).run()
    )
    return jctx, pctx


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_dispatch_signature_and_span_counts_equal_jax(scenario, pinned):
    placement, spec = SCENARIOS[scenario]
    jctx, pctx = _both_traced(spec, placement, pinned)
    psig = observe.dispatch_signature(pctx.run_trace)
    jsig = jobserve.dispatch_signature(jctx.run_trace)
    # by design: the port runs each shared frequency aggregation on the
    # run's device (one launch), the JAX package on the host below
    # ops/freq_agg.py's _DEVICE_THRESHOLD groups (none here)
    freq_aggs = psig["spans"].get("freq_agg", 0)
    assert psig["counters"].pop("device_launches") == (
        jsig["counters"].pop("device_launches") + freq_aggs
    )
    assert psig == jsig
    assert observe.span_name_counts(pctx.run_trace) == jobserve.span_name_counts(jctx.run_trace)
    # and each side equals its own cost model, as both packages' tests pin
    assert pctx.plan_cost.dispatch_signature() == observe.dispatch_signature(pctx.run_trace)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_pass_labels_equal_jax(scenario, pinned):
    placement, spec = SCENARIOS[scenario]
    pinned.setenv("DEEQU_TPU_PLACEMENT", placement)
    cols = _columns(seed=3)
    with jruntime.monitored() as jstats:
        JRunner.on_data(JTable.from_numpy(cols)).add_analyzers(_build(JAX, spec)).with_engine(
            "single"
        ).run()
    with runtime.monitored() as stats:
        AnalysisRunner.on_data(Table.from_numpy(cols), device="cpu").add_analyzers(
            _build(PORT, spec)
        ).run()
    assert stats.pass_labels == jstats.pass_labels
    assert len(stats.pass_labels) == stats.device_passes + stats.group_passes


def test_engine_metric_record_keys_equal_jax(pinned):
    placement, spec = SCENARIOS["mixed"]
    jctx, pctx = _both_traced(spec, placement, pinned)
    jrec = jobserve.engine_metric_record(jctx.run_trace, jctx.plan_cost)
    prec = observe.engine_metric_record(pctx.run_trace, pctx.plan_cost)
    assert set(prec) == set(jrec)
    for key, value in prec.items():
        # (the wire bytes are each package's own: the port ships no
        # row-count scalar, and its drift against its own model is 0)
        if key.startswith(("engine.drift.", "engine.counter.")) or key in (
            "engine.rows", "engine.batches"
        ):
            if key == "engine.counter.device_launches":
                continue  # the port's frequency aggregation launches (above)
            assert value == jrec[key], key


# -- forensics ------------------------------------------------------------------


def _forensics_columns(n=3000, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n) * 10.0
    x[rng.random(n) < 0.07] = np.nan  # nulls: completeness and the bounds skip them
    name = np.array([f"n{i % 97}" if i % 13 else None for i in range(n)], dtype=object)
    return {"x": x, "name": name, "k": rng.integers(0, 100, n)}


def _forensics_check(check_cls, level):
    return (
        check_cls(level.ERROR, "forensics")
        .is_complete("x")
        .is_complete("name")
        .satisfies("k < 90", "k bounded", lambda v: v >= 0.99)
        .has_min("x", lambda v: v >= -5.0)
        .has_max("x", lambda v: v <= 5.0)
        .has_pattern("name", r"^n[0-5]\d*$", lambda v: v >= 0.99)
        .is_unique("k")
    )


def _samples(report):
    return [
        (
            c.constraint, c.kind, c.violations_seen,
            [(s.partition, s.row_group, s.row_index, s.values) for s in c.samples],
        )
        for c in report.constraints
    ]


def test_forensics_samples_equal_jax_in_memory(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    cols = _forensics_columns()
    jres = (
        JSuite.on_data(JTable.from_numpy(cols)).add_check(_forensics_check(JCheck, JCheckLevel))
        .with_engine("single").with_forensics(max_samples=7).run()
    )
    pres = (
        VerificationSuite.on_data(Table.from_numpy(cols), device="cpu")
        .add_check(_forensics_check(Check, CheckLevel)).with_forensics(max_samples=7).run()
    )
    jrep, prep = jres.forensics(), pres.forensics()
    assert _samples(prep) == _samples(jrep)
    assert all(c.samples for c in prep.failed()), "every failed capable constraint has rows"
    assert prep.falloffs == jrep.falloffs  # is_unique falls off (DQ316) in both


def _write_dataset(tmp_path, cols, parts=3, row_group_size=400):
    data_dir = tmp_path / "ds"
    data_dir.mkdir()
    n = len(cols["x"])
    per = -(-n // parts)
    for p in range(parts):
        sl = slice(p * per, min((p + 1) * per, n))
        table = pa.table({k: pa.array(list(v[sl])) if v.dtype == object else v[sl]
                          for k, v in cols.items()})
        pq.write_table(table, str(data_dir / f"part-{p:02d}.parquet"),
                       row_group_size=row_group_size)
    return str(data_dir)


def test_forensics_samples_equal_jax_over_partitions(tmp_path, monkeypatch):
    """Partitioned Parquet: the samples carry each partition's name and
    fingerprint, the row group and the row within it, equal in both."""
    from deequ_tpu.data.table import Table as JT

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", "0")
    data_dir = _write_dataset(tmp_path, _forensics_columns(n=2400, seed=9))
    jres = (
        JSuite.on_data(JT.scan_parquet_dataset(data_dir))
        .add_check(_forensics_check(JCheck, JCheckLevel)).with_engine("single")
        .with_forensics(max_samples=5).run()
    )
    pres = (
        VerificationSuite.on_data(Table.scan_parquet_dataset(data_dir), device="cpu")
        .add_check(_forensics_check(Check, CheckLevel)).with_forensics(max_samples=5).run()
    )
    jrep, prep = jres.forensics(), pres.forensics()
    assert _samples(prep) == _samples(jrep)
    coords = [s for c in _samples(prep) for s in c[3]]
    assert coords and all(p is not None and p.startswith("part-") for p, _g, _r, _v in coords)
    assert any(g > 0 for _p, g, _r, _v in coords)  # rows past the first row group
    assert prep.provenance["partitions"] == jrep.provenance["partitions"]
    assert prep.provenance["rowGroupsScanned"] == jrep.provenance["rowGroupsScanned"]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_audit_trail_written_by_one_package_loads_in_the_other(tmp_path, writer, monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    cols = _forensics_columns(n=800, seed=2)
    path = str(tmp_path / "metrics.json")
    if writer == "jax":
        JSuite.on_data(JTable.from_numpy(cols)).add_check(
            _forensics_check(JCheck, JCheckLevel)
        ).with_engine("single").with_forensics().use_repository(JRepository(path)).save_or_append_result(
            JResultKey(7, {"day": "mon"})
        ).run()
    else:
        VerificationSuite.on_data(Table.from_numpy(cols), device="cpu").add_check(
            _forensics_check(Check, CheckLevel)
        ).with_forensics().use_repository(FileSystemMetricsRepository(path)).save_or_append_result(
            ResultKey(7, {"day": "mon"})
        ).run()
    jrep = jload_audit_trail(JRepository(path), JResultKey(7, {"day": "mon"}))
    prep = load_audit_trail(FileSystemMetricsRepository(path), ResultKey(7, {"day": "mon"}))
    assert jrep is not None and prep is not None
    assert prep.to_dict() == jrep.to_dict()
    assert prep.failed()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_engine_record_written_by_one_package_loads_in_the_other(tmp_path, writer, pinned):
    placement, spec = SCENARIOS["device_scan"]
    jctx, pctx = _both_traced(spec, placement, pinned)
    path = str(tmp_path / "engine.json")
    if writer == "jax":
        jengine.record_run(
            JRepository(path), jctx.run_trace, jctx.plan_cost, suite="s", dataset="d",
            data_set_date=1000,
        )
    else:
        engine.record_run(
            FileSystemMetricsRepository(path), pctx.run_trace, pctx.plan_cost, suite="s",
            dataset="d", data_set_date=1000,
        )
    jnames = jengine.engine_metric_names(JRepository(path))
    pnames = engine.engine_metric_names(FileSystemMetricsRepository(path))
    assert pnames == jnames and "engine.wall_s" in pnames
    jpoints = jengine.engine_series(JRepository(path), "engine.rows")
    ppoints = engine.engine_series(FileSystemMetricsRepository(path), "engine.rows")
    assert [(p.time, p.metric_value) for p in ppoints] == [
        (p.time, p.metric_value) for p in jpoints
    ]
    assert [p.metric_value for p in ppoints] == [4096.0]


def test_execution_span_vocabulary_is_the_cost_models():
    """The trace side's span and counter vocabulary is the one the port's
    cost model predicts, and the JAX package's."""
    from deequ_tpu.observe import compare as jcompare
    from deequ_tpu_torch.lint import cost
    from deequ_tpu_torch.observe import compare

    assert compare.EXECUTION_SPANS == cost.EXECUTION_SPANS == jcompare.EXECUTION_SPANS
    assert compare.COUNTERS == cost.COUNTERS == jcompare.COUNTERS


def test_observe_exports_every_name_of_the_jax_package():
    assert sorted(observe.__all__) == sorted(jobserve.__all__)
    for name in jobserve.__all__:
        assert hasattr(observe, name), name


def _stage_dispatches(trace):
    """{stage of the nearest enclosing pipe_stage span: dispatch spans}
    of a traced run (the prep stage's thread opens its span under the
    fold stage's)."""
    out = {}

    def visit(sp, stage):
        if sp.name == "pipe_stage":
            stage = sp.attrs.get("stage")
        elif sp.name == "dispatch":
            out[stage] = out.get(stage, 0) + 1
        for child in sp.children:
            visit(child, stage)

    visit(trace.root, None)
    return out


def test_dispatch_times_the_launch_where_jax_times_the_pack(tmp_path, monkeypatch):
    """By design: the port's `dispatch` span wraps the host's launch of a
    batch's program, on the fold stage (its packing and host-to-device
    copy run in the prep stage's item spans); the JAX package's wraps the
    packing and the device put, on the prep stage. The counts per scan
    are equal, so the cost model's prediction holds for both."""
    from deequ_tpu.data.table import Table as JT

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", "1")
    cols = _columns(n=6000, seed=11)
    path = str(tmp_path / "t.parquet")
    pq.write_table(pa.table(cols), path, row_group_size=1000)
    spec = SCENARIOS["device_scan"][1]
    jctx = (JRunner.on_data(JT.scan_parquet(path, batch_rows=2000)).add_analyzers(_build(JAX, spec))
            .with_engine("single").with_tracing(True).run())
    pctx = (AnalysisRunner.on_data(Table.scan_parquet(path, batch_rows=2000), device="cpu")
            .add_analyzers(_build(PORT, spec)).with_tracing(True).run())
    jstages, pstages = _stage_dispatches(jctx.run_trace), _stage_dispatches(pctx.run_trace)
    batches = observe.span_name_counts(pctx.run_trace)["dispatch"]
    assert batches > 1
    assert jstages == {"prep": batches}
    assert pstages == {"fold": batches}
    assert observe.span_name_counts(pctx.run_trace) == jobserve.span_name_counts(jctx.run_trace)
