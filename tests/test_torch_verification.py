"""The whole slice: the JAX package's VerificationSuite against the port's
on device="cpu", over one batch, several batches and a ragged tail, plus
an all-null column and an empty table. Check and constraint statuses and
messages must be equal; metrics agree within BASELINE.md's 1e-6 bound."""

from __future__ import annotations

import numpy as np
import pytest

import deequ_tpu.ops.fused as jax_fused
import deequ_tpu_torch.ops.fused as port_fused
from deequ_tpu.checks.check import Check as JCheck
from deequ_tpu.checks.check import CheckLevel as JLevel
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.verification.suite import VerificationSuite as JSuite
from deequ_tpu_torch import Check as PCheck
from deequ_tpu_torch import CheckLevel as PLevel
from deequ_tpu_torch import Table as PTable
from deequ_tpu_torch import VerificationSuite as PSuite

N_ROWS = 1000


def example_data(n_rows, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, n_rows)
    y = 0.5 * x + rng.normal(0.0, 1.0, n_rows)
    x[::11] = np.nan
    ids = rng.integers(0, n_rows, n_rows)
    cats = np.array(["ok", "warn", "err", "skip", None], dtype=object)
    cat = cats[rng.integers(0, len(cats), n_rows)]
    grp = rng.integers(0, 5, n_rows)
    return {"x": x, "y": y, "id": ids, "cat": cat, "grp": grp}


def flagship_check(check_cls, level, n_rows):
    return (
        check_cls(level, "flagship")
        .has_size(lambda n: n == n_rows)
        .is_complete("x")
        .has_completeness("x", lambda c: c > 0.9, hint="x is mostly present")
        .is_complete("y")
        .has_mean("x", lambda v: 2.5 < v < 3.5)
        .has_min("x", lambda v: v > 0)
        .has_max("x", lambda v: v < 100)
        .has_sum("x", lambda v: v > 0)
        .has_standard_deviation("x", lambda v: 1.5 < v < 2.5)
        .has_correlation("x", "y", lambda r: r > 0.5)
        .has_approx_count_distinct("id", lambda v: v > 0.5 * n_rows)
        .has_approx_count_distinct("cat", lambda v: v == 4)
        .has_completeness("missing", lambda c: c == 1.0)
        .has_mean("cat", lambda v: v > 0)
    )


def run_both(data, monkeypatch, batch_size=None):
    if batch_size is not None:
        monkeypatch.setattr(jax_fused, "DEFAULT_BATCH_SIZE", batch_size)
        monkeypatch.setattr(port_fused, "DEFAULT_BATCH_SIZE", batch_size)
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    n_rows = len(data["x"])
    jres = (
        JSuite.on_data(JTable.from_numpy(data))
        .with_engine("single")
        .add_check(flagship_check(JCheck, JLevel.ERROR, n_rows))
        .add_check(JCheck(JLevel.WARNING, "soft").has_size(lambda n: n > 10 * n_rows))
        .run()
    )
    pres = (
        PSuite.on_data(PTable.from_numpy(data), device="cpu")
        .add_check(flagship_check(PCheck, PLevel.ERROR, n_rows))
        .add_check(PCheck(PLevel.WARNING, "soft").has_size(lambda n: n > 10 * n_rows))
        .run()
    )
    return jres, pres


def assert_same_verdicts(jres, pres):
    assert pres.status.value == jres.status.value
    jrows, prows = jres.check_results_as_rows(), pres.check_results_as_rows()
    assert [r["check_status"] for r in prows] == [r["check_status"] for r in jrows]
    assert [r["constraint"] for r in prows] == [r["constraint"] for r in jrows]
    assert [r["constraint_status"] for r in prows] == [r["constraint_status"] for r in jrows]
    for j, p in zip(jrows, prows):
        if j["constraint_message"].startswith("Value: ") and "Mean" in j["constraint"]:
            continue  # the rendered mean may differ in its last digit
        assert p["constraint_message"] == j["constraint_message"], (j, p)


def assert_same_metrics(jres, pres):
    jm = {repr(a): m for a, m in jres.metrics.items()}
    pm = {repr(a): m for a, m in pres.metrics.items()}
    assert sorted(pm) == sorted(jm)
    for key, j in jm.items():
        p = pm[key]
        assert p.value.is_success == j.value.is_success, key
        if j.value.is_success:
            jv, pv = j.value.get(), p.value.get()
            assert abs(pv - jv) <= 1e-6 * max(1.0, abs(jv)), (key, jv, pv)
        else:
            assert str(p.value.exception) == str(j.value.exception), key


@pytest.mark.parametrize(
    "batch_size", [None, 250, 300], ids=["one-batch", "four-batches", "ragged-tail"]
)
def test_flagship_suite_matches_reference(monkeypatch, batch_size):
    jres, pres = run_both(example_data(N_ROWS), monkeypatch, batch_size)
    assert_same_verdicts(jres, pres)
    assert_same_metrics(jres, pres)


def test_all_null_column(monkeypatch):
    data = example_data(N_ROWS)
    data["x"] = np.full(N_ROWS, np.nan)
    jres, pres = run_both(data, monkeypatch, batch_size=300)
    assert_same_verdicts(jres, pres)
    assert_same_metrics(jres, pres)


def test_empty_table(monkeypatch):
    data = {k: v[:0] for k, v in example_data(16).items()}
    jres, pres = run_both(data, monkeypatch)
    assert_same_verdicts(jres, pres)
    assert_same_metrics(jres, pres)


def test_where_is_not_ported_yet(monkeypatch):
    """The name dates from the first slice, when `where` raised
    NotImplementedError. `where` is ported now: a filtered check must give
    the JAX package's verdicts and metrics."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    data = example_data(N_ROWS)

    def check(check_cls, level):
        return (
            check_cls(level.ERROR, "filtered")
            .has_mean("x", lambda v: v > 0).where("y > 0")
            .has_size(lambda n: n > 300).where("cat IN ('ok', 'warn') OR grp >= 3")
            .is_complete("x").where("x IS NOT NULL")
        )

    jres = (
        JSuite.on_data(JTable.from_numpy(data)).with_engine("single")
        .add_check(check(JCheck, JLevel)).run()
    )
    pres = PSuite.on_data(PTable.from_numpy(data), device="cpu").add_check(check(PCheck, PLevel)).run()
    assert_same_verdicts(jres, pres)
    assert_same_metrics(jres, pres)


def test_host_placement_is_not_ported_yet(monkeypatch):
    """A suite under DEEQU_TPU_PLACEMENT=host (every analyzer folded on
    the host) gives the JAX package's verdicts and metrics; the name is
    kept from before the host placements were ported."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
    data = example_data(3000)
    jres = (
        JSuite.on_data(JTable.from_numpy(data)).with_engine("single")
        .add_check(flagship_check(JCheck, JLevel.ERROR, 3000)).run()
    )
    pres = PSuite.on_data(PTable.from_numpy(data), device="cpu").add_check(
        flagship_check(PCheck, PLevel.ERROR, 3000)
    ).run()
    assert_same_verdicts(jres, pres)
    assert_same_metrics(jres, pres)


def test_no_device_and_no_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    table = PTable.from_numpy(example_data(32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PSuite.on_data(table).add_check(PCheck(PLevel.ERROR, "c").is_complete("x")).run()


def test_metrics_json_matches_reference(monkeypatch):
    jres, pres = run_both(example_data(200), monkeypatch)
    import json

    jrows = {(r["name"], r["instance"]): r["value"] for r in json.loads(jres.success_metrics_as_json())}
    prows = {(r["name"], r["instance"]): r["value"] for r in json.loads(pres.success_metrics_as_json())}
    assert prows.keys() == jrows.keys()
    for key, value in jrows.items():
        assert abs(prows[key] - value) <= 1e-6 * max(1.0, abs(value)), key


# Every Check method of the second slice, one constraint each, against
# the JAX package: ratios of counts fail on purpose so that their
# messages (which render the value) are compared too; entropy and mutual
# information, whose last digit may differ, carry assertions that pass.
SLICE2_METHODS = {
    "is_unique": lambda c: c.is_unique("id"),
    "is_primary_key": lambda c: c.is_primary_key("id", "grp"),
    "has_uniqueness": lambda c: c.has_uniqueness(["cat", "grp"], lambda v: v > 0.5),
    "has_distinctness": lambda c: c.has_distinctness("grp", lambda v: v > 0.5),
    "has_unique_value_ratio": lambda c: c.has_unique_value_ratio(["id"], lambda v: v > 0.9),
    "has_number_of_distinct_values": lambda c: c.has_number_of_distinct_values("cat", lambda b: b == 4),
    "has_entropy": lambda c: c.has_entropy("cat", lambda e: e > 0),
    "has_mutual_information": lambda c: c.has_mutual_information("cat", "grp", lambda v: v >= 0),
    "has_approx_quantile": lambda c: c.has_approx_quantile("x", 0.5, lambda v: v > 10),
    "satisfies": lambda c: c.satisfies("x > 2 AND grp < 3", "rule", lambda r: r > 0.9),
    "satisfies_where": lambda c: c.satisfies("x > 2", "rule", lambda r: r > 0.9).where("cat = 'ok'"),
    "has_pattern": lambda c: c.has_pattern("cat", "^w", lambda r: r > 0.5, name="starts with w"),
    "contains_email": lambda c: c.contains_email("cat"),
    "contains_url": lambda c: c.contains_url("cat", lambda r: r == 0),
    "contains_credit_card_number": lambda c: c.contains_credit_card_number("cat"),
    "contains_social_security_number": lambda c: c.contains_social_security_number("cat"),
    "is_non_negative": lambda c: c.is_non_negative("x"),
    "is_positive": lambda c: c.is_positive("grp"),
    "is_less_than": lambda c: c.is_less_than("x", "y"),
    "is_less_than_or_equal_to": lambda c: c.is_less_than_or_equal_to("grp", "x"),
    "is_greater_than": lambda c: c.is_greater_than("x", "y"),
    "is_greater_than_or_equal_to": lambda c: c.is_greater_than_or_equal_to("grp", "grp"),
    "is_contained_in_values": lambda c: c.is_contained_in("cat", ["ok", "warn"]),
    "is_contained_in_range": lambda c: c.is_contained_in(
        "x", lower_bound=-1, upper_bound=7, include_upper_bound=False
    ),
}


@pytest.mark.parametrize("method", sorted(SLICE2_METHODS))
def test_slice2_check_methods_match_reference(monkeypatch, method):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    data = example_data(N_ROWS)
    build = SLICE2_METHODS[method]
    jres = (
        JSuite.on_data(JTable.from_numpy(data)).with_engine("single")
        .add_check(build(JCheck(JLevel.WARNING, method))).run()
    )
    pres = (
        PSuite.on_data(PTable.from_numpy(data), device="cpu")
        .add_check(build(PCheck(PLevel.WARNING, method))).run()
    )
    assert_same_verdicts(jres, pres)
    jm = {repr(a): m for a, m in jres.metrics.items()}
    pm = {repr(a): m for a, m in pres.metrics.items()}
    assert sorted(pm) == sorted(jm)
    for key, j in jm.items():
        p = pm[key]
        assert p.value.is_success == j.value.is_success, key
        if not j.value.is_success:
            assert str(p.value.exception) == str(j.value.exception), key
        elif hasattr(j.value.get(), "number_of_bins"):
            assert p.value.get().number_of_bins == j.value.get().number_of_bins
        else:
            assert abs(p.value.get() - j.value.get()) <= 1e-12, key


def test_deprecated_analysis_container():
    """Port-mapped from tests/test_analysis_runner.py: the legacy bag of
    analyzers (reference: analyzers/Analysis.scala:29-63), on the CPU."""
    import warnings

    from deequ_tpu_torch.analyzers import Analysis, Mean, Size

    analysis = Analysis().add_analyzer(Size()).add_analyzers([Mean("x")])
    assert len(analysis.analyzers) == 2
    table = PTable.from_numpy({"x": np.array([1.0, 2.0, 3.0])})
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        ctx = analysis.run(table, device="cpu")
    assert any(issubclass(w.category, DeprecationWarning) for w in caught)
    assert ctx.metric_map[Size()].value.get() == 3.0
    assert ctx.metric_map[Mean("x")].value.get() == 2.0


@pytest.mark.parametrize("bound", [0.5, 0.95])
def test_calculate_and_evaluate_equals_jax(bound, monkeypatch):
    """`Constraint.calculate_and_evaluate` computes the constraint's one
    metric and judges it: the same status, message and metric as the JAX
    package's, on the CPU."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    data = example_data(2000)
    jcheck = JCheck(JLevel.ERROR, "c").has_completeness("x", lambda c: c > bound)
    pcheck = PCheck(PLevel.ERROR, "c").has_completeness("x", lambda c: c > bound)
    jres = jcheck.constraints[0].inner.calculate_and_evaluate(JTable.from_numpy(data))
    pres = pcheck.constraints[0].inner.calculate_and_evaluate(PTable.from_numpy(data), device="cpu")
    assert (pres.status.value, pres.message) == (jres.status.value, jres.message)
    assert pres.metric.value.get() == jres.metric.value.get()


def test_success_metrics_as_table_equals_jax(monkeypatch):
    """`AnalyzerContext.success_metrics_as_table` and the module's
    `success_metrics_as_data_frame`: the JAX package's rows and columns
    (exact on this integer table)."""
    from deequ_tpu.runners.analysis_runner import AnalysisRunner as JRunner
    from deequ_tpu.runners.context import success_metrics_as_data_frame as jframe
    from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner as PRunner
    from deequ_tpu_torch.runners.context import success_metrics_as_data_frame as pframe

    import deequ_tpu.analyzers as J
    import deequ_tpu_torch.analyzers as P

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    cols = {"x": np.arange(30.0) % 4, "g": np.arange(30) % 3}
    spec = [("Size", ()), ("Maximum", ("x",)), ("Mean", ("x",)), ("Uniqueness", (["g"],))]
    jctx = JRunner.do_analysis_run(
        JTable.from_numpy(cols), [getattr(J, n)(*a) for n, a in spec], engine="single")
    pctx = PRunner.do_analysis_run(
        PTable.from_numpy(cols), [getattr(P, n)(*a) for n, a in spec], device="cpu")
    assert pctx.success_metrics_as_table().to_pydict() == jctx.success_metrics_as_table().to_pydict()
    assert pframe(pctx).to_pydict() == jframe(jctx).to_pydict()
