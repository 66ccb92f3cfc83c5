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


def test_where_is_not_ported_yet():
    table = PTable.from_numpy(example_data(32))
    check = PCheck(PLevel.ERROR, "filtered").has_mean("x", lambda v: v > 0).where("y > 0")
    with pytest.raises(NotImplementedError):
        PSuite.on_data(table, device="cpu").add_check(check).run()


def test_host_placement_is_not_ported_yet(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
    table = PTable.from_numpy(example_data(32))
    with pytest.raises(NotImplementedError):
        PSuite.on_data(table, device="cpu").add_check(
            PCheck(PLevel.ERROR, "c").is_complete("x")
        ).run()


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
