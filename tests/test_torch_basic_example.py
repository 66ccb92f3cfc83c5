"""The README's canonical example (examples/basic_example.py) through both
packages on the CPU: the same statuses, constraint names and messages,
and the same metrics (floats within 1e-12). The expected outcome is
BASELINE.md's: the ERROR check fails on Completeness(name) = 0.8, the
WARNING check on containsURL(description) = 0.4."""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

from deequ_tpu import Check as JCheck
from deequ_tpu import CheckLevel as JLevel
from deequ_tpu import VerificationSuite as JSuite
from deequ_tpu.data.table import Table as JTable
from deequ_tpu_torch import Check as PCheck
from deequ_tpu_torch import CheckLevel as PLevel
from deequ_tpu_torch import Table as PTable
from deequ_tpu_torch import VerificationSuite as PSuite
from deequ_tpu_torch.ops import cuda_kernels as ck

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples"))
from example_utils import Item  # noqa: E402

ITEMS = [
    Item(1, "Thingy A", "awesome thing.", "high", 0),
    Item(2, "Thingy B", "available at http://thingb.com", None, 0),
    Item(3, None, None, "low", 5),
    Item(4, "Thingy D", "checkout https://thingd.ca", "low", 10),
    Item(5, "Thingy E", None, "high", 12),
]


def columns():
    return {
        "id": np.array([it.id for it in ITEMS], dtype=np.int64),
        "name": np.array([it.name for it in ITEMS], dtype=object),
        "description": np.array([it.description for it in ITEMS], dtype=object),
        "priority": np.array([it.priority for it in ITEMS], dtype=object),
        "numViews": np.array([it.numViews for it in ITEMS], dtype=np.int64),
    }


def checks(check_cls, level):
    return [
        check_cls(level.ERROR, "integrity checks")
        .has_size(lambda size: size == 5)
        .is_complete("id")
        .is_unique("id")
        .is_complete("name")
        .is_contained_in("priority", ["high", "low"])
        .is_non_negative("numViews"),
        check_cls(level.WARNING, "distribution checks")
        .contains_url("description", lambda ratio: ratio >= 0.5)
        .has_approx_quantile("numViews", 0.5, lambda median: median <= 10),
    ]


@pytest.fixture(scope="module")
def results():
    jres = JSuite().on_data(JTable.from_numpy(columns())).add_checks(checks(JCheck, JLevel)).run()
    ck.reset_launch_counts()
    pres = (
        PSuite().on_data(PTable.from_numpy(columns()), device="cpu")
        .add_checks(checks(PCheck, PLevel))
        .run()
    )
    assert not any(ck.launch_counts().values())
    return jres, pres


def test_statuses_and_messages_equal_jax(results):
    jres, pres = results
    assert pres.status.value == jres.status.value == "Error"
    assert pres.check_results_as_rows() == jres.check_results_as_rows()


def test_metrics_equal_jax(results):
    jres, pres = results
    jm = {repr(a): m.value.get() for a, m in jres.metrics.items()}
    pm = {repr(a): m.value.get() for a, m in pres.metrics.items()}
    assert sorted(pm) == sorted(jm)
    for key, value in jm.items():
        assert abs(pm[key] - value) <= 1e-12, key


def test_baseline_outcome(results):
    _, pres = results
    failed = {
        repr(cr.constraint): cr.message
        for res in pres.check_results.values()
        for cr in res.constraint_results
        if cr.status.value == "Failure"
    }
    assert failed == {
        "CompletenessConstraint(Completeness(name,None))":
            "Value: 0.8 does not meet the constraint requirement!",
        "containsURL(description)": "Value: 0.4 does not meet the constraint requirement!",
    }
    metrics = {repr(a): m.value.get() for a, m in pres.metrics.items()}
    assert metrics["Size(None)"] == 5
    assert metrics["Uniqueness(List(id))"] == 1.0 and metrics["Completeness(id,None)"] == 1.0
    assert metrics["ApproxQuantile(numViews,0.5,0.01)"] <= 10
