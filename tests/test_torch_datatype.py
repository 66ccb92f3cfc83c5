"""DataType, has_data_type, has_histogram_values, numeric parsing of
string columns and the Table transforms of the profiler's slice: the
port on device="cpu" against the JAX package on the same seeded data.

Tolerance: none. Class counts, distributions, parsed values, splits and
check statuses and messages must be equal."""

from __future__ import annotations

import numpy as np
import pytest

from deequ_tpu.analyzers.scan import DataType as JDataType
from deequ_tpu.analyzers.scan import determine_type as j_determine_type
from deequ_tpu.checks.check import Check as JCheck
from deequ_tpu.checks.check import CheckLevel as JLevel
from deequ_tpu.constraints.constrainable_data_types import ConstrainableDataTypes as JTypes
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops import strings as jstrings
from deequ_tpu.ops.fused import FusedScanPass as JPass
from deequ_tpu.verification.suite import VerificationSuite as JSuite
from deequ_tpu_torch import Check as PCheck
from deequ_tpu_torch import CheckLevel as PLevel
from deequ_tpu_torch import ConstrainableDataTypes as PTypes
from deequ_tpu_torch import Table as PTable
from deequ_tpu_torch import VerificationSuite as PSuite
from deequ_tpu_torch.analyzers import DataType as PDataType
from deequ_tpu_torch.analyzers.scan import determine_type as p_determine_type
from deequ_tpu_torch.ops import strings as pstrings
from deequ_tpu_torch.ops.fused import FusedScanPass as PPass

VALUES = np.array(
    ["1", "-2", "+ 3", "4.5", "-.5", ".", "true", "false", "True", "abc", "", "12a",
     "1.2.3", "7\n", "8\r\n", " 5", "5 ", "x" * 200, "9" * 140, "1e5", "inf", "nan"],
    dtype=object,
)


@pytest.fixture(autouse=True)
def _device_placement(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


def mixed_columns(n=3000, seed=3):
    """A string column drawn from VALUES with nulls, and typed columns."""
    rng = np.random.default_rng(seed)
    s = VALUES[rng.integers(0, len(VALUES), n)].copy()
    s[rng.random(n) < 0.1] = None
    ints = rng.integers(-5, 5, n)
    return {
        "s": s,
        "digits": np.array([str(v) for v in ints], dtype=object),
        "i": ints,
        "f": rng.normal(0.0, 1.0, n),
        "b": rng.random(n) < 0.5,
        "g": rng.integers(0, 3, n),
    }


def test_classify_equals_jax():
    rng = np.random.default_rng(0)
    alphabet = np.array(list("0123456789.+- etrufalsx\n\r"), dtype=object)
    drawn = ["".join(rng.choice(alphabet, rng.integers(0, 9))) for _ in range(4000)]
    values = np.concatenate([VALUES, np.array(drawn, dtype=object)])
    assert np.array_equal(pstrings.classify(values), jstrings.classify(values))


@pytest.mark.parametrize("column", ["s", "digits", "i", "f", "b"])
@pytest.mark.parametrize("where", [None, "g >= 1"])
@pytest.mark.parametrize("batch_size", [3000, 700], ids=["one", "five"])
def test_data_type_equals_jax(column, where, batch_size):
    cols = mixed_columns()
    jstate = JPass([JDataType(column, where)], batch_size=batch_size).run(
        JTable.from_numpy(cols)
    )[0].state_or_raise()
    pstate = PPass([PDataType(column, where)], batch_size=batch_size, device="cpu").run(
        PTable.from_numpy(cols)
    )[0].state_or_raise()
    assert pstate.__dict__ == jstate.__dict__
    jm = JDataType(column, where).compute_metric_from(jstate).value.get()
    pm = PDataType(column, where).compute_metric_from(pstate).value.get()
    assert repr(pm.values) == repr(jm.values)
    assert p_determine_type(pm) == j_determine_type(jm)


def test_data_type_repr_and_name():
    assert repr(PDataType("s", "g > 1")) == repr(JDataType("s", "g > 1"))
    assert PDataType("s").name == JDataType("s").name == "Histogram"


def test_data_type_of_a_missing_column_fails_alike():
    cols = mixed_columns(50)
    check = ("has_data_type", "nope", "NUMERIC")
    jres, pres = run_both(cols, [check])
    assert pres == jres
    assert pres[0][0] == "Failure"


def run_both(cols, calls):
    """Each call (method, *args) on a JAX and a port check; -> the
    (status, message) of every constraint, per package."""

    def build(check, types):
        for method, *args in calls:
            args = [getattr(types, a) if a in types.__members__ else a for a in args]
            check = getattr(check, method)(*args)
        return check

    jres = JSuite.on_data(JTable.from_numpy(cols)).add_check(
        build(JCheck(JLevel.ERROR, "types"), JTypes)
    ).run()
    pres = PSuite.on_data(PTable.from_numpy(cols), device="cpu").add_check(
        build(PCheck(PLevel.ERROR, "types"), PTypes)
    ).run()

    def verdicts(result):
        return [
            (cr.status.value, cr.message)
            for r in result.check_results.values()
            for cr in r.constraint_results
        ]

    return verdicts(jres), verdicts(pres)


@pytest.mark.parametrize("kind", [t.name for t in PTypes])
@pytest.mark.parametrize("column", ["s", "digits", "i", "f", "b"])
def test_has_data_type_equals_jax(kind, column):
    cols = mixed_columns(800, seed=9)
    # is_one (the default), and an assertion that shows the picked ratio
    jres, pres = run_both(
        cols,
        [("has_data_type", column, kind), ("has_data_type", column, kind, lambda r: r < 0.0)],
    )
    assert pres == jres and len(pres) == 2


def test_constrainable_data_types_match():
    assert [(t.name, t.value) for t in PTypes] == [(t.name, t.value) for t in JTypes]


@pytest.mark.parametrize("column", ["s", "b", "g"])
def test_has_histogram_values_equals_jax(column):
    cols = mixed_columns(600, seed=4)

    def top_share(dist):
        return max(v.ratio for v in dist.values.values()) < 0.5

    jres, pres = run_both(
        cols,
        [
            ("has_histogram_values", column, top_share),
            ("has_histogram_values", column, lambda d: d.number_of_bins > 3),
            ("has_histogram_values", column, lambda d: d["NullValue"].absolute > 0),
        ],
    )
    assert pres == jres


@pytest.mark.parametrize("column", ["s", "digits"])
def test_numeric_values_of_strings_equal_jax(column):
    cols = mixed_columns(2000, seed=5)
    jvals, jvalid = JTable.from_numpy(cols).column(column).numeric_values()
    ptable = PTable.from_numpy(cols)
    pvals, pvalid = ptable.column(column).numeric_values()
    assert np.array_equal(pvalid, jvalid)
    assert pvals.tobytes() == np.asarray(jvals, dtype=np.float64).tobytes()
    # a batch slice reads the table's parse
    sliced = ptable.slice(100, 900).column(column).numeric_values()
    assert np.array_equal(sliced[0], pvals[100:900]) and np.array_equal(sliced[1], pvalid[100:900])


@pytest.mark.parametrize("weights", [[0.9, 0.1], [0.5, 0.3, 0.2]])
@pytest.mark.parametrize("seed", [0, 7, None])
def test_random_split_equals_jax(weights, seed):
    cols = mixed_columns(1500, seed=6)
    if seed is None:  # an unseeded split is random: only the shape is compared
        parts = PTable.from_numpy(cols).random_split(weights)
        assert sum(p.num_rows for p in parts) == 1500 and len(parts) == len(weights)
        return
    jparts = JTable.from_numpy(cols).random_split(weights, seed=seed)
    pparts = PTable.from_numpy(cols).random_split(weights, seed=seed)
    assert [p.to_pydict() for p in pparts] == [p.to_pydict() for p in jparts]


def test_pydict_round_trip_equals_jax():
    d = {
        "a": [1, None, 3],
        "b": ["x", None, "1.5"],
        "c": [1.5, None, float("nan")],
        "t": [True, None, False],
        "e": [None, None, None],
    }
    assert PTable.from_pydict(d).to_pydict() == JTable.from_pydict(d).to_pydict()
    assert [(n, t.value) for n, t in PTable.from_pydict(d).schema] == [
        (n, t.value) for n, t in JTable.from_pydict(d).schema
    ]


def test_filter_select_with_column_equal_jax():
    cols = mixed_columns(300, seed=8)
    mask = np.arange(300) % 3 == 0
    jt, pt = JTable.from_numpy(cols), PTable.from_numpy(cols)
    assert pt.filter(mask).to_pydict() == jt.filter(mask).to_pydict()
    assert pt.select(["b", "s"]).to_pydict() == jt.select(["b", "s"]).to_pydict()
    jcol, pcol = jt.column("f"), pt.column("f")
    renamed_j = type(jcol)("s", jcol.ctype, jcol.values, jcol.valid)
    renamed_p = type(pcol)("s", pcol.ctype, pcol.values, pcol.valid)
    assert pt.with_column(renamed_p).to_pydict() == jt.with_column(renamed_j).to_pydict()
    assert pt.with_column(renamed_p).column_names == jt.with_column(renamed_j).column_names
