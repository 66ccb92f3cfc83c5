"""States carried across from the JAX package: the JAX package's state of
the first half of a table, carried into the port and merged with the
port's state of the second half, gives the full table's metric."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest

import deequ_tpu.analyzers as J
import deequ_tpu_torch.analyzers as P
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.ops.fused import FusedScanPass as JPass
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.interop import state_from_reference
from deequ_tpu_torch.ops.fused import FusedScanPass as PPass

FLAGSHIP = [
    ("Size", ()),
    ("Completeness", ("x",)),
    ("Mean", ("x",)),
    ("Minimum", ("x",)),
    ("Maximum", ("x",)),
    ("Sum", ("x",)),
    ("StandardDeviation", ("x",)),
    ("Correlation", ("x", "y")),
    ("ApproxCountDistinct", ("id",)),
]
EXACT = {"Size", "Completeness", "Minimum", "Maximum", "ApproxCountDistinct"}


def halves(n_rows=2000, seed=13):
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, n_rows)
    y = 0.5 * x + rng.normal(0.0, 1.0, n_rows)
    x[::11] = np.nan
    ids = rng.integers(0, n_rows, n_rows)
    data = {"x": x, "y": y, "id": ids}
    half = n_rows // 2
    first = {k: v[:half] for k, v in data.items()}
    second = {k: v[half:] for k, v in data.items()}
    return data, first, second


def carried(state):
    fields = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    return state_from_reference(type(state).__name__, fields)


@pytest.mark.parametrize("name,args", FLAGSHIP, ids=[n for n, _ in FLAGSHIP])
def test_reference_state_merges_with_port_state(monkeypatch, name, args):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    data, first, second = halves()
    ja, pa = getattr(J, name)(*args), getattr(P, name)(*args)
    jstate = JPass([ja]).run(JTable.from_numpy(first))[0].state_or_raise()
    pstate = PPass([pa], device="cpu").run(PTable.from_numpy(second))[0].state_or_raise()
    merged = carried(jstate).merge(pstate)
    whole = PPass([pa], device="cpu").run(PTable.from_numpy(data))[0].state_or_raise()
    got = pa.compute_metric_from(merged).value.get()
    want = pa.compute_metric_from(whole).value.get()
    if name in EXACT:
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-9)
    jwhole = ja.compute_metric_from(JPass([ja]).run(JTable.from_numpy(data))[0].state_or_raise())
    np.testing.assert_allclose(got, jwhole.value.get(), rtol=1e-9)


def test_unknown_kind_or_fields_raise():
    with pytest.raises(ValueError):
        state_from_reference("DataTypeHistogram", {})
    with pytest.raises(ValueError):
        state_from_reference("MeanState", {"total": 1.0})


def test_registers_become_int32():
    regs = np.arange(512, dtype=np.int64) % 7
    state = state_from_reference("ApproxCountDistinctState", {"registers": regs})
    assert state.registers.dtype == np.int32
    np.testing.assert_array_equal(state.registers, regs)



def _quantile_fields(state):
    k, n, levels = state.digest.to_arrays()
    return {
        "k": k, "n": n, "levels": [np.array(lv) for lv in levels],
        "rng_state": state.digest.rng_state_bytes(),
    }


@pytest.mark.parametrize(
    "jan,pan",
    [
        (J.ApproxQuantile("x", 0.5), P.ApproxQuantile("x", 0.5)),
        (J.ApproxQuantiles("x", [0.1, 0.9], 0.1), P.ApproxQuantiles("x", [0.1, 0.9], 0.1)),
    ],
    ids=["ApproxQuantile", "ApproxQuantiles"],
)
def test_quantile_state_carries_across(monkeypatch, jan, pan):
    """The JAX package's sketch, carried across, is the port's sketch of
    the same rows and gives the same metric; merged with the port's sketch
    of the other half, a metric within the sketch's rank error."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    data, first, second = halves()
    jstate = JPass([jan]).run(JTable.from_numpy(first))[0].state_or_raise()
    port_state = state_from_reference("ApproxQuantileState", _quantile_fields(jstate))
    own = PPass([pan], device="cpu").run(PTable.from_numpy(first))[0].state_or_raise()
    assert port_state == own
    assert pan.compute_metric_from(port_state) == pan.compute_metric_from(own)
    assert pan.compute_metric_from(port_state).value.get() == jan.compute_metric_from(jstate).value.get()

    pstate = PPass([pan], device="cpu").run(PTable.from_numpy(second))[0].state_or_raise()
    merged = port_state.merge(pstate)
    x = np.sort(data["x"][~np.isnan(data["x"])])
    assert merged.digest.n == len(x)
    value = pan.compute_metric_from(merged).value.get()
    pairs = [(jan.quantile, value)] if isinstance(value, float) else [
        (float(q), v) for q, v in value.items()
    ]
    for q, got in pairs:
        assert abs(np.searchsorted(x, got) - q * len(x)) <= 2 * pan.relative_error * len(x)


@pytest.mark.parametrize(
    "jan,pan",
    [
        (J.Compliance("rule", "x > 3"), P.Compliance("rule", "x > 3")),
        (J.Compliance("rule", "x > 3", "y > 0"), P.Compliance("rule", "x > 3", "y > 0")),
    ],
    ids=["Compliance", "Compliance-where"],
)
def test_ratio_state_carries_across(monkeypatch, jan, pan):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    data, first, second = halves()
    jstate = JPass([jan]).run(JTable.from_numpy(first))[0].state_or_raise()
    pstate = PPass([pan], device="cpu").run(PTable.from_numpy(second))[0].state_or_raise()
    merged = carried(jstate).merge(pstate)
    whole = PPass([pan], device="cpu").run(PTable.from_numpy(data))[0].state_or_raise()
    assert merged == whole
    assert pan.compute_metric_from(merged) == pan.compute_metric_from(whole)


def test_pattern_state_carries_across(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    rng = np.random.default_rng(3)
    words = np.array(["ok", "warn", "err", None], dtype=object)[rng.integers(0, 4, 400)]
    jan, pan = J.PatternMatch("w", r"^w"), P.PatternMatch("w", r"^w")
    jstate = JPass([jan]).run(JTable.from_numpy({"w": words[:200]}))[0].state_or_raise()
    pstate = PPass([pan], device="cpu").run(PTable.from_numpy({"w": words[200:]}))[0].state_or_raise()
    whole = PPass([pan], device="cpu").run(PTable.from_numpy({"w": words}))[0].state_or_raise()
    assert carried(jstate).merge(pstate) == whole


@pytest.mark.parametrize("columns", [["id"], ["id", "g"]], ids=["id", "id+g"])
def test_frequencies_carry_across(columns):
    from deequ_tpu.analyzers.frequency import compute_frequencies as jfreq
    from deequ_tpu_torch.analyzers.frequency import compute_frequencies as pfreq

    data, first, second = halves()
    for part in (data, first, second):
        part["g"] = part["id"] % 3
    jstate = jfreq(JTable.from_numpy(first), columns)
    fields = {
        "columns": jstate.columns, "key_columns": jstate.key_columns,
        "counts": jstate.counts, "num_rows": jstate.num_rows,
    }
    merged = state_from_reference("FrequenciesAndNumRows", fields).merge(
        pfreq(PTable.from_numpy(second), columns)
    )
    assert merged == pfreq(PTable.from_numpy(data), columns)
    jwhole = jfreq(JTable.from_numpy(data), columns)
    for name in ("Uniqueness", "Distinctness", "CountDistinct", "UniqueValueRatio", "Entropy"):
        if name == "Entropy" and len(columns) > 1:
            continue
        args = columns[0] if name == "Entropy" else columns
        got = getattr(P, name)(args).compute_metric_from(merged).value.get()
        want = getattr(J, name)(args).compute_metric_from(jwhole).value.get()
        assert abs(got - want) <= 1e-12 * max(1.0, abs(want)), name


# every kind `state_from_reference` takes that has a serde layout, with an
# analyzer whose state it is (LowCardCountsState and OptimisticNumericState,
# the profiler's internal states, have none)
SERDE_KINDS = {
    "NumMatches": ("Size", ()),
    "NumMatchesAndCount": ("Completeness", ("x",)),
    "MeanState": ("Mean", ("x",)),
    "SumState": ("Sum", ("x",)),
    "MinState": ("Minimum", ("x",)),
    "MaxState": ("Maximum", ("x",)),
    "StandardDeviationState": ("StandardDeviation", ("x",)),
    "CorrelationState": ("Correlation", ("x", "y")),
    "ApproxCountDistinctState": ("ApproxCountDistinct", ("id",)),
    "DataTypeHistogram": ("DataType", ("s",)),
    "ApproxQuantileState": ("ApproxQuantile", ("x", 0.5)),
    "FrequenciesAndNumRows": ("CountDistinct", (["id", "g"],)),
}


def test_serde_kinds_cover_every_kind_with_a_layout():
    from deequ_tpu_torch.interop import OTHER_KINDS, STATE_KINDS

    internal = {"LowCardCountsState", "OptimisticNumericState"}
    assert set(SERDE_KINDS) == (set(STATE_KINDS) | set(OTHER_KINDS)) - internal


@pytest.mark.parametrize("kind", sorted(SERDE_KINDS))
def test_state_file_and_memory_routes_give_the_same_port_state(monkeypatch, tmp_path, kind):
    """A JAX-package state reaches the port two ways: in memory through
    `state_from_reference`, and as a state file the JAX package wrote
    (its FileSystemStateProvider) that the port's provider reads. Both
    give the same port state, byte for byte in the port's serde."""
    from deequ_tpu.analyzers.frequency import compute_frequencies as jfreq
    from deequ_tpu.analyzers.state_provider import FileSystemStateProvider as JProvider
    from deequ_tpu_torch.analyzers.state_provider import FileSystemStateProvider as PProvider
    from deequ_tpu_torch.analyzers.state_provider import serialize_state

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    data, first, _second = halves()
    first["g"] = first["id"] % 3
    first["s"] = np.array(["1", "2.5", "w", None], dtype=object)[first["id"] % 4]
    name, args = SERDE_KINDS[kind]
    jan, pan = getattr(J, name)(*args), getattr(P, name)(*args)
    if kind == "FrequenciesAndNumRows":
        jstate = jfreq(JTable.from_numpy(first), list(args[0]))
        fields = {
            "columns": jstate.columns, "key_columns": jstate.key_columns,
            "counts": jstate.counts, "num_rows": jstate.num_rows,
        }
    else:
        jstate = JPass([jan]).run(JTable.from_numpy(first))[0].state_or_raise()
        fields = (
            _quantile_fields(jstate)
            if kind == "ApproxQuantileState"
            else {f.name: getattr(jstate, f.name) for f in dataclasses.fields(jstate)}
        )
    assert type(jstate).__name__ == kind
    in_memory = state_from_reference(kind, fields)
    prefix = str(tmp_path / "states")
    JProvider(prefix).persist(jan, jstate)
    from_file = PProvider(prefix).load(pan)
    assert type(from_file) is type(in_memory)
    assert serialize_state(pan, from_file) == serialize_state(pan, in_memory)
    assert repr(pan.compute_metric_from(from_file)) == repr(pan.compute_metric_from(in_memory))
