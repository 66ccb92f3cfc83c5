"""Each flagship analyzer, the JAX package's chain against the port's.

The same `_example_table`-shaped data, made from a seed with numpy, goes
through the JAX package's `device_reduce` -> `state_from_aggregates` ->
metric (jnp, as the fused pass runs it) and through the port's chain on
device="cpu". Size, Completeness, Minimum, Maximum and the HLL registers
and estimate must be exact; the float64 sums (Mean, Sum,
StandardDeviation, Correlation) agree within 1e-9, as they differ only
in summation order."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deequ_tpu.analyzers as J
import deequ_tpu_torch.analyzers as P
from deequ_tpu.data.table import Table as JTable
from deequ_tpu_torch.data.table import Table as PTable

EXACT = {"Size", "Completeness", "Minimum", "Maximum", "ApproxCountDistinct"}

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
    ("ApproxCountDistinct", ("cat",)),
    ("Completeness", ("cat",)),
    ("Mean", ("id",)),
]


def example_data(n_rows, seed):
    """`__graft_entry__._example_table`'s schema and generator."""
    rng = np.random.default_rng(seed)
    x = rng.normal(3.0, 2.0, n_rows)
    y = 0.5 * x + rng.normal(0.0, 1.0, n_rows)
    x[::11] = np.nan
    ids = rng.integers(0, n_rows, n_rows)
    cats = np.array(["ok", "warn", "err", "skip", None], dtype=object)
    cat = cats[rng.integers(0, len(cats), n_rows)]
    grp = rng.integers(0, 5, n_rows)
    return {"x": x, "y": y, "id": ids, "cat": cat, "grp": grp}


def jax_state(analyzer, table):
    inputs = {}
    for spec in analyzer.input_specs():
        arr = np.asarray(spec.build(table))
        if arr.dtype.kind == "f":
            arr = arr.astype(np.float64)
        inputs[spec.key] = jnp.asarray(arr)
    agg = analyzer.device_reduce(inputs, jnp)
    agg = {k: np.asarray(v, dtype=np.float64) for k, v in agg.items()}
    return analyzer.state_from_aggregates(agg)


def port_state(analyzer, table):
    inputs = {
        spec.key: torch.from_numpy(np.asarray(spec.build(table)))
        for spec in analyzer.input_specs()
    }
    agg = analyzer.device_reduce(inputs)
    agg = {k: v.to(torch.float64).numpy() for k, v in agg.items()}
    return analyzer.state_from_aggregates(agg)


@pytest.mark.parametrize("n_rows,seed", [(1024, 7), (2500, 11)])
@pytest.mark.parametrize("name,args", FLAGSHIP, ids=lambda v: str(v))
def test_analyzer_matches_reference(monkeypatch, name, args, n_rows, seed):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    data = example_data(n_rows, seed)
    ja, pa = getattr(J, name)(*args), getattr(P, name)(*args)
    assert repr(ja) == repr(pa)
    js = jax_state(ja, JTable.from_numpy(data))
    ps = port_state(pa, PTable.from_numpy(data))
    if name == "ApproxCountDistinct":
        np.testing.assert_array_equal(ps.registers, js.registers)
    jm, pm = ja.compute_metric_from(js), pa.compute_metric_from(ps)
    assert (jm.entity.value, jm.name, jm.instance) == (pm.entity.value, pm.name, pm.instance)
    jv, pv = jm.value.get(), pm.value.get()
    if name in EXACT:
        assert pv == jv
    else:
        np.testing.assert_allclose(pv, jv, rtol=1e-9)


@pytest.mark.parametrize("name,args", [("Mean", ("x",)), ("StandardDeviation", ("x",)),
                                       ("Correlation", ("x", "y")), ("Completeness", ("x",))])
def test_all_null_batch_gives_the_same_empty_state(name, args):
    data = example_data(64, 3)
    data["x"] = np.full(64, np.nan)
    ja, pa = getattr(J, name)(*args), getattr(P, name)(*args)
    js = jax_state(ja, JTable.from_numpy(data))
    ps = port_state(pa, PTable.from_numpy(data))
    jm, pm = ja.compute_metric_from(js), pa.compute_metric_from(ps)
    assert jm.value.is_success == pm.value.is_success
    if jm.value.is_success:
        assert pm.value.get() == jm.value.get()
    else:
        assert str(pm.value.exception) == str(jm.value.exception)


def test_moment_family_shares_one_moments_result():
    data = example_data(512, 5)
    table = PTable.from_numpy(data)
    members = [P.Mean("x"), P.Sum("x"), P.Minimum("x"), P.Maximum("x"), P.StandardDeviation("x")]
    inputs = {}
    for a in members:
        for spec in a.input_specs():
            inputs.setdefault(spec.key, torch.from_numpy(np.asarray(spec.build(table))))
    first = None
    for a in members:
        a.device_reduce(inputs)
        memo = inputs["__moments:x:where:<all>"]
        first = memo if first is None else first
        assert memo is first


# -- Analyzer.calculate on the scan-shareable analyzers -----------------------


def _port_table(jtable):
    """A port Table with the JAX fixture's columns, types and values."""
    from deequ_tpu_torch.data.table import ColumnType

    types = {name: ColumnType[ctype.name] for name, ctype in jtable.schema}
    return PTable.from_pydict(jtable.to_pydict(), types=types)


CALCULATE_CASES = [
    ("get_df_full", lambda m: m.Size()),
    ("get_df_missing", lambda m: m.Size()),
    ("get_df_with_numeric_values", lambda m: m.Size(where="att1 > 3")),
    ("get_df_missing", lambda m: m.Completeness("att1")),
    ("get_df_missing", lambda m: m.Completeness("att2")),
    ("get_df_full", lambda m: m.Completeness("att1")),
    ("get_df_full", lambda m: m.Completeness("nope")),
    ("get_df_with_numeric_values", lambda m: m.Mean("att1")),
    ("get_df_with_numeric_values", lambda m: m.Mean("att1", where="att2 = 0")),
    ("get_df_full", lambda m: m.Mean("att1")),
    ("get_df_full", lambda m: m.ApproxCountDistinct("att1")),
    ("get_df_full", lambda m: m.ApproxCountDistinct("item")),
    ("get_df_missing", lambda m: m.ApproxCountDistinct("att2")),
    ("get_full_nulls", lambda m: m.Completeness("att1")),
]


@pytest.mark.parametrize(
    "fixture,make", CALCULATE_CASES, ids=[f"{f}-{i}" for i, (f, _m) in enumerate(CALCULATE_CASES)]
)
def test_calculate_equals_jax(monkeypatch, fixture, make):
    """`calculate` runs a one-analyzer fused pass, as the JAX package's
    does (it failed on every scan-shareable analyzer before): the same
    metric, or the same failure, on the shared toy fixtures."""
    import fixtures

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    jtable = getattr(fixtures, fixture)()
    jm = make(J).calculate(jtable)
    pm = make(P).calculate(_port_table(jtable), device="cpu")
    assert (pm.entity.value, pm.name, pm.instance) == (jm.entity.value, jm.name, jm.instance)
    assert pm.value.is_success == jm.value.is_success, (pm.value, jm.value)
    if jm.value.is_success:
        assert pm.value.get() == jm.value.get()
    else:
        assert type(pm.value.exception).__name__ == type(jm.value.exception).__name__
        assert str(pm.value.exception) == str(jm.value.exception)


def test_size_calculate_defaults_to_cuda():
    """With no device, `calculate` resolves CUDA as the runners do: it
    raises where no CUDA device is present, and never moves to the CPU."""
    import fixtures

    table = _port_table(fixtures.get_df_full())
    if torch.cuda.is_available():
        assert P.Size().calculate(table).value.get() == 4.0
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            P.Size().calculate(table)
