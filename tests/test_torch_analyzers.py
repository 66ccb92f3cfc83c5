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
