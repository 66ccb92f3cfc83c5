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
