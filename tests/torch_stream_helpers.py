"""Shared helpers of the port's streaming tests (tests/test_torch_*.py):
the JAX package on its plain pyarrow route, Parquet writers, and metric
comparisons between the two packages."""

from __future__ import annotations

import math
import types

import numpy as np
import pytest

# the JAX package's reader fast paths, all off: its plain pyarrow route is
# the route the port implements
PLAIN_ROUTE_ENV = {
    "DEEQU_TPU_PUSHDOWN": "0",
    "DEEQU_TPU_DECODE_FASTPATH": "0",
    "DEEQU_TPU_WIRE_FUSED": "0",
    "DEEQU_TPU_NATIVE_READER": "0",
    "DEEQU_TPU_ENCODED_FOLD": "0",
    "DEEQU_TPU_PLACEMENT": "device",
}

# metrics folded as float sums: torch and XLA add in other orders
INEXACT = ("Mean", "Sum", "StandardDeviation", "Correlation", "Entropy", "MutualInformation")


def plain_route(monkeypatch) -> None:
    """Pin both packages to the pyarrow route and the device placement,
    and take the JAX package's C host library away (it sums string
    statistics in long double)."""
    from deequ_tpu.ops import native

    for key, value in PLAIN_ROUTE_ENV.items():
        monkeypatch.setenv(key, value)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)


def write_parquet(tmp_path, name: str, columns: dict, row_group_size: int) -> str:
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp_path / name)
    pq.write_table(pa.table(columns), path, row_group_size=row_group_size)
    return path


def comparable(value):
    """A metric value as plain data: a Distribution as {key: (absolute,
    ratio)} with its bin count, a keyed metric as a dict."""
    if hasattr(value, "values") and hasattr(value, "number_of_bins"):
        return (
            {k: (dv.absolute, dv.ratio) for k, dv in value.values.items()},
            value.number_of_bins,
        )
    return value


def assert_metric_equal(jm, pm, analyzer_repr: str, rtol: float = 1e-12) -> None:
    """One metric of the port against the JAX package's: the same success
    or failure, float sums within `rtol` relative, all else exact."""
    assert pm.value.is_success == jm.value.is_success, (analyzer_repr, pm.value, jm.value)
    if not jm.value.is_success:
        assert type(pm.value.exception).__name__ == type(jm.value.exception).__name__
        assert str(pm.value.exception) == str(jm.value.exception), analyzer_repr
        return
    jv, pv = comparable(jm.value.get()), comparable(pm.value.get())
    if analyzer_repr.startswith(INEXACT) and isinstance(jv, float):
        assert pv == pytest.approx(jv, rel=rtol, abs=1e-300), (analyzer_repr, pv, jv)
    else:
        assert pv == jv, (analyzer_repr, pv, jv)


def assert_contexts_equal(jctx, pctx, janalyzers, panalyzers, rtol: float = 1e-12) -> None:
    for ja, pa in zip(janalyzers, panalyzers):
        assert repr(ja) == repr(pa)
        assert_metric_equal(jctx.metric_map[ja], pctx.metric_map[pa], repr(pa), rtol)


def bits(value):
    """A value with every float as its hex form: equal bits compare equal."""
    if isinstance(value, float):
        return "nan" if math.isnan(value) else value.hex()
    if isinstance(value, np.floating):
        return bits(float(value))
    if isinstance(value, dict):
        return {k: bits(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(bits(v) for v in value)
    return value


def port_random_check(fuzz_module):
    """The JAX suite fuzzer's `random_check` over the port's Check DSL:
    the same code and the same draws, with the port's classes bound."""
    from deequ_tpu_torch.checks.check import Check, CheckLevel
    from deequ_tpu_torch.constraints.constrainable_data_types import ConstrainableDataTypes

    fn = fuzz_module.random_check
    scope = dict(fn.__globals__)
    scope.update(Check=Check, CheckLevel=CheckLevel, ConstrainableDataTypes=ConstrainableDataTypes)
    return types.FunctionType(fn.__code__, scope, fn.__name__, fn.__defaults__, fn.__closure__)


def port_table(jtable):
    """A port Table with a JAX Table's columns, types and values."""
    from deequ_tpu_torch.data.table import ColumnType, Table

    types_ = {name: ColumnType[ctype.name] for name, ctype in jtable.schema}
    return Table.from_pydict(jtable.to_pydict(), types=types_)
