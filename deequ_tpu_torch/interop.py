"""Carry a JAX-package state across into the port.

`state_from_reference(kind, fields)` turns the fields of a `deequ_tpu`
state — given as plain numpy arrays and numbers, so the port imports
nothing of that package — into the port's state of the same kind. Both
packages then merge and finish the same states: a run can continue from
a state the JAX package computed.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from deequ_tpu_torch.analyzers.sketch import ApproxCountDistinctState
from deequ_tpu_torch.analyzers.states import (
    CorrelationState,
    MaxState,
    MeanState,
    MinState,
    NumMatches,
    NumMatchesAndCount,
    StandardDeviationState,
    State,
    SumState,
)

STATE_KINDS = {
    cls.__name__: cls
    for cls in (
        NumMatches,
        NumMatchesAndCount,
        MeanState,
        SumState,
        MinState,
        MaxState,
        StandardDeviationState,
        CorrelationState,
        ApproxCountDistinctState,
    )
}


def _convert(field: dataclasses.Field, value: Any):
    kind = field.type if isinstance(field.type, str) else field.type.__name__
    if kind == "int":
        return int(value)
    if kind == "float":
        return float(value)
    # the HLL registers: 512 int32, as the reference stores them
    return np.asarray(value).astype(np.int32)


def state_from_reference(kind: str, fields: Dict[str, Any]) -> State:
    """The port's state for a JAX-package state of class name `kind` with
    field values `fields` (name -> numpy array or number)."""
    cls = STATE_KINDS.get(kind)
    if cls is None:
        raise ValueError(f"unknown state kind {kind!r}; expected one of {sorted(STATE_KINDS)}")
    declared = {f.name: f for f in dataclasses.fields(cls)}
    if set(fields) != set(declared):
        raise ValueError(
            f"{kind} has fields {sorted(declared)}, got {sorted(fields)}"
        )
    return cls(**{name: _convert(declared[name], value) for name, value in fields.items()})
