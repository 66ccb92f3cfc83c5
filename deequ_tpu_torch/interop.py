"""Carry a JAX-package state across into the port.

`state_from_reference(kind, fields)` turns the fields of a `deequ_tpu`
state — given as plain numpy arrays, lists and numbers, so the port
imports nothing of that package — into the port's state of the same
kind. Both packages then merge and finish the same states: a run can
continue from a state the JAX package computed.

The dataclass states carry their own fields. Two states are not
dataclasses and take these fields:

  ApproxQuantileState    k, n, levels (the KLL sketch's `to_arrays()`),
                         and optionally rng_state (its `rng_state_bytes()`:
                         without it the sketch's next merges draw other
                         compaction offsets than the JAX package's would)
  FrequenciesAndNumRows  columns, key_columns, counts, num_rows

The profiler's two internal states take their own fields, with
OptimisticNumericState's `digest` given as None or as the KLL sketch's
(k, n, levels).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np

from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows
from deequ_tpu_torch.analyzers.sketch import ApproxCountDistinctState, ApproxQuantileState
from deequ_tpu_torch.analyzers.states import (
    CorrelationState,
    DataTypeHistogram,
    MaxState,
    MeanState,
    MinState,
    NumMatches,
    NumMatchesAndCount,
    StandardDeviationState,
    State,
    SumState,
)
from deequ_tpu_torch.ops.sketches.kll import KLLSketch
from deequ_tpu_torch.profiles.internal_analyzers import (
    LowCardCountsState,
    OptimisticNumericState,
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
        DataTypeHistogram,
    )
}


def _quantile_state(k, n, levels, rng_state=None) -> ApproxQuantileState:
    sketch = KLLSketch.from_arrays(int(k), int(n), list(levels))
    if rng_state is not None:
        sketch.set_rng_state_bytes(bytes(rng_state))
    return ApproxQuantileState(sketch)


def _frequencies(columns, key_columns, counts, num_rows) -> FrequenciesAndNumRows:
    return FrequenciesAndNumRows(columns, list(key_columns), counts, int(num_rows))


def _low_card_counts(counts, null_count, aborted, cap) -> LowCardCountsState:
    return LowCardCountsState(
        tuple((value, int(count)) for value, count in counts),
        int(null_count),
        bool(aborted),
        int(cap),
    )


def _optimistic_numeric(n, total, minimum, maximum, m2, digest, dead) -> OptimisticNumericState:
    sketch = None if digest is None else _quantile_state(*digest).digest
    return OptimisticNumericState(
        float(n), float(total), float(minimum), float(maximum), float(m2), sketch, bool(dead)
    )


# kind -> (field names, optional field names, constructor) for the states
# that are not dataclasses of plain numbers
OTHER_KINDS: Dict[str, tuple] = {
    "ApproxQuantileState": (("k", "n", "levels"), ("rng_state",), _quantile_state),
    "FrequenciesAndNumRows": (
        ("columns", "key_columns", "counts", "num_rows"),
        (),
        _frequencies,
    ),
    "LowCardCountsState": (("counts", "null_count", "aborted", "cap"), (), _low_card_counts),
    "OptimisticNumericState": (
        ("n", "total", "minimum", "maximum", "m2", "digest", "dead"),
        (),
        _optimistic_numeric,
    ),
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
    field values `fields` (name -> numpy array, list or number)."""
    if kind in OTHER_KINDS:
        names, optional, build = OTHER_KINDS[kind]
        if not set(names) <= set(fields) <= set(names) | set(optional):
            raise ValueError(f"{kind} has fields {sorted(names)}, got {sorted(fields)}")
        return build(**fields)
    cls = STATE_KINDS.get(kind)
    if cls is None:
        known = sorted(set(STATE_KINDS) | set(OTHER_KINDS))
        raise ValueError(f"unknown state kind {kind!r}; expected one of {known}")
    declared = {f.name: f for f in dataclasses.fields(cls)}
    if set(fields) != set(declared):
        raise ValueError(
            f"{kind} has fields {sorted(declared)}, got {sorted(fields)}"
        )
    return cls(**{name: _convert(declared[name], value) for name, value in fields.items()})
