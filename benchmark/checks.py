"""A check written as data, built into the program's `Check`.

A traffic file lists its constraints as JSON objects; `build_check`
turns them into one `deequ_tpu_torch.Check`, and the references in
`benchmark/reference/` read the same list to work out, in plain numpy,
the metric and the status each constraint must give. Every constraint
has a `kind`, and as its kind needs a `column` or `columns` and an
`assert`:

    size, complete, mean, satisfies (predicate, name), non_negative,
    contained_in (values), pattern (pattern), primary_key (columns)

An `assert` is an object of bounds, all of which must hold:
`{"eq": v}`, `{"gt": v}`, `{"ge": v}`, `{"lt": v}`, `{"le": v}`; the
value "rows" stands for the table's row count. A constraint without one
holds when its metric is 1, the program's default.

A `predicate` is `{"column": c}` with any of `gt`, `ge`, `lt`, `le`,
the SQL text `c > v AND ...`.
"""

from __future__ import annotations

from typing import Callable, Optional

OPS = {"eq": lambda v, b: v == b, "gt": lambda v, b: v > b, "ge": lambda v, b: v >= b,
       "lt": lambda v, b: v < b, "le": lambda v, b: v <= b}
SQL = {"gt": ">", "ge": ">=", "lt": "<", "le": "<="}


def assertion(spec: Optional[dict], rows: int) -> Optional[Callable[[float], bool]]:
    """The assertion of an `assert` object, or None for the default."""
    if spec is None:
        return None
    bounds = [(OPS[op], rows if bound == "rows" else bound) for op, bound in spec.items()]
    return lambda value: all(test(value, bound) for test, bound in bounds)


def holds(spec: Optional[dict], value: float, rows: int) -> bool:
    """Whether a metric meets its `assert` (the references' side)."""
    if spec is None:
        return value == 1.0
    return assertion(spec, rows)(value)


def predicate_sql(predicate: dict) -> str:
    column = predicate["column"]
    return " AND ".join(f"{column} {SQL[op]} {predicate[op]}" for op in SQL if op in predicate)


def build_check(specs, rows: int, description: str = "bench"):
    """One `Check` of level ERROR with every constraint of `specs`."""
    from deequ_tpu_torch import Check, CheckLevel

    check = Check(CheckLevel.ERROR, description)
    for spec in specs:
        check = add_constraint(check, spec, rows)
    return check


def add_constraint(check, spec: dict, rows: int):
    kind = spec["kind"]
    test = assertion(spec.get("assert"), rows)
    column = spec.get("column")
    if kind == "size":
        return check.has_size(test)
    if kind == "complete":
        return check.is_complete(column)
    if kind == "mean":
        return check.has_mean(column, test)
    if kind == "satisfies":
        return check.satisfies(predicate_sql(spec["predicate"]), spec["name"], test)
    if kind == "non_negative":
        return check.is_non_negative(column)
    if kind == "contained_in":
        return check.is_contained_in(column, spec["values"])
    if kind == "pattern":
        return check.has_pattern(column, spec["pattern"], test)
    if kind == "primary_key":
        return check.is_primary_key(*spec["columns"])
    raise ValueError(f"unknown constraint kind {kind!r}")
