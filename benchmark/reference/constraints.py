"""The metric and the status of each constraint of a check written as
data (benchmark/checks.py), in plain numpy over the generator's columns.

The semantics are those of chip_smoke.py's numpy references (:760
`numpy_reference`, :780 `numpy_slice2_reference`): NULL is NaN or the
NULL code; a ratio is over all rows, NULL rows included; a pattern or a
predicate is false on NULL, a containment true; uniqueness counts the
rows whose key occurs once.

`Columns` holds the columns as the generator made them: numeric arrays
(NaN is NULL), string columns as codes into a dictionary, where the
code `len(dictionary)` is NULL, and the names of text columns without
NULLs, which only completeness reads. Metric keys are the program's
`Name(instance)`; statuses are `status[i]`, numbered over the checks'
constraints in order.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

from benchmark.checks import holds
from benchmark.reference import plain

@dataclass
class Columns:
    n: int
    numeric: Dict[str, np.ndarray] = field(default_factory=dict)
    strings: Dict[str, Tuple[np.ndarray, Sequence[str]]] = field(default_factory=dict)
    texts: Tuple[str, ...] = ()

    def values(self, column: str, dtype) -> np.ndarray:
        """A numeric column's non-null values, floats in `dtype`."""
        v = self.numeric[column]
        if v.dtype.kind == "f":
            v = v[~np.isnan(v)].astype(dtype, copy=False)
        return v

    def present(self, column: str) -> np.ndarray:
        if column in self.numeric:
            v = self.numeric[column]
            return ~np.isnan(v) if v.dtype.kind == "f" else np.ones(self.n, dtype=bool)
        if column in self.texts:
            return np.ones(self.n, dtype=bool)
        codes, dictionary = self.strings[column]
        return codes != len(dictionary)

    def string_counts(self, column: str) -> Tuple[np.ndarray, Sequence[str]]:
        """Rows per dictionary entry (NULL left out), and the dictionary."""
        codes, dictionary = self.strings[column]
        return np.bincount(codes, minlength=len(dictionary) + 1)[:len(dictionary)], dictionary

    def predicate(self, spec: dict) -> np.ndarray:
        """The rows where a `predicate` object holds (NULL compares false)."""
        column = spec["column"]
        v = self.numeric[column]
        with np.errstate(invalid="ignore"):
            hold = np.ones(self.n, dtype=bool)
            for op, test in (("gt", np.greater), ("ge", np.greater_equal),
                             ("lt", np.less), ("le", np.less_equal)):
                if op in spec:
                    hold &= test(v, spec[op])
        return hold


def metric(spec: dict, cols: Columns, dtype) -> Tuple[str, str, object]:
    """(key, kind, expected value) of a constraint's metric; kind is
    exact or moment, as `plain.Expected` holds them."""
    kind, column, n = spec["kind"], spec.get("column"), cols.n
    if kind == "size":
        return "Size(*)", "exact", float(n)
    if kind == "complete":
        return f"Completeness({column})", "exact", plain.ratio(cols.present(column).sum(), n, dtype)
    if kind == "mean":
        return f"Mean({column})", "moment", plain.moments(cols.values(column, dtype), dtype)["mean"]
    if kind == "satisfies":
        return (f"Compliance({spec['name']})", "exact",
                plain.ratio(cols.predicate(spec["predicate"]).sum(), n, dtype))
    if kind == "non_negative":
        v = cols.numeric[column]
        with np.errstate(invalid="ignore"):
            hold = ~cols.present(column) | (v >= 0)
        return f"Compliance({column} is non-negative)", "exact", plain.ratio(hold.sum(), n, dtype)
    if kind == "contained_in":
        counts, dictionary = cols.string_counts(column)
        allowed = set(spec["values"])
        inside = sum(int(c) for c, s in zip(counts, dictionary) if s in allowed)
        nulls = n - int(counts.sum())
        name = f"{column} contained in {','.join(spec['values'])}"
        return f"Compliance({name})", "exact", plain.ratio(inside + nulls, n, dtype)
    if kind == "pattern":
        counts, dictionary = cols.string_counts(column)
        pattern = re.compile(spec["pattern"])
        matched = sum(int(c) for c, s in zip(counts, dictionary) if pattern.search(s))
        return f"PatternMatch({column})", "exact", plain.ratio(matched, n, dtype)
    if kind == "primary_key":
        key = np.zeros(n, dtype=np.int64)
        for c in spec["columns"]:  # a mixed-radix key over the columns' ranges
            v = cols.numeric[c].astype(np.int64)
            key = key * (int(v.max()) - int(v.min()) + 1) + (v - int(v.min()))
        counts = np.bincount(key) if int(key.max()) < 1 << 28 else np.unique(key, return_counts=True)[1]
        unique_rows = int((counts == 1).sum())
        return (f"Uniqueness({','.join(spec['columns'])})", "exact",
                plain.ratio(unique_rows, n, dtype))
    raise ValueError(f"unknown constraint kind {kind!r}")


def add_check(exp: plain.Expected, specs: List[dict], cols: Columns, dtype,
              first_status: int = 0) -> int:
    """Add a check's metrics and its statuses `status[first_status ...]`
    to `exp`; returns the next status number."""
    kinds = {"exact": exp.exact, "moment": exp.moments}
    for i, spec in enumerate(specs):
        key, kind, value = metric(spec, cols, dtype)
        kinds[kind][key] = value
        ok = holds(spec.get("assert"), value, cols.n)
        exp.exact[f"status[{first_status + i}]"] = "Success" if ok else "Failure"
    return first_status + len(specs)
