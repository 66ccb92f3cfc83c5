"""The `scan` traffic's analyzers over the lineitem table, in plain numpy:
Size; Completeness, Mean, StandardDeviation, Minimum, Maximum and Sum of
the listed columns; exact distinct counts against ApproxCountDistinct;
the Pearson correlation of each listed pair."""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.reference import plain

MOMENT_NAMES = {"mean": "Mean", "sum": "Sum", "stddev": "StandardDeviation"}
EXACT_NAMES = {"min": "Minimum", "max": "Maximum"}


def _column(data, name: str, dtype):
    values = data.numeric[name]
    return values.astype(dtype, copy=False) if values.dtype.kind == "f" else values


def expected(data, analyzers, dtype=np.float64) -> plain.Expected:
    exp = plain.Expected()
    cache = {}
    for spec in analyzers:
        kind = spec["kind"]
        if kind == "size":
            exp.exact["Size(*)"] = float(data.rows)
        elif kind == "correlation":
            a, b = spec["columns"]
            exp.moments[f"Correlation({a},{b})"] = plain.correlation(
                _column(data, a, dtype), _column(data, b, dtype), dtype)
        elif kind == "completeness":
            for column in spec["columns"]:
                exp.exact[f"Completeness({column})"] = 1.0
        elif kind == "approx_distinct":
            for column in spec["columns"]:
                exp.distinct[f"ApproxCountDistinct({column})"] = float(
                    plain.distinct_count(_column(data, column, dtype)))
        else:
            for column in spec["columns"]:
                if column not in cache:
                    cache[column] = plain.moments(_column(data, column, dtype), dtype)
                m = cache[column]
                if kind in MOMENT_NAMES:
                    exp.moments[f"{MOMENT_NAMES[kind]}({column})"] = m[kind]
                else:
                    exp.exact[f"{EXACT_NAMES[kind]}({column})"] = m[kind]
    return exp


def judge(ctx, outputs: List[dict]):
    exp = expected(ctx.data, ctx.cell.traffic["analyzers"])
    return plain.numbers(plain.compare(exp, outputs))


def control(ctx):
    """The reference in float32 in the program's place."""
    analyzers = ctx.cell.traffic["analyzers"]
    out = expected(ctx.data, analyzers, np.float32).as_output()
    return plain.numbers(plain.compare(expected(ctx.data, analyzers), [out]))
