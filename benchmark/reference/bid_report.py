"""The `bid_report` traffic over NEXMark's bids, in plain numpy: Query 15's
counts and distinct counts, in total and by price band, with the
completeness, extremes and mean of the columns and the quantiles of
price.

Sizes, completeness, minimum and maximum are exact. The mean is a
moment. The distinct counts are exact, by `bincount` over the ids'
ranges (ids stay below a few million: no sort of 92,000,000 values),
against ApproxCountDistinct's estimate; the quantiles by rank
(`plain.RankIndex`).
"""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.drivers.table_loop import members
from benchmark.reference import plain

#: the SQL predicates of the traffic's bands that this reference reads:
#: `price <op> <int>` clauses joined by AND
OPS = {"<": np.less, "<=": np.less_equal, ">": np.greater, ">=": np.greater_equal}


def band_mask(columns, where: str) -> np.ndarray:
    mask = None
    for clause in where.split(" AND "):
        column, op, bound = clause.split()
        part = OPS[op](columns[column], int(bound))
        mask = part if mask is None else mask & part
    return mask


def distinct_ids(values: np.ndarray) -> int:
    """The distinct count of non-negative ids, by bincount."""
    return int(np.count_nonzero(np.bincount(values))) if len(values) else 0


def expected(data, traffic, dtype=np.float64) -> plain.Expected:
    exp = plain.Expected()
    columns = data.columns
    masks = {}
    for k, spec, column, where in members(traffic):
        if where is not None and where not in masks:
            masks[where] = band_mask(columns, where)
        mask = masks.get(where)
        kind = spec["kind"]
        if kind == "size":
            exp.exact[k] = float(data.rows if mask is None else np.count_nonzero(mask))
        elif kind == "completeness":
            exp.exact[k] = 1.0  # the bids have no nulls
        elif kind == "approx_distinct":
            values = columns[column] if mask is None else columns[column][mask]
            exp.distinct[k] = float(distinct_ids(values))
        elif kind in ("min", "max"):
            values = columns[column].astype(dtype, copy=False)
            exp.exact[k] = float(values.min() if kind == "min" else values.max())
        elif kind == "mean":
            exp.moments[k] = float(columns[column].astype(dtype).mean(dtype=dtype))
        elif kind == "quantiles":
            # float64 ranks (exact for these ids and cents): a float probe
            # then searches the sorted values without casting them all
            values = columns[column].astype(np.float64)
            exp.quantiles[k] = (plain.RankIndex(values), spec["probabilities"])
        else:
            raise ValueError(f"unknown analyzer kind {kind!r}")
    return exp


def judge(ctx, outputs: List[dict]):
    return plain.numbers(plain.compare(expected(ctx.data, ctx.cell.traffic), outputs))


def control(ctx):
    """The reference in float32 in the program's place."""
    traffic = ctx.cell.traffic
    out = expected(ctx.data, traffic, np.float32).as_output()
    return plain.numbers(plain.compare(expected(ctx.data, traffic), [out]))
