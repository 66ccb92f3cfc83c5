"""Counts-based numeric statistics: moments and the decimated quantile
sample of a column, derived from its distinct (value, count) pairs.

A column with few distinct values (quantities, codes, flags, and every
numeric-looking string column's dictionary) needs no per-row pass for
its numeric family: every output derives from the counts in
O(#distinct):

- moments: weighted sums over the distinct values;
- the decimated sample: the per-row contract is
  ``sorted(x[mask])[stride/2::stride][:kept]``, and rank lookups into
  the cumulative counts give exactly those order statistics;
- the level: ``while (cap << level) < m: level += 1``.

The JAX package also derives these from counts that its C host library
takes in one windowed or hashed pass over an integer or float column.
The port has no C host library yet, so it takes the JAX package's route
for when that library is absent: the counts come from a dictionary
(`_LowCardCounts` in profiles/internal_analyzers.py) and nowhere else.
"""

from __future__ import annotations

import os
import numpy as np


def enabled() -> bool:
    return not os.environ.get("DEEQU_TPU_NO_COUNTS_FASTPATH")


def weighted_moments_and_sample(
    values_sorted: np.ndarray,
    counts_sorted: np.ndarray,
    cap: int,
):
    """From value-SORTED (distinct value, count) pairs: ((count, sum, min,
    max, m2), the decimated sample, the number of values, the level).
    The sum is the weighted long-double dot, the JAX package's float
    route."""
    cs = counts_sorted
    vs = values_sorted
    m = int(cs.sum())
    if m == 0:
        return (
            (0.0, 0.0, float("inf"), float("-inf"), 0.0),
            np.zeros(0, dtype=np.float64),
            0,
            0,
        )
    sum_d = float(np.dot(cs.astype(np.longdouble), vs))
    avg = sum_d / m
    with np.errstate(over="ignore"):
        # d*d squares in float64 on purpose, as the JAX package does
        d = vs - avg
        m2 = float(np.dot(cs.astype(np.longdouble), (d * d).astype(np.longdouble)))
    level = 0
    while (cap << level) < m:
        level += 1
    stride = 1 << level
    offset = stride >> 1
    kept = max(0, (m - offset + stride - 1) // stride)
    if kept:
        ranks = offset + stride * np.arange(kept, dtype=np.int64)
        positions = np.searchsorted(np.cumsum(cs), ranks, side="right")
        sample = vs[positions]
    else:
        sample = np.zeros(0, dtype=np.float64)
    return (float(m), sum_d, float(vs[0]), float(vs[-1]), m2), sample, m, level
