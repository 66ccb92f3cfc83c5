"""The default column profile of the lineitem table, in plain numpy.

For every column: its type, completeness, distinct count (against the
HLL++ estimate); for numeric columns mean, sum, population standard
deviation, minimum, maximum and the 100 percentiles 0.01 .. 1.00 (by
rank, against ApproxQuantiles' relative error); for string columns the
type counts and, below 120 distinct values, the exact histogram.
L_COMMENT's distinct count is that of a 64-bit hash of each text
(`Comments.keys`): two texts that differ collide with a chance near
n**2 / 2**65, about 1e-6 at 6M rows.
"""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.reference import plain

PERCENTILES = [i / 100 for i in range(1, 101)]
LOW_CARDINALITY = 120  # the profiler's histogram threshold


def expected(data, dtype=np.float64) -> plain.Expected:
    exp = plain.Expected()
    n = data.rows
    exp.exact["num_records"] = float(n)
    for column, values in data.numeric.items():
        floating = values.dtype.kind == "f"
        if floating:  # integers stay integers in any precision
            values = values.astype(dtype, copy=False)
        exp.exact[f"{column}.dataType"] = "Fractional" if floating else "Integral"
        exp.exact[f"{column}.completeness"] = 1.0
        m = plain.moments(values, dtype)
        exp.exact[f"{column}.minimum"] = m["min"]
        exp.exact[f"{column}.maximum"] = m["max"]
        exp.moments[f"{column}.mean"] = m["mean"]
        exp.moments[f"{column}.sum"] = m["sum"]
        exp.moments[f"{column}.stdDev"] = m["stddev"]
        index = plain.RankIndex(values)
        exp.quantiles[f"{column}.approxPercentiles"] = (index, PERCENTILES)
        exp.distinct[f"{column}.approximateNumDistinctValues"] = float(plain.distinct_count(values))
    text_counts = {"Unknown": 0, "Fractional": 0, "Integral": 0, "Boolean": 0, "String": n}
    for column, codes in data.codes.items():
        dictionary = data.dictionaries[column]
        counts = np.bincount(codes, minlength=len(dictionary))
        present = np.nonzero(counts)[0]
        exp.exact[f"{column}.dataType"] = "String"
        exp.exact[f"{column}.completeness"] = 1.0
        exp.exact[f"{column}.typeCounts"] = text_counts
        exp.distinct[f"{column}.approximateNumDistinctValues"] = float(len(present))
        if len(present) <= LOW_CARDINALITY:
            exp.exact[f"{column}.histogram"] = {str(dictionary[i]): int(counts[i])
                                                for i in present}
    # L_COMMENT: grammar text, never a number or a boolean
    exp.exact["l_comment.dataType"] = "String"
    exp.exact["l_comment.completeness"] = 1.0
    exp.exact["l_comment.typeCounts"] = text_counts
    exp.distinct["l_comment.approximateNumDistinctValues"] = float(
        plain.distinct_count(data.comments.keys()))
    return exp


def judge(ctx, outputs: List[dict]):
    return plain.numbers(plain.compare(expected(ctx.data), outputs))


def control(ctx):
    """The reference in float32 in the program's place."""
    out = expected(ctx.data, np.float32).as_output()
    return plain.numbers(plain.compare(expected(ctx.data), [out]))
