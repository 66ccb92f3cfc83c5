"""Plain numpy that the references share: what a metric must be, and
how far the program's numbers lie from it.

Nothing here imports the program or the JAX stack. The references get
the generator's arrays, never what the program derived from them, and
the program's results only as plain numbers to judge.

An `Expected` holds four kinds of numbers, each compared its own way:

    exact      equal, or it counts in `exact_mismatch` (counts, ratios
               of counts, min, max, types, histograms, statuses)
    moments    float sums: the relative error, worst in `moment_rel_err`
    distinct   exact distinct counts against the HLL++ sketch's estimate:
               the relative error, worst in `distinct_rel_err`
    quantiles  (RankIndex, [probabilities]): how far the rank of each
               returned value lies from its probability, worst in
               `quantile_rank_err`

A key the program left out counts in `missing`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np

#: the limit of each number compared; PERF.md gives the readings each
#: was set from (sound runs below it, the control or a planted fault above)
LIMITS = {
    "missing": 0.0,
    "exact_mismatch": 0.0,
    "moment_rel_err": 1e-11,
    "distinct_rel_err": 0.25,
    "quantile_rank_err": 0.02,
    "failed_requests": 0.0,
}


class RankIndex:
    """The ranks of a column's values: for a value q, the share of rows
    below q and at or below q. Integers of a modest range count by
    bincount, anything else sorts."""

    def __init__(self, values: np.ndarray):
        values = np.asarray(values)
        self.n = len(values)
        self.counts = None
        if values.dtype.kind in "iu" and self.n and int(values.max()) - int(values.min()) < 1 << 25:
            self.low = int(values.min())
            self.counts = np.cumsum(np.bincount(values - self.low))
        else:
            self.sorted = np.sort(values)

    def ranks(self, q: float) -> Tuple[float, float]:
        if self.counts is not None:
            below_index = math.ceil(q) - self.low - 1  # values < q are <= ceil(q) - 1
            at_index = math.floor(q) - self.low
            below = 0 if below_index < 0 else int(self.counts[min(below_index, len(self.counts) - 1)])
            at = 0 if at_index < 0 else int(self.counts[min(at_index, len(self.counts) - 1)])
        else:
            below = int(np.searchsorted(self.sorted, q, side="left"))
            at = int(np.searchsorted(self.sorted, q, side="right"))
        return below / self.n, at / self.n

    def quantile(self, p: float) -> float:
        """The exact p-quantile by nearest rank."""
        k = max(math.ceil(p * self.n), 1) - 1
        if self.counts is not None:
            return float(self.low + int(np.searchsorted(self.counts, k, side="right")))
        return float(self.sorted[k])


def rank_error(index: RankIndex, q: float, p: float) -> float:
    below, at = index.ranks(q)
    return max(0.0, below - p, p - at)


def rel_err(got: float, want: float) -> float:
    if got == want:
        return 0.0
    if math.isnan(got) or math.isnan(want):
        return math.inf
    return abs(got - want) / max(abs(want), 1e-300)


@dataclass
class Expected:
    exact: Dict[str, object] = field(default_factory=dict)
    moments: Dict[str, float] = field(default_factory=dict)
    distinct: Dict[str, float] = field(default_factory=dict)
    quantiles: Dict[str, Tuple[RankIndex, Sequence[float]]] = field(default_factory=dict)

    def as_output(self) -> dict:
        """These numbers as the program would report them: the control
        (a reference in a lower precision) takes the program's place."""
        out = dict(self.exact)
        out.update(self.moments)
        out.update(self.distinct)
        for key, (index, probabilities) in self.quantiles.items():
            values = [index.quantile(p) for p in probabilities]
            out[key] = values if len(values) > 1 else values[0]
        return out


def compare(expected: Expected, outputs: List[dict]) -> Dict[str, float]:
    """The worst of each kind of number over every output."""
    worst = {"missing": 0.0, "exact_mismatch": 0.0}
    if expected.moments:
        worst["moment_rel_err"] = 0.0
    if expected.distinct:
        worst["distinct_rel_err"] = 0.0
    if expected.quantiles:
        worst["quantile_rank_err"] = 0.0
    for out in outputs:
        missing = sum(1 for kind in (expected.exact, expected.moments, expected.distinct,
                                     expected.quantiles) for key in kind if out.get(key) is None)
        worst["missing"] = max(worst["missing"], float(missing))
        mismatched = sum(1 for key, want in expected.exact.items()
                         if out.get(key) is not None and out[key] != want)
        worst["exact_mismatch"] = max(worst["exact_mismatch"], float(mismatched))
        for key, want in expected.moments.items():
            if out.get(key) is not None:
                worst["moment_rel_err"] = max(worst["moment_rel_err"], rel_err(out[key], want))
        for key, want in expected.distinct.items():
            if out.get(key) is not None:
                worst["distinct_rel_err"] = max(worst["distinct_rel_err"], rel_err(out[key], want))
        for key, (index, probabilities) in expected.quantiles.items():
            got = out.get(key)
            if got is None:
                continue
            got = got if isinstance(got, list) else [got]
            if len(got) != len(probabilities):
                worst["quantile_rank_err"] = math.inf
                continue
            for q, p in zip(got, probabilities):
                worst["quantile_rank_err"] = max(worst["quantile_rank_err"],
                                                 rank_error(index, q, p))
    return worst


def numbers(worst: Dict[str, float]) -> List[Tuple[str, float, float]]:
    """(name, value, limit) of every number compared."""
    return [(name, float(value), float(LIMITS[name])) for name, value in worst.items()]


def moments(values: np.ndarray, dtype) -> Dict[str, float]:
    """Mean, sum, population standard deviation, minimum and maximum of
    a column without nulls, computed in `dtype`."""
    v = values.astype(dtype, copy=False)
    mean = v.mean(dtype=dtype)
    return {"mean": float(mean), "sum": float(v.sum(dtype=dtype)),
            "stddev": float(np.sqrt(((v - mean) ** 2).mean(dtype=dtype))),
            "min": float(v.min()), "max": float(v.max())}


def correlation(a: np.ndarray, b: np.ndarray, dtype) -> float:
    a, b = a.astype(dtype, copy=False), b.astype(dtype, copy=False)
    da, db = a - a.mean(dtype=dtype), b - b.mean(dtype=dtype)
    return float((da * db).sum(dtype=dtype) / np.sqrt((da * da).sum(dtype=dtype)
                                                      * (db * db).sum(dtype=dtype)))


def ratio(count: int, n: int, dtype) -> float:
    """count / n computed in `dtype`, as a share of rows is."""
    return float(dtype(count) / dtype(n))


def distinct_count(values: np.ndarray) -> int:
    values = np.asarray(values)
    if values.dtype.kind in "iu" and len(values):
        low = int(values.min())
        if int(values.max()) - low < 1 << 26:
            return int(np.count_nonzero(np.bincount(values - low)))
    s = np.sort(values)
    return int(1 + np.count_nonzero(s[1:] != s[:-1])) if len(s) else 0
