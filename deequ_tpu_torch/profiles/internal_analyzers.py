"""Profiler-internal scan members: they fold the profiler's histogram
pass, and usually its numeric pass, into pass 1.

The reference's ColumnProfiler pays 3 scans: generic statistics, numeric
statistics of the cast columns, and the low-cardinality histograms
(reference: profiles/ColumnProfiler.scala:54-65, 103-187). Two host-only
members ride pass 1's fused scan instead:

- `_LowCardCounts` counts the exact values of a string or boolean
  column while its dictionary codes are at hand (the histogram pass's
  work), and aborts once the distinct count exceeds a cap: the profiler
  keeps histograms only for columns under its threshold anyway.
- `_OptimisticNumericStats` computes the numeric pass's statistics
  (min, max, mean, stddev, sum and the quantile sketch) for a STRING
  column on the assumption that type inference lands Integral or
  Fractional. That is sound: `determine_type` (reference:
  analyzers/DataType.scala:116-146) returns a numeric type only when no
  value classified as String, so every value was castable and the
  speculative statistics equal what the numeric pass would compute. Any
  failed cast kills the state (`dead`); where inference and the cast
  disagree ("+ 5" matches the Integral regex but does not parse), the
  profiler runs the numeric pass for that column after all.

Both are host-only: strings and dictionary codes never ship to the
device (ops/fused.py, `fold_host_batch`). Their metrics carry the raw
state for the profiler.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from deequ_tpu_torch.analyzers.base import InputSpec, Preconditions, ScanShareableAnalyzer
from deequ_tpu_torch.analyzers.sketch import ApproxQuantileState, _batch_seed
from deequ_tpu_torch.analyzers.states import State
from deequ_tpu_torch.core.maybe import Success
from deequ_tpu_torch.core.metrics import Entity, Metric
from deequ_tpu_torch.data.table import ColumnType, Table, parsed_dictionary
from deequ_tpu_torch.ops import counts_family, native
from deequ_tpu_torch.ops.sketches.kll import KLLSketch, k_for_error
from deequ_tpu_torch.ops.strings import parse_floats


@dataclass(frozen=True)
class _InternalStateMetric(Metric):
    """Carries a raw state through the runner's metric map; it flattens
    to nothing, so no export shows it."""

    def flatten(self):
        return []


def _internal_metric(name: str, instance: str, value) -> "_InternalStateMetric":
    return _InternalStateMetric(Entity.COLUMN, name, instance, value)


# ---------------------------------------------------------------------------
# _LowCardCounts: exact value counts while the dictionary codes are at hand
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class LowCardCountsState(State):
    """counts[value] over non-null rows and the null count; aborted once
    the distinct count exceeded the cap. The cap travels with the state,
    so merges enforce it too."""

    counts: Tuple[Tuple[Any, int], ...]
    null_count: int
    aborted: bool
    cap: int = 1 << 30

    def merge(self, other: "LowCardCountsState") -> "LowCardCountsState":
        cap = min(self.cap, other.cap)
        nulls = self.null_count + other.null_count
        if self.aborted or other.aborted:
            return LowCardCountsState((), nulls, True, cap)
        merged: Dict[Any, int] = dict(self.counts)
        for key, count in other.counts:
            merged[key] = merged.get(key, 0) + count
        if len(merged) > cap:
            return LowCardCountsState((), nulls, True, cap)
        return LowCardCountsState(tuple(merged.items()), nulls, False, cap)

    def as_dict(self) -> Dict[Any, int]:
        return dict(self.counts)


@dataclass(frozen=True)
class _LowCardCounts(ScanShareableAnalyzer):
    """The histogram pass's exact counting, fused into pass 1
    (reference: profiles/ColumnProfiler.scala:487-565, the countByKey
    pass it replaces)."""

    column: str
    cap: int
    # internal: its metric carries a raw state, never saved to a metrics
    # repository nor required from one
    internal = True
    device_assisted = True
    host_only = True

    @property
    def name(self) -> str:
        return "_LowCardCounts"

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [Preconditions.has_column(self.column)]

    def input_specs(self) -> List[InputSpec]:
        column = self.column

        def build_codes(t: Table) -> np.ndarray:
            col = t.column(column)
            if col.ctype == ColumnType.BOOLEAN:
                # booleans count without a dictionary: the raw values
                return col.values
            return col.dict_encode()[0]

        def build_uniques(t: Table) -> np.ndarray:
            col = t.column(column)
            if col.ctype == ColumnType.BOOLEAN:
                return col.valid  # the boolean route carries valid here
            return np.asarray(col.dict_encode()[1])

        return [
            InputSpec(key=f"lcc_codes:{column}", build=build_codes, columns=(column,)),
            InputSpec(key=f"lcc_uniq:{column}", build=build_uniques, columns=(column,)),
        ]

    def host_batch(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        codes = np.asarray(inputs[f"lcc_codes:{self.column}"])
        uniques = inputs[f"lcc_uniq:{self.column}"]
        if codes.dtype == np.bool_:
            valid = np.asarray(uniques)
            n_true = int(np.count_nonzero(codes & valid))
            n_valid = int(np.count_nonzero(valid))
            counts = np.asarray(
                [len(codes) - n_valid, n_valid - n_true, n_true], dtype=np.int64
            )
            return {"counts": counts, "uniques": np.asarray([False, True], dtype=object)}
        aborted = len(uniques) > self.cap
        if aborted and len(uniques) > (1 << 16):
            return {"aborted": True}  # too many entries even for the memo
        counts = native.bincount(codes, len(uniques) + 1, base=1)
        if counts is None:
            counts = np.bincount(codes + 1, minlength=len(uniques) + 1).astype(np.int64)
        # the per-entry counts serve _OptimisticNumericStats on this batch:
        # it derives the numeric family from them in O(#uniques)
        inputs[f"__lcccounts:{self.column}"] = (counts, uniques, len(codes))
        if aborted:
            return {"aborted": True}
        return {"counts": counts, "uniques": uniques}

    def host_consume(self, state: Optional[State], out: Any) -> Optional[State]:
        if out.get("aborted"):
            partial = LowCardCountsState((), 0, True, self.cap)
            return partial if state is None else state.merge(partial)
        counts = np.asarray(out["counts"])
        partial_counts = []
        for i, unique in enumerate(out["uniques"]):
            c = int(counts[i + 1])
            if c > 0:
                partial_counts.append((unique, c))
        partial = LowCardCountsState(
            tuple(partial_counts), int(counts[0]), len(partial_counts) > self.cap, self.cap
        )
        return partial if state is None else state.merge(partial)

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        return _internal_metric(self.name, self.instance, Success(state))

    def __repr__(self) -> str:
        return f"_LowCardCounts({self.column},{self.cap})"


# ---------------------------------------------------------------------------
# _OptimisticNumericStats: the numeric pass's statistics, speculatively
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimisticNumericState(State):
    """The numeric family of one cast column: moments (merged with the
    Chan law of the scan analyzers) and a KLL digest. dead once any
    non-null value failed to cast."""

    n: float
    total: float
    minimum: float
    maximum: float
    m2: float
    digest: Optional[KLLSketch]
    dead: bool

    def merge(self, other: "OptimisticNumericState") -> "OptimisticNumericState":
        if self.dead or other.dead:
            return _DEAD_STATE
        n = self.n + other.n
        safe_n = max(n, 1.0)
        avg_a = self.total / max(self.n, 1.0)
        avg_b = other.total / max(other.n, 1.0)
        delta = avg_b - avg_a
        m2 = self.m2 + other.m2 + delta * delta * self.n * other.n / safe_n
        if self.digest is None:
            digest = other.digest
        elif other.digest is None:
            digest = self.digest
        else:
            digest = self.digest.merge(other.digest)
        return OptimisticNumericState(
            n,
            self.total + other.total,
            min(self.minimum, other.minimum),
            max(self.maximum, other.maximum),
            m2,
            digest,
            False,
        )

    @property
    def usable(self) -> bool:
        return not self.dead and self.n > 0 and self.digest is not None


_DEAD_STATE = OptimisticNumericState(0.0, 0.0, float("inf"), float("-inf"), 0.0, None, True)
_DEAD_SENTINEL = "__dead__"


@dataclass(frozen=True)
class _OptimisticNumericStats(ScanShareableAnalyzer):
    """The numeric pass's statistics computed during pass 1 for a string
    column that may infer numeric (reference:
    profiles/ColumnProfiler.scala:128-153, 329-339: the cast and numeric
    pass this makes redundant when inference lands numeric)."""

    column: str
    relative_error: float = 0.01
    internal = True  # as _LowCardCounts
    device_assisted = True
    host_only = True

    @property
    def name(self) -> str:
        return "_OptimisticNumericStats"

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [Preconditions.has_column(self.column)]

    def _cap(self) -> int:
        return 2 * k_for_error(self.relative_error)

    def input_specs(self) -> List[InputSpec]:
        column = self.column

        def cast_or_dead(col):
            """(values, cast_valid), or None when a present value does not
            cast; both specs share it through numeric_values' memo."""
            _, uniques = col.dict_encode()
            # a cheap probe of the dictionary's head: a clearly
            # non-numeric column (names, dates) dies without a full parse
            if len(uniques) and not parse_floats(np.asarray(uniques[:64], dtype=object))[1].all():
                return None
            values, cast_valid = col.numeric_values()
            if np.count_nonzero(np.asarray(col.valid) & ~np.asarray(cast_valid)):
                return None
            return values, cast_valid

        def build(part: int):
            def run(t: Table):
                res = cast_or_dead(t.column(column))
                return np.asarray(_DEAD_SENTINEL if res is None else res[part])

            return run

        return [
            InputSpec(key=f"optnum:{column}", build=build(0), columns=(column,)),
            InputSpec(key=f"optnumv:{column}", build=build(1), columns=(column,)),
        ]

    def _from_counts(self, inputs: Dict[str, Any], lcc) -> Optional[Dict[str, Any]]:
        """The numeric family from _LowCardCounts' per-entry counts: parse
        the DICTIONARY once, take weighted moments and the rank-gathered
        sample over (parsed value, count) pairs. A failed parse of any
        PRESENT entry kills the state, as a failed row cast does."""
        counts, uniques, _n_batch = lcc
        cs_all = np.asarray(counts)[1:]
        if len(cs_all) != len(uniques):
            return None
        u_vals, u_ok = parsed_dictionary(inputs.batch.column(self.column))
        if len(u_vals) != len(cs_all):
            return None
        present = cs_all > 0
        if np.any(present & ~np.asarray(u_ok, dtype=bool)):
            return {"dead": True}
        cs = cs_all[present]
        vals = np.asarray(u_vals, dtype=np.float64)[present]
        order = np.argsort(vals)
        core, sample, m, level = counts_family.weighted_moments_and_sample(
            vals[order], cs[order], self._cap()
        )
        count, total, vmin, vmax, m2 = core
        return {
            "dead": False, "count": count, "sum": total, "min": vmin, "max": vmax,
            "m2": m2, "sample": sample, "n": m, "level": level,
        }

    def host_batch(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        lcc = inputs.get(f"__lcccounts:{self.column}")
        if lcc is not None and counts_family.enabled():
            out = self._from_counts(inputs, lcc)
            if out is not None:
                return out
        values = inputs[f"optnum:{self.column}"]
        cast_valid = inputs[f"optnumv:{self.column}"]
        if np.asarray(values).ndim == 0:
            return {"dead": True}
        res = native.masked_moments_select(values, cast_valid, None, self._cap())
        if res is not None:
            mom, sample, n_valid, level, _regs = res
            return {
                "dead": False, "count": float(mom[0]), "sum": float(mom[1]),
                "min": float(mom[2]), "max": float(mom[3]), "m2": float(mom[4]),
                "sample": sample, "n": n_valid, "level": level,
            }
        # the library off: the same math and the same decimation law
        mask = np.asarray(cast_valid, dtype=bool)
        xm = np.asarray(values, dtype=np.float64)[mask]
        n = xm.size
        if n == 0:
            return {
                "dead": False, "count": 0.0, "sum": 0.0,
                "min": float("inf"), "max": float("-inf"), "m2": 0.0,
                "sample": np.zeros(0), "n": 0, "level": 0,
            }
        avg = float(xm.sum()) / n
        level = max(0, int(np.ceil(np.log2(max(n, 1) / self._cap()))))
        stride = 1 << level
        xs = np.sort(xm)
        kept = max(0, -(-(n - stride // 2) // stride))
        return {
            "dead": False,
            "count": float(n),
            "sum": float(xm.sum()),
            "min": float(xs[0]),
            "max": float(xs[-1]),
            "m2": float(((xm - avg) ** 2).sum()),
            "sample": xs[stride // 2 :: stride][:kept],
            "n": n,
            "level": level,
        }

    def host_consume(self, state: Optional[State], out: Any) -> Optional[State]:
        if out.get("dead"):
            partial = _DEAD_STATE
        else:
            n = int(out["n"])
            level = int(out["level"]) if n > 0 else 0
            if n > 0:
                stride = 1 << level
                kept = max(0, -(-(n - stride // 2) // stride))
                sample = np.asarray(out["sample"], dtype=np.float64)[:kept]
            else:
                sample = np.empty(0, dtype=np.float64)
            digest = KLLSketch(
                k=k_for_error(self.relative_error), seed=_batch_seed(sample, n, level)
            )
            if n > 0:
                digest.insert_level(sample, level, true_count=n)
            partial = OptimisticNumericState(
                float(out["count"]),
                float(out["sum"]),
                float(out["min"]),
                float(out["max"]),
                float(out["m2"]),
                digest,
                False,
            )
        return partial if state is None else state.merge(partial)

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        return _internal_metric(self.name, self.instance, Success(state))

    def __repr__(self) -> str:
        return f"_OptimisticNumericStats({self.column},{self.relative_error})"


def synthesize_numeric_metrics(
    column: str,
    state: OptimisticNumericState,
    percentiles,
    relative_error: float = 0.01,
) -> Dict[Any, Metric]:
    """The metric map the numeric pass would have produced for this
    column, through the real analyzers' compute_metric_from, so shapes,
    names and failures are the same (reference:
    ColumnProfiler.scala:219-235's analyzer bundle)."""
    from deequ_tpu_torch.analyzers import (
        ApproxQuantiles,
        Maximum,
        Mean,
        Minimum,
        StandardDeviation,
        Sum,
    )
    from deequ_tpu_torch.analyzers.states import (
        MaxState,
        MeanState,
        MinState,
        StandardDeviationState,
        SumState,
    )

    n = state.n
    avg = state.total / max(n, 1.0)
    aq = ApproxQuantiles(column, tuple(percentiles), relative_error)
    pairs = [
        (Minimum(column), MinState(state.minimum)),
        (Maximum(column), MaxState(state.maximum)),
        (Mean(column), MeanState(state.total, int(n))),
        (Sum(column), SumState(state.total)),
        (StandardDeviation(column), StandardDeviationState(n, avg, state.m2)),
        (aq, ApproxQuantileState(state.digest)),
    ]
    return {analyzer: analyzer.compute_metric_from(s) for analyzer, s in pairs}
