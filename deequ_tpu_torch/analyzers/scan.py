"""Scan-shareable analyzers: single-pass masked reductions on the device.

Each analyzer's per-batch reduction runs over the batch's device tensors
and returns tensors that stay on the device until the pass packs every
partial into one buffer for one copy to the host. Nothing here reads a
device value on the host (no `float(t)`, no `if t > 0`): a read would
stall the host until the device drains.

Mean, Sum, Minimum, Maximum and StandardDeviation over one (column,
where) share ONE `masked_moments` launch per batch through a memo in the
batch's inputs dict (in eager PyTorch nothing merges common
subexpressions the way XLA does for the JAX package). StandardDeviation
adds one `masked_centered_sumsq` launch.

Completeness, Compliance and PatternMatch are masked counts over bool
masks the host built (validity, a SQL predicate, a regex over the
dictionary), summed on the device: they need no kernel of their own.
DataType likewise: the host classifies each dictionary entry once and
ships int8 class codes; the device counts the five classes.

Under a host-fold placement (ops/runtime.py:placement_mode) an analyzer
folds the batch's host arrays instead (`host_reduce`), in its device
partial's layout: popcounts for the masks, one C `masked_moments` pass per
(column, where) family shared by Mean, Sum, Minimum, Maximum and
StandardDeviation through a `__moments:` memo (which a host-folded
quantile sketch's family kernel may already have filled), one C bincount
for DataType. Size, the ratio analyzers and DataType are
`discrete_inputs`: the ``host-discrete`` placement folds them on the host.

reference: analyzers/Size.scala, Completeness.scala, Compliance.scala,
PatternMatch.scala, Mean.scala, Sum.scala, Minimum.scala, Maximum.scala,
StandardDeviation.scala, Correlation.scala, DataType.scala.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from deequ_tpu_torch.analyzers.base import (
    InputSpec,
    Preconditions,
    ScanShareableAnalyzer,
    col_valid_spec,
    col_values_spec,
    render_where,
    to_f64,
    where_key,
    where_spec,
)
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
from deequ_tpu_torch.core.exceptions import EmptyStateException, wrap_if_necessary
from deequ_tpu_torch.core.maybe import Failure, Success
from deequ_tpu_torch.core.metrics import (
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    HistogramMetric,
    Metric,
)
from deequ_tpu_torch.data.expr import Predicate
from deequ_tpu_torch.data.table import (
    ColumnType,
    Table,
    cached_column_encode,
    cached_dictionary_encode,
    gather_with_null,
)
from deequ_tpu_torch.ops import counts_family, cuda_kernels, native
from deequ_tpu_torch.ops import strings
from deequ_tpu_torch.ops.strings import match_pattern


def _double_metric(analyzer: ScanShareableAnalyzer, state: Optional[State]) -> Metric:
    if state is None:
        return analyzer.empty_state_failure()
    return DoubleMetric(
        analyzer.entity, analyzer.name, analyzer.instance, Success(state.metric_value())
    )


def _count(mask) -> np.ndarray:
    """A host mask's popcount as a float64 partial."""
    return np.float64(np.count_nonzero(np.asarray(mask, dtype=bool)))


# ---------------------------------------------------------------------------
# Size
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Size(ScanShareableAnalyzer):
    """# rows, optionally filtered (reference: analyzers/Size.scala:36)."""

    discrete_inputs = True  # mask-only: host-foldable under placement
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "Size"

    @property
    def instance(self) -> str:
        return "*"

    @property
    def entity(self) -> Entity:
        return Entity.DATASET

    def input_specs(self) -> List[InputSpec]:
        return [where_spec(self.where)]

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return {"n": inputs[where_key(self.where)].sum()}

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        return {"n": _count(inputs[where_key(self.where)])}

    def merge_agg(self, a, b):
        return {"n": a["n"] + b["n"]}

    def state_from_aggregates(self, agg) -> Optional[State]:
        return NumMatches(int(agg["n"]))

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        return _double_metric(self, state)

    def __repr__(self) -> str:
        return f"Size({render_where(self.where)})"


# ---------------------------------------------------------------------------
# Ratio analyzers: Completeness / Compliance / PatternMatch
# ---------------------------------------------------------------------------


class _RatioAnalyzer(ScanShareableAnalyzer):
    """matches/count with a guard count for the empty-state rule.

    The guard mirrors SQL `sum` nullability in the reference's aggregation
    expressions: the state is empty (None -> EmptyStateException) exactly
    when every row's criterion was NULL. For Completeness the criterion
    (`isNotNull(...)`) is never NULL, so the guard is "any row scanned"; for
    Compliance/PatternMatch non-matching `where` rows and NULL inputs make
    the criterion NULL, so the guard is "any row with where and a non-null
    input" (reference: analyzers/Completeness.scala:36-41,
    Compliance.scala:50, PatternMatch.scala:42-50)."""

    discrete_inputs = True  # mask-only: host-foldable under placement

    def _match_mask_key(self) -> str:
        raise NotImplementedError

    def _extra_specs(self) -> List[InputSpec]:
        raise NotImplementedError

    def _guard(self, inputs: Dict[str, Any]) -> torch.Tensor:
        """Mask of rows whose criterion is non-NULL (the same expression
        over host numpy masks as over device tensors)."""
        raise NotImplementedError

    def input_specs(self) -> List[InputSpec]:
        return self._extra_specs() + [where_spec(self.where), where_spec(None)]

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        w = inputs[where_key(self.where)]
        return {
            "matches": (inputs[self._match_mask_key()] & w).sum(),
            "count": w.sum(),
            "guard": self._guard(inputs).sum(),
        }

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        w = np.asarray(inputs[where_key(self.where)], dtype=bool)
        return {
            "matches": _count(np.asarray(inputs[self._match_mask_key()], dtype=bool) & w),
            "count": _count(w),
            "guard": _count(self._guard(inputs)),
        }

    def merge_agg(self, a, b):
        return {k: a[k] + b[k] for k in ("matches", "count", "guard")}

    def state_from_aggregates(self, agg) -> Optional[State]:
        if int(agg["guard"]) == 0:
            return None
        return NumMatchesAndCount(int(agg["matches"]), int(agg["count"]))

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        return _double_metric(self, state)


@dataclass(frozen=True)
class Completeness(_RatioAnalyzer):
    """Fraction non-NULL (reference: analyzers/Completeness.scala:26)."""

    column: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "Completeness"

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [Preconditions.has_column(self.column)]

    def _match_mask_key(self) -> str:
        return f"valid:{self.column}"

    def _extra_specs(self) -> List[InputSpec]:
        return [col_valid_spec(self.column)]

    def _guard(self, inputs: Dict[str, Any]) -> torch.Tensor:
        # isNotNull(...) is never NULL: empty only when nothing was scanned
        return inputs[where_key(None)]

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        # the (column, where) family's moments carry exactly these counts
        # (matches = valid & where, count = where, guard = rows) when a
        # family kernel or a C moments pass filled the memo this batch
        mom = inputs.get(f"__moments:{self.column}:{where_key(self.where)}")
        if mom is not None and "n_rows" in mom:
            return to_f64(
                {"matches": mom["count"], "count": mom["n_where"], "guard": mom["n_rows"]}
            )
        if self.where is None:
            # a string or boolean column `_LowCardCounts` counted this
            # batch: its null count is known
            nulls = inputs.get(f"__lccnulls:{self.column}")
            if nulls is not None:
                null_count, n = nulls
                return to_f64({"matches": n - null_count, "count": n, "guard": n})
        return super().host_reduce(inputs)

    def __repr__(self) -> str:
        return f"Completeness({self.column},{render_where(self.where)})"


def _pred_specs(predicate: str) -> List[InputSpec]:
    """A predicate's row mask (`pred:`, NULL counting as False) and its
    non-NULL rows (`prednn:`), from one parse."""
    pred = Predicate(predicate)
    columns = tuple(sorted(set(pred.referenced_columns())))
    return [
        InputSpec(key=f"pred:{predicate}", build=pred.eval_mask, columns=columns),
        InputSpec(key=f"prednn:{predicate}", build=pred.eval_nonnull, columns=columns),
    ]


@dataclass(frozen=True)
class Compliance(_RatioAnalyzer):
    """Fraction of rows satisfying an arbitrary SQL predicate
    (reference: analyzers/Compliance.scala:37)."""

    instance_name: str
    predicate: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "Compliance"

    @property
    def instance(self) -> str:
        return self.instance_name

    def _match_mask_key(self) -> str:
        return f"pred:{self.predicate}"

    def _extra_specs(self) -> List[InputSpec]:
        return _pred_specs(self.predicate)

    def _guard(self, inputs: Dict[str, Any]) -> torch.Tensor:
        # criterion NULL on where-misses and NULL predicate results
        return inputs[where_key(self.where)] & inputs[f"prednn:{self.predicate}"]

    def __repr__(self) -> str:
        return f"Compliance({self.instance_name},{self.predicate},{render_where(self.where)})"


class Patterns:
    """Built-in patterns (reference: analyzers/PatternMatch.scala:57-70;
    the regexes are cited third-party public constants)."""

    # http://emailregex.com
    EMAIL = (
        r"""(?:[a-z0-9!#$%&'*+/=?^_`{|}~-]+(?:\.[a-z0-9!#$%&'*+/=?^_`{|}~-]+)*"""
        r"""|"(?:[\x01-\x08\x0b\x0c\x0e-\x1f\x21\x23-\x5b\x5d-\x7f]|\\[\x01-\x09\x0b\x0c\x0e-\x7f])*")"""
        r"""@(?:(?:[a-z0-9](?:[a-z0-9-]*[a-z0-9])?\.)+[a-z0-9](?:[a-z0-9-]*[a-z0-9])?"""
        r"""|\[(?:(?:25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?)\.){3}"""
        r"""(?:25[0-5]|2[0-4][0-9]|[01]?[0-9][0-9]?|[a-z0-9-]*[a-z0-9]:"""
        r"""(?:[\x01-\x08\x0b\x0c\x0e-\x1f\x21-\x5a\x53-\x7f]|\\[\x01-\x09\x0b\x0c\x0e-\x7f])+)\])"""
    )

    # https://mathiasbynens.be/demo/url-regex (@stephenhay)
    URL = r"""(https?|ftp)://[^\s/$.?#].[^\s]*"""

    SOCIAL_SECURITY_NUMBER_US = (
        r"""((?!219-09-9999|078-05-1120)(?!666|000|9\d{2})\d{3}-(?!00)\d{2}-(?!0{4})\d{4})"""
        r"""|((?!219 09 9999|078 05 1120)(?!666|000|9\d{2})\d{3} (?!00)\d{2} (?!0{4})\d{4})"""
        r"""|((?!219099999|078051120)(?!666|000|9\d{2})\d{3}(?!00)\d{2}(?!0{4})\d{4})"""
    )

    # http://www.richardsramblings.com/regex/credit-card-numbers/
    CREDITCARD = (
        r"""\b(?:3[47]\d{2}([\ \-]?)\d{6}\1\d|(?:(?:4\d|5[1-5]|65)\d{2}|6011)"""
        r"""([\ \-]?)\d{4}\2\d{4}\2)\d{4}\b"""
    )


def _match_spec(column: str, pattern: str) -> InputSpec:
    re.compile(pattern)  # fail fast on a bad pattern, at spec-build time

    def compute(col) -> np.ndarray:
        # regex only the unique values (typically << rows), gather to
        # rows; null rows map to False
        codes, uniques = col.dict_encode()
        return gather_with_null(match_pattern(uniques, pattern), codes, False)

    def build(t: Table) -> np.ndarray:
        return cached_column_encode(t.column(column), f"match:{pattern}", compute)

    return InputSpec(key=f"match:{column}:{pattern}", build=build, columns=(column,))


@dataclass(frozen=True)
class PatternMatch(_RatioAnalyzer):
    """Fraction of values matching a regex
    (reference: analyzers/PatternMatch.scala:37)."""

    column: str
    pattern: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "PatternMatch"

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [
            Preconditions.has_column(self.column),
            Preconditions.is_string(self.column),
        ]

    def _match_mask_key(self) -> str:
        return f"match:{self.column}:{self.pattern}"

    def _extra_specs(self) -> List[InputSpec]:
        return [_match_spec(self.column, self.pattern), col_valid_spec(self.column)]

    def _guard(self, inputs: Dict[str, Any]) -> torch.Tensor:
        # regexp_extract(NULL) is NULL: criterion non-NULL iff where and a value
        return inputs[where_key(self.where)] & inputs[f"valid:{self.column}"]

    def __repr__(self) -> str:
        return f"PatternMatch({self.column},{self.pattern},{render_where(self.where)})"


# ---------------------------------------------------------------------------
# Numeric moments: Mean / Min / Max / Sum / StdDev
# ---------------------------------------------------------------------------


def _family_mask(inputs: Dict[str, Any], column: str, where: Optional[str]) -> torch.Tensor:
    """valid & where as a bool mask, memoized per batch: 1 B/row on the
    device, never the 8 B/row float product."""
    key = f"__mask:{column}:{where_key(where)}"
    mask = inputs.get(key)
    if mask is None:
        mask = inputs[f"valid:{column}"] & inputs[where_key(where)]
        inputs[key] = mask
    return mask


def _family_moments(inputs: Dict[str, Any], column: str, where: Optional[str]) -> torch.Tensor:
    """(count, sum, min, max) of one (column, where) family: one
    `masked_moments` launch per batch, shared through the inputs dict."""
    key = f"__moments:{column}:{where_key(where)}"
    moments = inputs.get(key)
    if moments is None:
        moments = cuda_kernels.masked_moments(
            inputs[f"num:{column}"], _family_mask(inputs, column, where)
        )
        inputs[key] = moments
    return moments


class _NumericScanAnalyzer(ScanShareableAnalyzer):
    def preconditions(self) -> List[Callable[[Table], None]]:
        return [
            Preconditions.has_column(self.column),
            Preconditions.is_numeric(self.column),
        ]

    @property
    def instance(self) -> str:
        return self.column

    def input_specs(self) -> List[InputSpec]:
        return [
            col_values_spec(self.column),
            col_valid_spec(self.column),
            where_spec(self.where),
        ]

    def _moments(self, inputs: Dict[str, Any]) -> torch.Tensor:
        return _family_moments(inputs, self.column, self.where)

    def _host_moments(self, inputs: Dict[str, Any]) -> Dict[str, float]:
        """The (column, where) family's count, sum, min, max and m2 from
        one C `masked_moments` pass over the host arrays (numpy over the
        compacted rows when the library is off), memoized in the batch's
        inputs: Mean, Sum, Minimum, Maximum and StandardDeviation share
        it, and a host-folded sketch's family kernel may have filled it."""
        memo_key = f"__moments:{self.column}:{where_key(self.where)}"
        cached = inputs.get(memo_key)
        if cached is not None:
            return cached
        x = np.asarray(inputs[f"num:{self.column}"])
        valid = np.asarray(inputs[f"valid:{self.column}"])
        where = None if self.where is None else np.asarray(inputs[where_key(self.where)])
        out = None
        if x.dtype == np.float64 and valid.dtype == np.bool_ and (
            where is None or where.dtype == np.bool_
        ):
            out = native.masked_moments(x, valid, where)
        if out is not None:
            cached = {
                "count": float(out[0]),
                "sum": float(out[1]),
                "min": float(out[2]),
                "max": float(out[3]),
                "m2": float(out[4]),
                "n_where": float(out[5]),
                "n_rows": float(len(x)),
            }
        else:
            mask = valid.astype(bool) if where is None else (valid.astype(bool) & where.astype(bool))
            xm = np.asarray(x, dtype=np.float64)[mask]
            count = float(xm.size)
            total = float(xm.sum()) if xm.size else 0.0
            avg = total / max(count, 1.0)
            cached = {
                "count": count,
                "sum": total,
                "min": float(xm.min()) if xm.size else float("inf"),
                "max": float(xm.max()) if xm.size else float("-inf"),
                "m2": float(((xm - avg) ** 2).sum()) if xm.size else 0.0,
            }
        inputs[memo_key] = cached
        return cached

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        return _double_metric(self, state)


@dataclass(frozen=True)
class Mean(_NumericScanAnalyzer):
    """reference: analyzers/Mean.scala:36."""

    column: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "Mean"

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        mom = self._moments(inputs)
        return {"total": mom[1], "count": mom[0]}

    def merge_agg(self, a, b):
        return {"total": a["total"] + b["total"], "count": a["count"] + b["count"]}

    def state_from_aggregates(self, agg) -> Optional[State]:
        if int(agg["count"]) == 0:
            return None
        return MeanState(float(agg["total"]), int(agg["count"]))

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        mom = self._host_moments(inputs)
        return to_f64({"total": mom["sum"], "count": mom["count"]})

    def __repr__(self) -> str:
        return f"Mean({self.column},{render_where(self.where)})"


@dataclass(frozen=True)
class Sum(_NumericScanAnalyzer):
    """reference: analyzers/Sum.scala:36."""

    column: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "Sum"

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        mom = self._moments(inputs)
        return {"sum": mom[1], "count": mom[0]}

    def merge_agg(self, a, b):
        return {"sum": a["sum"] + b["sum"], "count": a["count"] + b["count"]}

    def state_from_aggregates(self, agg) -> Optional[State]:
        if int(agg["count"]) == 0:
            return None
        return SumState(float(agg["sum"]))

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        mom = self._host_moments(inputs)
        return to_f64({"sum": mom["sum"], "count": mom["count"]})

    def __repr__(self) -> str:
        return f"Sum({self.column},{render_where(self.where)})"


@dataclass(frozen=True)
class Minimum(_NumericScanAnalyzer):
    """reference: analyzers/Minimum.scala:36."""

    column: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "Minimum"

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        mom = self._moments(inputs)
        return {"min": mom[2], "count": mom[0]}

    def merge_agg(self, a, b):
        return {"min": np.minimum(a["min"], b["min"]), "count": a["count"] + b["count"]}

    def state_from_aggregates(self, agg) -> Optional[State]:
        if int(agg["count"]) == 0:
            return None
        return MinState(float(agg["min"]))

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        mom = self._host_moments(inputs)
        return to_f64({"min": mom["min"], "count": mom["count"]})

    def __repr__(self) -> str:
        return f"Minimum({self.column},{render_where(self.where)})"


@dataclass(frozen=True)
class Maximum(_NumericScanAnalyzer):
    """reference: analyzers/Maximum.scala:36."""

    column: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "Maximum"

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        mom = self._moments(inputs)
        return {"max": mom[3], "count": mom[0]}

    def merge_agg(self, a, b):
        return {"max": np.maximum(a["max"], b["max"]), "count": a["count"] + b["count"]}

    def state_from_aggregates(self, agg) -> Optional[State]:
        if int(agg["count"]) == 0:
            return None
        return MaxState(float(agg["max"]))

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        mom = self._host_moments(inputs)
        return to_f64({"max": mom["max"], "count": mom["count"]})

    def __repr__(self) -> str:
        return f"Maximum({self.column},{render_where(self.where)})"


@dataclass(frozen=True)
class StandardDeviation(_NumericScanAnalyzer):
    """Population stddev via per-batch centred moments + Chan merge
    (reference: analyzers/StandardDeviation.scala:47). The batch mean comes
    from the shared moments; the centred squares are a second read."""

    column: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "StandardDeviation"

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        mom = self._moments(inputs)
        n = mom[0]
        avg = mom[1] / n.clamp(min=1.0)
        m2 = cuda_kernels.masked_centered_sumsq(
            inputs[f"num:{self.column}"],
            _family_mask(inputs, self.column, self.where),
            avg,
        )
        return {"n": n, "avg": torch.where(n > 0, avg, 0.0), "m2": m2}

    def merge_agg(self, a, b):
        n = a["n"] + b["n"]
        safe_n = np.maximum(n, 1.0)
        delta = b["avg"] - a["avg"]
        avg = (a["n"] * a["avg"] + b["n"] * b["avg"]) / safe_n
        m2 = a["m2"] + b["m2"] + delta * delta * a["n"] * b["n"] / safe_n
        # an empty side is the identity bit for bit, as in
        # StandardDeviationState.merge: a scan that skips the batches no
        # row of which passes the where (row-group pruning) then folds
        # the same bits as one that folds them
        avg = np.where(a["n"] == 0, b["avg"], np.where(b["n"] == 0, a["avg"], avg))
        return {"n": n, "avg": np.where(n > 0, avg, 0.0), "m2": m2}

    def state_from_aggregates(self, agg) -> Optional[State]:
        if float(agg["n"]) == 0:
            return None
        return StandardDeviationState(float(agg["n"]), float(agg["avg"]), float(agg["m2"]))

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        mom = self._host_moments(inputs)
        n = mom["count"]
        return to_f64({"n": n, "avg": mom["sum"] / n if n > 0 else 0.0, "m2": mom["m2"]})

    def __repr__(self) -> str:
        return f"StandardDeviation({self.column},{render_where(self.where)})"


@dataclass(frozen=True)
class Correlation(ScanShareableAnalyzer):
    """Pearson r via per-batch centred co-moments + pairwise merge
    (reference: analyzers/Correlation.scala:65). Rows enter only when
    BOTH columns are non-null. Plain tensor ops: no TPU kernel served
    this analyzer, so none is ported for it."""

    first_column: str
    second_column: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "Correlation"

    @property
    def instance(self) -> str:
        return f"{self.first_column},{self.second_column}"

    @property
    def entity(self) -> Entity:
        return Entity.MULTICOLUMN

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [
            Preconditions.has_column(self.first_column),
            Preconditions.is_numeric(self.first_column),
            Preconditions.has_column(self.second_column),
            Preconditions.is_numeric(self.second_column),
        ]

    def input_specs(self) -> List[InputSpec]:
        return [
            col_values_spec(self.first_column),
            col_valid_spec(self.first_column),
            col_values_spec(self.second_column),
            col_valid_spec(self.second_column),
            where_spec(self.where),
        ]

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        x = inputs[f"num:{self.first_column}"]
        y = inputs[f"num:{self.second_column}"]
        m = (
            inputs[f"valid:{self.first_column}"]
            & inputs[f"valid:{self.second_column}"]
            & inputs[where_key(self.where)]
        ).to(x.dtype)
        n = m.sum()
        safe_n = n.clamp(min=1.0)
        x_avg = (x * m).sum() / safe_n
        y_avg = (y * m).sum() / safe_n
        xc = (x - x_avg) * m
        yc = (y - y_avg) * m
        return {
            "n": n,
            "x_avg": torch.where(n > 0, x_avg, 0.0),
            "y_avg": torch.where(n > 0, y_avg, 0.0),
            "ck": (xc * yc).sum(),
            "x_mk": (xc * xc).sum(),
            "y_mk": (yc * yc).sum(),
        }

    def merge_agg(self, a, b):
        n = a["n"] + b["n"]
        safe_n = np.maximum(n, 1.0)
        dx = b["x_avg"] - a["x_avg"]
        dy = b["y_avg"] - a["y_avg"]
        frac = b["n"] / safe_n
        cross = a["n"] * b["n"] / safe_n
        return {
            "n": n,
            "x_avg": a["x_avg"] + dx * frac,
            "y_avg": a["y_avg"] + dy * frac,
            "ck": a["ck"] + b["ck"] + dx * dy * cross,
            "x_mk": a["x_mk"] + b["x_mk"] + dx * dx * cross,
            "y_mk": a["y_mk"] + b["y_mk"] + dy * dy * cross,
        }

    def state_from_aggregates(self, agg) -> Optional[State]:
        if float(agg["n"]) == 0:
            return None
        return CorrelationState(
            float(agg["n"]),
            float(agg["x_avg"]),
            float(agg["y_avg"]),
            float(agg["ck"]),
            float(agg["x_mk"]),
            float(agg["y_mk"]),
        )

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        return _double_metric(self, state)

    def __repr__(self) -> str:
        return (
            f"Correlation({self.first_column},{self.second_column},"
            f"{render_where(self.where)})"
        )


# ---------------------------------------------------------------------------
# DataType
# ---------------------------------------------------------------------------


class DataTypeInstances:
    UNKNOWN = "Unknown"
    FRACTIONAL = "Fractional"
    INTEGRAL = "Integral"
    BOOLEAN = "Boolean"
    STRING = "String"


# the class code of a typed column's every present value
_STATIC_CLASS = {
    ColumnType.LONG: strings.CODE_INTEGRAL,
    ColumnType.DOUBLE: strings.CODE_FRACTIONAL,
    ColumnType.DECIMAL: strings.CODE_FRACTIONAL,
    ColumnType.BOOLEAN: strings.CODE_BOOLEAN,
    ColumnType.TIMESTAMP: strings.CODE_STRING,
}


def classified_dictionary(col) -> np.ndarray:
    """int8 class code per dictionary entry of a STRING column, once per
    table (the reference's regexes, catalyst/StatefulDataType.scala:36-38,
    run over the unique values only)."""
    return cached_dictionary_encode(
        col,
        "dtclassdict",
        lambda c: strings.classify(np.asarray(c.dict_encode()[1])).astype(np.int8),
    )


def _dtclass_spec(column: str) -> InputSpec:
    def compute(col) -> np.ndarray:
        if col.ctype == ColumnType.STRING:
            dict_codes, _uniques = col.dict_encode()
            return gather_with_null(
                classified_dictionary(col), dict_codes, strings.CODE_NULL
            )
        # typed columns classify statically from their stringified form
        return np.where(
            col.valid, np.int8(_STATIC_CLASS[col.ctype]), np.int8(strings.CODE_NULL)
        )

    def build(t: Table) -> np.ndarray:
        # column-deterministic: memoized per table, sliced per batch
        return cached_column_encode(t.column(column), "dtclass", compute)

    return InputSpec(key=f"dtclass:{column}", build=build, columns=(column,))


_CLASS_LABELS = ("null", "fractional", "integral", "boolean", "string")


@dataclass(frozen=True)
class DataType(ScanShareableAnalyzer):
    """Histogram over inferred value types; `determine_type` picks the
    majority type (reference: analyzers/DataType.scala:32-183). Rows
    excluded by `where` become NULL before classification, as
    conditionalSelection feeds the reference's UDAF, so they count as
    Unknown."""

    discrete_inputs = True  # code-only: host-foldable under placement
    column: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "Histogram"

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [Preconditions.has_column(self.column)]

    def input_specs(self) -> List[InputSpec]:
        return [_dtclass_spec(self.column), where_spec(self.where), where_spec(None)]

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        rows = inputs[where_key(None)]  # padded rows drop out
        codes = torch.where(
            inputs[where_key(self.where)],
            inputs[f"dtclass:{self.column}"],
            strings.CODE_NULL,
        )
        return {
            label: ((codes == code) & rows).sum()
            for code, label in enumerate(_CLASS_LABELS)
        }

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """One C bincount over the class codes (rows outside `where`
        count as NULL, padded rows drop out); with no filter and a
        `_LowCardCounts` member that counted this column's dictionary this
        batch, the dictionary's classes weighed by its counts instead."""
        rows = np.asarray(inputs[where_key(None)], dtype=bool)
        if self.where is None and counts_family.enabled():
            lcc = inputs.get(f"__lcccounts:{self.column}")
            if lcc is not None:
                counts, uniques, n_batch = lcc
                if n_batch == len(rows) and bool(rows.all()):
                    cls = self._classified_dictionary(inputs, uniques)
                    counts_vec = np.zeros(len(_CLASS_LABELS), dtype=np.int64)
                    np.add.at(counts_vec, cls, np.asarray(counts[1:]))
                    counts_vec[strings.CODE_NULL] += int(counts[0])
                    return to_f64(dict(zip(_CLASS_LABELS, counts_vec)))
        codes = np.asarray(inputs[f"dtclass:{self.column}"])
        w = np.asarray(inputs[where_key(self.where)], dtype=bool)
        w_all, rows_all = bool(w.all()), bool(rows.all())
        if w_all and rows_all:
            mask = None
        elif w_all:
            mask = rows
        elif rows_all:
            mask = w
        else:
            mask = w & rows
        counts_vec = native.bincount(codes, len(_CLASS_LABELS), where=mask)
        if counts_vec is None:
            counts_vec = np.bincount(
                codes if mask is None else codes[mask], minlength=len(_CLASS_LABELS)
            )
        if not w_all:
            # rows present but outside `where` classify as NULL
            n_rows = len(rows) if rows_all else int(np.count_nonzero(rows))
            counts_vec = counts_vec.copy()
            counts_vec[strings.CODE_NULL] += n_rows - int(counts_vec.sum())
        return to_f64(dict(zip(_CLASS_LABELS, counts_vec)))

    def _classified_dictionary(self, inputs, uniques) -> np.ndarray:
        """int8 class per dictionary entry: the table's memo when the
        batch is reachable, a direct classify otherwise."""
        batch = getattr(inputs, "batch", None)
        if batch is not None:
            cls = classified_dictionary(batch.column(self.column))
            if len(cls) == len(uniques):
                return cls
        return strings.classify(np.asarray(uniques)).astype(np.int8)

    def merge_agg(self, a, b):
        return {k: a[k] + b[k] for k in a}

    def state_from_aggregates(self, agg) -> Optional[State]:
        return DataTypeHistogram(*(int(agg[label]) for label in _CLASS_LABELS))

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(
                    f"Empty state for analyzer {self!r}, all input values were NULL."
                )
            )
        return HistogramMetric(
            Entity.COLUMN, self.name, self.column, Success(to_distribution(state))
        )

    def to_failure_metric(self, exception: BaseException) -> Metric:
        return HistogramMetric(
            Entity.COLUMN, self.name, self.column, Failure(wrap_if_necessary(exception))
        )

    def __repr__(self) -> str:
        return f"DataType({self.column},{render_where(self.where)})"


def to_distribution(hist: DataTypeHistogram) -> Distribution:
    """reference: analyzers/DataType.scala:100-115."""
    total = hist.total

    def entry(count: int) -> DistributionValue:
        return DistributionValue(count, count / total if total > 0 else float("nan"))

    return Distribution(
        {
            DataTypeInstances.UNKNOWN: entry(hist.num_null),
            DataTypeInstances.FRACTIONAL: entry(hist.num_fractional),
            DataTypeInstances.INTEGRAL: entry(hist.num_integral),
            DataTypeInstances.BOOLEAN: entry(hist.num_boolean),
            DataTypeInstances.STRING: entry(hist.num_string),
        },
        number_of_bins=5,
    )


def determine_type(dist: Distribution) -> str:
    """Majority-type decision tree (reference: analyzers/DataType.scala:116-146)."""

    def ratio_of(key: str) -> float:
        v = dist.values.get(key)
        return v.ratio if v is not None else 0.0

    if ratio_of(DataTypeInstances.UNKNOWN) == 1.0:
        return DataTypeInstances.UNKNOWN
    if ratio_of(DataTypeInstances.STRING) > 0.0 or (
        ratio_of(DataTypeInstances.BOOLEAN) > 0.0
        and (
            ratio_of(DataTypeInstances.INTEGRAL) > 0.0
            or ratio_of(DataTypeInstances.FRACTIONAL) > 0.0
        )
    ):
        return DataTypeInstances.STRING
    if ratio_of(DataTypeInstances.BOOLEAN) > 0.0:
        return DataTypeInstances.BOOLEAN
    if ratio_of(DataTypeInstances.FRACTIONAL) > 0.0:
        return DataTypeInstances.FRACTIONAL
    return DataTypeInstances.INTEGRAL
