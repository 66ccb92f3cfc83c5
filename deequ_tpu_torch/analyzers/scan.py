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

reference: analyzers/Size.scala, Completeness.scala, Mean.scala,
Sum.scala, Minimum.scala, Maximum.scala, StandardDeviation.scala,
Correlation.scala.
"""

from __future__ import annotations

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
    where_key,
    where_spec,
)
from deequ_tpu_torch.analyzers.states import (
    CorrelationState,
    MaxState,
    MeanState,
    MinState,
    NumMatches,
    NumMatchesAndCount,
    StandardDeviationState,
    State,
    SumState,
)
from deequ_tpu_torch.core.maybe import Success
from deequ_tpu_torch.core.metrics import DoubleMetric, Entity, Metric
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import cuda_kernels


def _double_metric(analyzer: ScanShareableAnalyzer, state: Optional[State]) -> Metric:
    if state is None:
        return analyzer.empty_state_failure()
    return DoubleMetric(
        analyzer.entity, analyzer.name, analyzer.instance, Success(state.metric_value())
    )


# ---------------------------------------------------------------------------
# Size
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Size(ScanShareableAnalyzer):
    """# rows, optionally filtered (reference: analyzers/Size.scala:36)."""

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

    def merge_agg(self, a, b):
        return {"n": a["n"] + b["n"]}

    def state_from_aggregates(self, agg) -> Optional[State]:
        return NumMatches(int(agg["n"]))

    def compute_metric_from(self, state: Optional[State]) -> Metric:
        return _double_metric(self, state)

    def __repr__(self) -> str:
        return f"Size({render_where(self.where)})"


# ---------------------------------------------------------------------------
# Completeness
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Completeness(ScanShareableAnalyzer):
    """Fraction non-NULL (reference: analyzers/Completeness.scala:26).

    The guard mirrors SQL `sum` nullability: the state is empty exactly
    when no row was scanned (`isNotNull(...)` is never NULL)."""

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

    def input_specs(self) -> List[InputSpec]:
        return [col_valid_spec(self.column), where_spec(self.where), where_spec(None)]

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        w = inputs[where_key(self.where)]
        return {
            "matches": (inputs[f"valid:{self.column}"] & w).sum(),
            "count": w.sum(),
            "guard": inputs[where_key(None)].sum(),
        }

    def merge_agg(self, a, b):
        return {k: a[k] + b[k] for k in ("matches", "count", "guard")}

    def state_from_aggregates(self, agg) -> Optional[State]:
        if int(agg["guard"]) == 0:
            return None
        return NumMatchesAndCount(int(agg["matches"]), int(agg["count"]))

    def compute_metric_from(self, state: Optional[State]) -> Metric:
        return _double_metric(self, state)

    def __repr__(self) -> str:
        return f"Completeness({self.column},{render_where(self.where)})"


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

    def compute_metric_from(self, state: Optional[State]) -> Metric:
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
        return {"n": n, "avg": np.where(n > 0, avg, 0.0), "m2": m2}

    def state_from_aggregates(self, agg) -> Optional[State]:
        if float(agg["n"]) == 0:
            return None
        return StandardDeviationState(float(agg["n"]), float(agg["avg"]), float(agg["m2"]))

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

    def compute_metric_from(self, state: Optional[State]) -> Metric:
        return _double_metric(self, state)

    def __repr__(self) -> str:
        return (
            f"Correlation({self.first_column},{self.second_column},"
            f"{render_where(self.where)})"
        )
