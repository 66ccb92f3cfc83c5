"""Analyzer core: compute a State from data and a Metric from the State.

reference: analyzers/Analyzer.scala:56-272. A scan-shareable analyzer
declares which named host arrays it needs (`input_specs`), a per-batch
reduction over those arrays as device tensors (`device_reduce`), and a
host merge of two per-batch partials (`merge_agg`). The fused pass runs
every analyzer's reduction over one shared set of device inputs per
batch (ops/fused.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.analyzers.states import State
from deequ_tpu_torch.core.exceptions import (
    EmptyStateException,
    NoSuchColumnException,
    WrongColumnTypeException,
    wrap_if_necessary,
)
from deequ_tpu_torch.core.maybe import Failure
from deequ_tpu_torch.core.metrics import DoubleMetric, Entity, Metric
from deequ_tpu_torch.data.table import ColumnType, Table


def render_where(where: Optional[str]) -> str:
    """Scala Option rendering — part of the analyzer identity string
    (reference: NullHandlingTests.scala:131-140)."""
    return f"Some({where})" if where is not None else "None"


# ---------------------------------------------------------------------------
# Preconditions (reference: analyzers/Analyzer.scala:275-335)
# ---------------------------------------------------------------------------

NUMERIC_TYPES = (ColumnType.LONG, ColumnType.DOUBLE, ColumnType.DECIMAL)


class Preconditions:
    @staticmethod
    def has_column(column: str) -> Callable[[Table], None]:
        def check(table: Table) -> None:
            if not table.has_column(column):
                raise NoSuchColumnException(
                    f"Input data does not include column {column}!"
                )

        return check

    @staticmethod
    def is_numeric(column: str) -> Callable[[Table], None]:
        def check(table: Table) -> None:
            ctype = table.column(column).ctype
            if ctype not in NUMERIC_TYPES:
                raise WrongColumnTypeException(
                    f"Expected type of column {column} to be one of "
                    f"(ByteType,ShortType,IntegerType,LongType,FloatType,"
                    f"DoubleType,DecimalType), but found {ctype.value} instead!"
                )

        return check

    @staticmethod
    def find_first_failing(
        table: Table, checks: Sequence[Callable[[Table], None]]
    ) -> Optional[BaseException]:
        for check in checks:
            try:
                check(table)
            except Exception as e:  # noqa: BLE001
                return e
        return None


# ---------------------------------------------------------------------------
# Analyzer
# ---------------------------------------------------------------------------


class Analyzer:
    """Computes a State from data and a Metric from the State
    (reference: analyzers/Analyzer.scala:56-155)."""

    @property
    def name(self) -> str:
        raise NotImplementedError

    @property
    def instance(self) -> str:
        raise NotImplementedError

    @property
    def entity(self) -> Entity:
        return Entity.COLUMN

    def preconditions(self) -> List[Callable[[Table], None]]:
        return []

    def compute_metric_from(self, state: Optional[State]) -> Metric:
        raise NotImplementedError

    def to_failure_metric(self, exception: BaseException) -> Metric:
        return DoubleMetric(
            self.entity, self.name, self.instance,
            Failure(wrap_if_necessary(exception)),
        )

    def empty_state_failure(self) -> Metric:
        return self.to_failure_metric(
            EmptyStateException(
                f"Empty state for analyzer {self!r}, all input values were NULL."
            )
        )

    # analyzers are used as dict keys; identity is their repr
    def __eq__(self, other) -> bool:
        return type(self) is type(other) and repr(self) == repr(other)

    def __hash__(self) -> int:
        return hash(repr(self))


# ---------------------------------------------------------------------------
# Scan-shareable analyzers: the fused-pass device protocol
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class InputSpec:
    """One named host-prepped array. Keys are deduplicated across the
    analyzers of a pass: two analyzers over the same column share one
    device tensor."""

    key: str
    build: Callable[[Table], np.ndarray]


def col_values_spec(column: str) -> InputSpec:
    return InputSpec(
        key=f"num:{column}",
        build=lambda t: t.column(column).numeric_values()[0],
    )


def col_valid_spec(column: str) -> InputSpec:
    return InputSpec(
        key=f"valid:{column}",
        build=lambda t: t.column(column).valid,
    )


def where_key(where: Optional[str]) -> str:
    return f"where:{where}" if where is not None else "where:<all>"


def where_spec(where: Optional[str]) -> InputSpec:
    """Row mask for an optional filter; None = all real rows (padding rows
    are False). Filter predicates are not ported yet."""
    if where is not None:
        raise NotImplementedError(
            f"where predicates are not ported yet (where={where!r})"
        )
    return InputSpec(
        key=where_key(None),
        build=lambda t: np.ones(t.num_rows, dtype=np.bool_),
    )


class ScanShareableAnalyzer(Analyzer):
    """An analyzer whose per-batch work is a masked reduction fused with
    the others into one device pass (reference: Analyzer.scala:159-216)."""

    def input_specs(self) -> List[InputSpec]:
        raise NotImplementedError

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """Named device tensors -> this batch's partial aggregate, a dict
        of tensors that stay on the device until the pass's one packed
        copy to the host."""
        raise NotImplementedError

    def merge_agg(self, a: Dict[str, Any], b: Dict[str, Any]) -> Dict[str, Any]:
        """Semigroup combine of two host (numpy float64) partials."""
        raise NotImplementedError

    def state_from_aggregates(self, agg: Dict[str, Any]) -> Optional[State]:
        """Folded host partial -> State; None = empty state."""
        raise NotImplementedError
