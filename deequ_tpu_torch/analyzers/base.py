"""Analyzer core: compute a State from data and a Metric from the State.

reference: analyzers/Analyzer.scala:56-272. A scan-shareable analyzer
declares which named host arrays it needs (`input_specs`), a per-batch
reduction over those arrays as device tensors (`device_reduce`), the
same reduction over the host arrays for a host-fold placement
(`host_reduce`), and a host merge of two per-batch partials
(`merge_agg`). The fused pass runs every device-placed analyzer's
reduction over one shared set of device inputs per batch and every
host-placed one's over the batch's host arrays (ops/fused.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch.analyzers.states import State
from deequ_tpu_torch.core.exceptions import (
    EmptyStateException,
    NoColumnsSpecifiedException,
    NoSuchColumnException,
    NumberOfSpecifiedColumnsException,
    WrongColumnTypeException,
    wrap_if_necessary,
)
from deequ_tpu_torch.core.maybe import Failure
from deequ_tpu_torch.core.metrics import DoubleMetric, Entity, Metric
from deequ_tpu_torch.data.expr import Predicate
from deequ_tpu_torch.data.table import ColumnType, Table

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.state_provider import StateLoader, StatePersister


def render_where(where: Optional[str]) -> str:
    """Scala Option rendering — part of the analyzer identity string
    (reference: NullHandlingTests.scala:131-140)."""
    return f"Some({where})" if where is not None else "None"


def entity_from(columns: Sequence[str]) -> Entity:
    """reference: analyzers/Analyzer.scala:381-382."""
    return Entity.COLUMN if len(columns) == 1 else Entity.MULTICOLUMN


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
    def is_string(column: str) -> Callable[[Table], None]:
        def check(table: Table) -> None:
            ctype = table.column(column).ctype
            if ctype != ColumnType.STRING:
                raise WrongColumnTypeException(
                    f"Expected type of column {column} to be StringType, "
                    f"but found {ctype.value} instead!"
                )

        return check

    @staticmethod
    def at_least_one(columns: Sequence[str]) -> Callable[[Table], None]:
        def check(table: Table) -> None:
            if len(columns) == 0:
                raise NoColumnsSpecifiedException(
                    "At least one column needs to be specified!"
                )

        return check

    @staticmethod
    def exactly_n_columns(columns: Sequence[str], n: int) -> Callable[[Table], None]:
        def check(table: Table) -> None:
            if len(columns) != n:
                raise NumberOfSpecifiedColumnsException(
                    f"{n} columns have to be specified! "
                    f"Currently, columns contains only {len(columns)} column(s): "
                    f"{','.join(columns)}!"
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

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        """The metric of a state. A metric that reduces on a device (the
        frequency aggregations) does so on `device`, and a state given
        alone, with no device, reduces on the CPU; the others ignore it."""
        raise NotImplementedError

    def compute_state_from(self, table: Table, device=None) -> Optional[State]:
        """This analyzer's state over a whole table or source, on the
        resolved `device` where it folds on one."""
        raise NotImplementedError

    def calculate(
        self,
        table: Table,
        aggregate_with: Optional["StateLoader"] = None,
        save_states_with: Optional["StatePersister"] = None,
        device=None,
    ) -> Metric:
        """reference: Analyzer.scala:63-83. The device resolves as the
        runners resolve it: CUDA unless the caller asks for ``"cpu"``."""
        from deequ_tpu_torch.ops import runtime

        device = runtime.resolve_device(device)
        failing = Preconditions.find_first_failing(table, self.preconditions())
        if failing is not None:
            return self.to_failure_metric(failing)
        try:
            state = self.compute_state_from(table, device)
        except Exception as e:  # noqa: BLE001
            return self.to_failure_metric(e)
        return self.calculate_metric(state, aggregate_with, save_states_with, device)

    def calculate_metric(
        self,
        state: Optional[State],
        aggregate_with: Optional["StateLoader"] = None,
        save_states_with: Optional["StatePersister"] = None,
        device=None,
    ) -> Metric:
        """Merge in the loaded state, persist, then compute the metric on
        the resolved `device`."""
        from deequ_tpu_torch.ops import runtime

        device = runtime.resolve_device(device)
        if aggregate_with is not None:
            loaded = aggregate_with.load(self)
            if loaded is not None:
                state = loaded if state is None else loaded.merge(state)
        if save_states_with is not None and state is not None:
            save_states_with.persist(self, state)
        return self.compute_metric_from(state, device)

    def aggregate_state_to(
        self,
        source_a: "StateLoader",
        source_b: "StateLoader",
        target: "StatePersister",
    ) -> None:
        """reference: Analyzer.scala:130-147."""
        a = source_a.load(self)
        b = source_b.load(self)
        merged = a.merge(b) if (a is not None and b is not None) else (a or b)
        if merged is not None:
            target.persist(self, merged)

    def load_state_and_compute_metric(self, source: "StateLoader", device=None) -> Metric:
        """The metric of the loaded state, on the resolved `device`."""
        from deequ_tpu_torch.ops import runtime

        return self.compute_metric_from(source.load(self), runtime.resolve_device(device))

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
    device tensor. `columns` names the columns the build reads: a pass
    unions them to decode only those columns of a streamed source; None
    (unknown) turns that pruning off."""

    key: str
    build: Callable[[Table], np.ndarray]
    columns: Optional[Tuple[str, ...]] = None


def col_values_spec(column: str) -> InputSpec:
    return InputSpec(
        key=f"num:{column}",
        build=lambda t: t.column(column).numeric_values()[0],
        columns=(column,),
    )


def col_valid_spec(column: str) -> InputSpec:
    return InputSpec(
        key=f"valid:{column}",
        build=lambda t: t.column(column).valid,
        columns=(column,),
    )


def where_key(where: Optional[str]) -> str:
    return f"where:{where}" if where is not None else "where:<all>"


def where_spec(where: Optional[str]) -> InputSpec:
    """Row mask for an optional filter, NULL counting as False (SQL WHERE);
    None = all real rows. Padding rows are False either way (the
    conditionalSelection analogue, reference: Analyzer.scala:385-402)."""
    if where is None:
        return InputSpec(
            key=where_key(None),
            build=lambda t: np.ones(t.num_rows, dtype=np.bool_),
            columns=(),
        )
    pred = Predicate(where)
    return InputSpec(
        key=where_key(where),
        build=pred.eval_mask,
        columns=tuple(sorted(set(pred.referenced_columns()))),
    )


class TorchInputs(dict):
    """CPU tensor views of a batch's host inputs, each made on its first
    read: `device_reduce` run over them is the host fold of an analyzer
    with no host route of its own (on CPU tensors the kernel wrappers run
    their plain versions). Memo keys (``__``) are the reduction's own and
    never read through; a host input's build error is raised again."""

    def __init__(self, host: Dict[str, Any]):
        super().__init__()
        self._host = host

    def __missing__(self, key):
        if key.startswith("__"):
            raise KeyError(key)
        arr = np.asarray(self._host[key])
        # torch shares the numpy buffer; a read-only one is copied first
        value = torch.from_numpy(arr if arr.flags.writeable else arr.copy())
        self[key] = value
        return value

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default


def to_f64(partial: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """A partial as float64 numpy arrays, the layout the device route's
    packed copy gives (registers, counts and flags are exact in float64)."""
    return {
        key: (
            value.detach().to(torch.float64).numpy()
            if isinstance(value, torch.Tensor)
            else np.asarray(value, dtype=np.float64)
        )
        for key, value in partial.items()
    }


class ScanShareableAnalyzer(Analyzer):
    """An analyzer whose per-batch work is a masked reduction fused with
    the others into one device pass (reference: Analyzer.scala:159-216).

    `discrete_inputs` marks an analyzer whose inputs are masks or codes
    only: under the ``host-discrete`` placement it folds on the host."""

    discrete_inputs = False

    def input_specs(self) -> List[InputSpec]:
        raise NotImplementedError

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        """This batch's partial from its host arrays (ops/fused.py's
        HostInputs), in `device_reduce`'s layout as float64 arrays, so it
        merges through the same `merge_agg`. By default `device_reduce`
        over CPU tensor views; an analyzer with a C host route overrides."""
        return to_f64(self.device_reduce(TorchInputs(inputs)))

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

    def compute_state_from(self, table: Table, device=None) -> Optional[State]:
        """A one-analyzer fused pass (the JAX package's
        analyzers/base.py:377-380)."""
        from deequ_tpu_torch.ops.fused import FusedScanPass

        return FusedScanPass([self], device=device).run(table)[0].state_or_raise()
