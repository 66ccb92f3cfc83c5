"""ApproxCountDistinct: the host hashes each value once into a packed
(register idx << 6 | rank) int32 code, the device folds a batch's codes
into 512 HLL registers (`cuda_kernels.hll_register_max`), and merging is
a register-wise max (reference: analyzers/ApproxCountDistinct.scala:47).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from deequ_tpu_torch.analyzers.base import (
    InputSpec,
    Preconditions,
    ScanShareableAnalyzer,
    render_where,
    where_key,
    where_spec,
)
from deequ_tpu_torch.analyzers.states import DoubleValuedState, State
from deequ_tpu_torch.core.maybe import Success
from deequ_tpu_torch.core.metrics import DoubleMetric, Metric
from deequ_tpu_torch.data.table import ColumnType, Table, cached_column_encode, gather_with_null
from deequ_tpu_torch.ops import cuda_kernels
from deequ_tpu_torch.ops.sketches import hll


@dataclass(frozen=True)
class ApproxCountDistinctState(DoubleValuedState):
    """HLL registers (reference: ApproxCountDistinct.scala:26 — merge is
    register-wise max)."""

    registers: np.ndarray

    def merge(self, other: "ApproxCountDistinctState") -> "ApproxCountDistinctState":
        return ApproxCountDistinctState(hll.merge_registers(self.registers, other.registers))

    def metric_value(self) -> float:
        return hll.estimate(self.registers)

    def __eq__(self, other) -> bool:
        return isinstance(other, ApproxCountDistinctState) and np.array_equal(
            self.registers, other.registers
        )

    def __hash__(self) -> int:
        return hash(self.registers.tobytes())


def _packed_codes(col) -> np.ndarray:
    """One int32 per row packing (register idx << 6 | rank); null rows
    pack to 0 (idx 0, rank 0 — a no-op for the register max)."""
    if col.ctype == ColumnType.STRING:
        # hash the dictionary's unique strings only, gather to rows
        from deequ_tpu_torch.ops.strings import hash_strings

        codes, uniques = col.dict_encode()
        idx_u, rank_u = hll.registers_from_hashes(
            hash_strings(np.asarray(uniques, dtype=object))
        )
        return gather_with_null(((idx_u << 6) | rank_u).astype(np.int32), codes, 0)
    return hll.pack_codes(col.values, col.valid)


def _hll_spec(column: str) -> InputSpec:
    def build(t: Table) -> np.ndarray:
        # column-deterministic: hashed once per table, sliced per batch
        return cached_column_encode(t.column(column), "hll_packed", _packed_codes)

    return InputSpec(key=f"hll:{column}", build=build)


@dataclass(frozen=True)
class ApproxCountDistinct(ScanShareableAnalyzer):
    """HLL++ distinct estimate (reference: analyzers/ApproxCountDistinct.scala:47)."""

    column: str
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "ApproxCountDistinct"

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [Preconditions.has_column(self.column)]

    def input_specs(self) -> List[InputSpec]:
        return [_hll_spec(self.column), where_spec(self.where)]

    def device_reduce(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "registers": cuda_kernels.hll_register_max(
                inputs[f"hll:{self.column}"], inputs[where_key(self.where)]
            )
        }

    def merge_agg(self, a, b):
        return {"registers": np.maximum(a["registers"], b["registers"])}

    def state_from_aggregates(self, agg) -> Optional[State]:
        return ApproxCountDistinctState(np.asarray(agg["registers"]).astype(np.int32))

    def compute_metric_from(self, state: Optional[State]) -> Metric:
        if state is None:
            return self.empty_state_failure()
        return DoubleMetric(
            self.entity, self.name, self.instance, Success(state.metric_value())
        )

    def __repr__(self) -> str:
        return f"ApproxCountDistinct({self.column},{render_where(self.where)})"
