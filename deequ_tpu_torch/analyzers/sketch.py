"""Sketch-based analyzers: bounded-memory approximations.

ApproxCountDistinct: the host hashes each value once into a packed
(register idx << 6 | rank) int32 code, the device folds a batch's codes
into 512 HLL registers (`cuda_kernels.hll_register_max`), and merging is
a register-wise max (reference: analyzers/ApproxCountDistinct.scala:47).

ApproxQuantile(s): per-batch KLL partial sketches. The device counts a
batch's sortable-key histogram (`cuda_kernels.hist16`); the host selects
the decimated sample from it and folds the sketches (reference:
analyzers/ApproxQuantile.scala:49, ApproxQuantiles.scala:39).

Under a host-fold placement (ops/runtime.py:placement_mode) both fold on
the host: ApproxCountDistinct (`discrete_inputs`, so already under
``host-discrete``) scatters the codes into its registers with the C
`hll_update_registers`, and a quantile sketch (under ``host-all``) takes
its sample by the C `masked_select_decimate`, the same values a full
sort decimates. Either first reads the memo a family kernel of the pass
filled for its (column, where) this batch (ops/fused.py).
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

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
from deequ_tpu_torch.analyzers.states import DoubleValuedState, State
from deequ_tpu_torch.core.exceptions import (
    EmptyStateException,
    IllegalAnalyzerParameterException,
    wrap_if_necessary,
)
from deequ_tpu_torch.core.maybe import Failure, Success
from deequ_tpu_torch.core.metrics import DoubleMetric, KeyedDoubleMetric, Metric
from deequ_tpu_torch.data.table import (
    ColumnType,
    Table,
    cached_column_encode,
    gather_with_null,
    hashed_dictionary,
)
from deequ_tpu_torch.ops import cuda_kernels, native
from deequ_tpu_torch.ops.sketches import hll
from deequ_tpu_torch.ops.sketches.kll import KLLSketch, k_for_error


@dataclass(frozen=True)
class ApproxCountDistinctState(DoubleValuedState):
    """HLL registers (reference: ApproxCountDistinct.scala:26 — merge is
    register-wise max)."""

    registers: np.ndarray

    def merge(self, other: "ApproxCountDistinctState") -> "ApproxCountDistinctState":
        return ApproxCountDistinctState(hll.merge_registers(self.registers, other.registers))

    def metric_value(self) -> float:
        return hll.estimate(self.registers)

    def words(self) -> np.ndarray:
        return hll.pack_words(self.registers)

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
        codes, _uniques = col.dict_encode()
        idx_u, rank_u = hll.registers_from_hashes(hashed_dictionary(col))
        return gather_with_null(((idx_u << 6) | rank_u).astype(np.int32), codes, 0)
    return hll.pack_codes(col.values, col.valid)


def _hll_spec(column: str) -> InputSpec:
    def build(t: Table) -> np.ndarray:
        # column-deterministic: hashed once per table, sliced per batch
        return cached_column_encode(t.column(column), "hll_packed", _packed_codes)

    return InputSpec(key=f"hll:{column}", build=build, columns=(column,))


@dataclass(frozen=True)
class ApproxCountDistinct(ScanShareableAnalyzer):
    """HLL++ distinct estimate (reference: analyzers/ApproxCountDistinct.scala:47)."""

    discrete_inputs = True  # packed idx|rank codes: host-foldable
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

    def host_reduce(self, inputs: Dict[str, Any]) -> Dict[str, np.ndarray]:
        # a family kernel's registers for this (column, where), if one ran
        # this batch: then the packed codes are never built
        regs = inputs.get(f"__hllregs:{self.column}:{where_key(self.where)}")
        if regs is None:
            packed = np.asarray(inputs[f"hll:{self.column}"])
            where = np.asarray(inputs[where_key(self.where)], dtype=bool)
            regs = np.zeros(hll.M, dtype=np.int32)
            if not native.hll_update_registers(packed, None if where.all() else where, regs):
                np.maximum.at(regs, packed >> 6, np.where(where, packed & 0x3F, 0).astype(np.int32))
        return to_f64({"registers": regs})

    def merge_agg(self, a, b):
        return {"registers": np.maximum(a["registers"], b["registers"])}

    def state_from_aggregates(self, agg) -> Optional[State]:
        return ApproxCountDistinctState(np.asarray(agg["registers"]).astype(np.int32))

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        if state is None:
            return self.empty_state_failure()
        return DoubleMetric(
            self.entity, self.name, self.instance, Success(state.metric_value())
        )

    def __repr__(self) -> str:
        return f"ApproxCountDistinct({self.column},{render_where(self.where)})"


# ---------------------------------------------------------------------------
# ApproxQuantile(s): device-assisted members of the fused pass
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ApproxQuantileState(State):
    """Mergeable quantile digest (reference: ApproxQuantile.scala:28-35)."""

    digest: KLLSketch

    def merge(self, other: "ApproxQuantileState") -> "ApproxQuantileState":
        return ApproxQuantileState(self.digest.merge(other.digest))

    def __eq__(self, other) -> bool:
        if not isinstance(other, ApproxQuantileState):
            return False
        k1, n1, l1 = self.digest.to_arrays()
        k2, n2, l2 = other.digest.to_arrays()
        return (
            k1 == k2
            and n1 == n2
            and len(l1) == len(l2)
            and all(np.array_equal(a, b) for a, b in zip(l1, l2))
        )

    def __hash__(self) -> int:
        return hash((self.digest.k, self.digest.n))


def _unit_interval_check(label: str, value: float) -> Callable[[Table], None]:
    def check(table: Table) -> None:
        if not (0.0 <= value <= 1.0):
            raise IllegalAnalyzerParameterException(
                f"{label} parameter must be in the closed interval [0, 1]. "
                f"Currently, the value is: {value}!"
            )

    return check


def _batch_seed(sample: np.ndarray, n: int, level: int) -> int:
    """Deterministic per-batch sketch seed from the batch's own decimated
    sample: distinct batches get decorrelated compaction offsets, and a
    scan's outcome depends only on its inputs and fold order. The same
    function as the JAX package's, so both build equal sketches."""
    h = zlib.crc32(np.ascontiguousarray(sample, dtype=np.float64).tobytes())
    return (h ^ (int(n) * 0x9E3779B1) ^ (int(level) << 17)) & 0x7FFFFFFF


_ZERO_BINS = [0x7FFF, 0x8000]  # the bins of -0.0 and +0.0


class _QuantileAnalyzerBase(ScanShareableAnalyzer):
    """Device-assisted member of the fused scan: the device counts the
    batch's 65536-bin histogram of sortable-key bins (`hist16`), the host
    walks the counts to the bins that own a decimation rank, gathers and
    sorts only those bins' float64 values from the batch it still holds,
    and inserts the decimated sample into a KLL sketch at its level
    (reference: catalyst/StatefulApproxQuantile.scala:28 — the mergeable
    digest role).

    One route on every device, and exact: rounding to float32 never
    reverses the order of two values, so bin order is value order, every
    rank's row lies in its bin, and the sample is the one a full float64
    sort of the batch would decimate — value for value. On the CPU the
    same route runs with `hist16`'s plain version."""

    device_assisted = True

    def _sample_size(self) -> int:
        # one level's worth: n/stride lands in (k, 2k]
        return 2 * k_for_error(self.relative_error)

    @property
    def _where(self) -> Optional[str]:
        return getattr(self, "where", None)

    def input_specs(self) -> List[InputSpec]:
        return [
            col_values_spec(self.column),
            col_valid_spec(self.column),
            where_spec(self._where),
        ]

    def device_batch(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """This batch's histogram, left on the device for the packed copy."""
        live = inputs[f"valid:{self.column}"] & inputs[where_key(self._where)]
        return {"hist16": cuda_kernels.hist16(inputs[f"num:{self.column}"], live)}

    def host_finish_batch(self, out: Dict[str, Any], host_inputs: Dict[str, np.ndarray]):
        """Walk the 65536 counts to the wanted decimation ranks, gather
        ONLY the owning bins' float64 values from the host batch, sort that
        sliver and read the sample off."""
        counts = np.asarray(out["hist16"], dtype=np.float64).reshape(cuda_kernels.HIST_BINS)
        # bins 65409..65535: the positive-NaN key region (no valid row
        # lands there: NaN is NULL) and the excluded rows' sentinel.
        # Bin 65408 is exactly +inf: kept.
        counts[65409:] = 0.0
        counts = counts.astype(np.int64)
        n = int(counts.sum())
        if n <= 0:
            return {"sample": np.zeros(0, dtype=np.float64), "n": 0, "level": 0}
        cap = self._sample_size()
        level = max(0, int(np.ceil(np.log2(max(n, 1) / cap))))
        stride = 1 << level
        offset = stride // 2
        kept = max(0, -(-(n - offset) // stride))
        ranks = offset + stride * np.arange(kept, dtype=np.int64)

        cum = np.cumsum(counts)
        bins_of_rank = np.searchsorted(cum, ranks, side="right")
        wanted = np.zeros(cuda_kernels.HIST_BINS, dtype=bool)
        wanted[bins_of_rank] = True
        # -0.0 and +0.0 are equal values in adjacent bins: take both, so
        # the stable sort below leaves zeros in row order, as a full
        # stable sort of the batch does
        wanted[_ZERO_BINS] = wanted[_ZERO_BINS].any()

        x = np.asarray(host_inputs[f"num:{self.column}"], dtype=np.float64)
        live = np.asarray(host_inputs[f"valid:{self.column}"], dtype=bool)
        if self._where is not None:
            live = live & np.asarray(host_inputs[where_key(self._where)], dtype=bool)
        # the kernel's binning, on the host: excluded rows land in bin
        # 65535, which owns no rank
        bins = cuda_kernels.f32_sortable_bin16_plain(
            torch.from_numpy(x).to(torch.float32), torch.from_numpy(live)
        ).numpy()
        gathered = np.sort(x[wanted[bins]], kind="stable")

        # rank within the gathered (wanted-bins-only) ordering: subtract
        # the mass of the unwanted bins below each rank's bin
        unwanted_cum = np.cumsum(counts * ~wanted)
        below = np.where(bins_of_rank > 0, unwanted_cum[bins_of_rank - 1], 0)
        return {"sample": gathered[ranks - below], "n": n, "level": level}

    def host_batch(self, inputs: Dict[str, Any]) -> Dict[str, Any]:
        """This batch's decimated sample from its host arrays (the
        ``host-all`` placement): a family kernel's memo when one ran for
        this (column, where) and sample size, else the C
        `masked_select_decimate`, else a sort of the live rows. All three
        give the sample the device route gives."""
        cap = self._sample_size()
        memo = inputs.get(f"__qsample:{self.column}:{where_key(self._where)}:{cap}")
        if memo is not None:
            return memo
        x = np.asarray(inputs[f"num:{self.column}"])
        valid = np.asarray(inputs[f"valid:{self.column}"], dtype=bool)
        where = None
        if self._where is not None:
            where = np.asarray(inputs[where_key(self._where)], dtype=bool)
        res = native.masked_select_decimate(x, valid, where, cap)
        if res is not None:
            sample, n, level = res
            return {"sample": sample, "n": n, "level": level}
        live = valid if where is None else valid & where
        xm = np.sort(np.asarray(x, dtype=np.float64)[live])
        n = len(xm)
        if n == 0:
            return {"sample": np.zeros(0, dtype=np.float64), "n": 0, "level": 0}
        level = max(0, int(np.ceil(np.log2(n / cap))))
        stride = 1 << level
        return {"sample": xm[stride // 2 :: stride][:cap], "n": n, "level": level}

    def host_consume(self, state: Optional[State], out: Dict[str, Any]) -> Optional[State]:
        n = int(out["n"])
        if n <= 0:
            return state
        level = int(out["level"])
        sample = np.asarray(out["sample"], dtype=np.float64)
        k = k_for_error(self.relative_error)
        sketch = KLLSketch(k=k, seed=_batch_seed(sample, n, level))
        sketch.insert_level(sample, level, true_count=n)
        partial = ApproxQuantileState(sketch)
        return partial if state is None else state.merge(partial)

    def _numeric_column_checks(self) -> List[Callable[[Table], None]]:
        return [
            _unit_interval_check("Relative error", self.relative_error),
            Preconditions.has_column(self.column),
            Preconditions.is_numeric(self.column),
        ]


@dataclass(frozen=True)
class ApproxQuantile(_QuantileAnalyzerBase):
    """Single quantile (reference: analyzers/ApproxQuantile.scala:49)."""

    column: str
    quantile: float
    relative_error: float = 0.01
    where: Optional[str] = None

    @property
    def name(self) -> str:
        return "ApproxQuantile"

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [_unit_interval_check("Quantile", self.quantile)] + self._numeric_column_checks()

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        if state is None:
            return self.empty_state_failure()
        return DoubleMetric(
            self.entity, self.name, self.instance, Success(state.digest.quantile(self.quantile))
        )

    def __repr__(self) -> str:
        # `where` extends the reference signature (ApproxQuantile.scala:49
        # has no filter): rendered only when set, so the default matches
        # the reference toString
        base = f"ApproxQuantile({self.column},{self.quantile},{self.relative_error}"
        if self.where is not None:
            return base + f",{render_where(self.where)})"
        return base + ")"


@dataclass(frozen=True)
class ApproxQuantiles(_QuantileAnalyzerBase):
    """Many quantiles from one digest -> KeyedDoubleMetric
    (reference: analyzers/ApproxQuantiles.scala:39)."""

    column: str
    quantiles: Tuple[float, ...]
    relative_error: float = 0.01

    def __init__(self, column: str, quantiles, relative_error: float = 0.01):
        object.__setattr__(self, "column", column)
        object.__setattr__(self, "quantiles", tuple(quantiles))
        object.__setattr__(self, "relative_error", relative_error)

    @property
    def name(self) -> str:
        return "ApproxQuantiles"

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [
            _unit_interval_check("Quantile", q) for q in self.quantiles
        ] + self._numeric_column_checks()

    def compute_metric_from(self, state: Optional[State], device=None) -> Metric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(
                    f"Empty state for analyzer {self!r}, all input values were NULL."
                )
            )
        values = state.digest.quantiles(list(self.quantiles))
        keyed = {_format_quantile(q): v for q, v in zip(self.quantiles, values)}
        return KeyedDoubleMetric(self.entity, self.name, self.instance, Success(keyed))

    def to_failure_metric(self, exception: BaseException) -> Metric:
        return KeyedDoubleMetric(
            self.entity, self.name, self.instance, Failure(wrap_if_necessary(exception))
        )

    def __repr__(self) -> str:
        qs = ", ".join(_format_quantile(q) for q in self.quantiles)
        return f"ApproxQuantiles({self.column},List({qs}),{self.relative_error})"


def _format_quantile(q: float) -> str:
    return repr(float(q))
