"""Frequency-based (grouping) analyzers.

The frequency computation is the engine's group-by:
  SELECT cols, COUNT(*) FROM data WHERE all cols NOT NULL GROUP BY cols
(reference: analyzers/GroupingAnalyzers.scala:44-81). On the host, columns
are dictionary-encoded and combined with ravel_multi_index, so the
group-by is one vectorized np.unique over dense codes; the aggregations
over the resulting counts (uniqueness, distinctness, entropy, ...) run
as one set of tensor reductions on the run's device, shared by every
analyzer on the same grouping columns (ops/freq_agg.py; reference:
AnalysisRunner.scala:466-534).

State merge is a key-aligned counts sum — the dict analogue of the
reference's null-safe outer join (GroupingAnalyzers.scala:128-148). A
streamed source folds batch by batch through `GroupCountAccumulator`,
which spills to disk past a group cap (analyzers/freq_spill.py).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers.base import Preconditions, entity_from
from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer
from deequ_tpu_torch.analyzers.states import State
from deequ_tpu_torch.core.maybe import Success
from deequ_tpu_torch.core.metrics import DoubleMetric, Entity, Metric
from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.observe import counters


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------


class FrequenciesAndNumRows(State):
    """Group keys + counts + overall #rows
    (reference: GroupingAnalyzers.scala:124-157).

    Keys are stored columnar (one object array per grouping column,
    aligned with ``counts``); ``keys`` exposes the row-tuple view."""

    __slots__ = ("columns", "key_columns", "counts", "num_rows")

    def __init__(self, columns, key_columns, counts, num_rows: int):
        self.columns: List[str] = list(columns)
        if len(key_columns) != len(self.columns):
            raise ValueError(
                f"{len(key_columns)} key columns for grouping columns {self.columns}"
            )
        self.key_columns = [np.asarray(k, dtype=object) for k in key_columns]
        self.counts = np.asarray(counts, dtype=np.int64)
        self.num_rows = int(num_rows)

    @property
    def keys(self) -> List[Tuple]:
        return list(zip(*[kc.tolist() for kc in self.key_columns])) if len(self.counts) else []

    @property
    def num_groups(self) -> int:
        return len(self.counts)

    def merge(self, other) -> "FrequenciesAndNumRows":
        if getattr(other, "is_spilled", False):
            return other.merge(self)  # the spilled side knows how
        if sorted(self.columns) != sorted(other.columns):
            raise ValueError(
                f"cannot merge frequencies over {self.columns} with {other.columns}"
            )
        # align by column name (the columnar analogue of the reference's
        # name-based outer join)
        other_cols = [other.key_columns[other.columns.index(c)] for c in self.columns]
        key_columns, counts = _group_sum(
            [np.concatenate([mine, theirs]) for mine, theirs in zip(self.key_columns, other_cols)],
            np.concatenate([self.counts, other.counts]),
        )
        return FrequenciesAndNumRows(
            self.columns, key_columns, counts, self.num_rows + other.num_rows
        )

    def compacted(self) -> "FrequenciesAndNumRows":
        """Duplicate key rows summed (a spill partition's compaction)."""
        key_columns, counts = _group_sum(self.key_columns, self.counts)
        return FrequenciesAndNumRows(self.columns, key_columns, counts, self.num_rows)

    def __eq__(self, other) -> bool:
        if not isinstance(other, FrequenciesAndNumRows):
            return False
        return (
            self.columns == other.columns
            and self.num_rows == other.num_rows
            and dict(zip(self.keys, self.counts.tolist()))
            == dict(zip(other.keys, other.counts.tolist()))
        )

    def __repr__(self) -> str:
        return (
            f"FrequenciesAndNumRows({self.columns}, groups={self.num_groups}, "
            f"num_rows={self.num_rows})"
        )


def _group_sum(
    key_columns: List[np.ndarray], counts: np.ndarray
) -> Tuple[List[np.ndarray], np.ndarray]:
    """Sum counts over identical key rows, in first-appearance order (the
    reference's null-safe outer join + count sum,
    GroupingAnalyzers.scala:128-148): a hash group-by over the groups,
    never a pass over rows."""
    import pandas as pd

    n_cols = len(key_columns)
    frame = {f"k{j}": key_columns[j] for j in range(n_cols)}
    frame["__count"] = counts
    grouped = (
        pd.DataFrame(frame)
        .groupby([f"k{j}" for j in range(n_cols)], sort=False, dropna=False)["__count"]
        .sum()
    )
    index = grouped.index
    if n_cols == 1:
        out_keys = [index.to_numpy(dtype=object)]
    else:
        out_keys = [index.get_level_values(j).to_numpy(dtype=object) for j in range(n_cols)]
    return out_keys, grouped.to_numpy(dtype=np.int64)


def top_n_order(keys: np.ndarray, counts: np.ndarray, n: int) -> np.ndarray:
    """Indices of the top-n groups by (count desc, key asc): the
    deterministic tie-break of Histogram's detail bins (the reference's
    rdd.top leaves tie order partition-dependent)."""
    counts = np.asarray(counts)
    if len(counts) == 0 or n <= 0:
        return np.array([], dtype=np.int64)
    keys_u = np.asarray(keys).astype(str)  # U-dtype: vectorized sort
    return np.lexsort((keys_u, -counts))[:n]


def _column_key_values(col) -> Tuple[np.ndarray, np.ndarray]:
    """(codes, uniques) with uniques as python-friendly scalars."""
    codes, uniques = col.dict_encode()
    if col.ctype == ColumnType.LONG:
        uniques = np.array([int(u) for u in uniques], dtype=object)
    elif col.ctype in (ColumnType.DOUBLE, ColumnType.DECIMAL):
        uniques = np.array([float(u) for u in uniques], dtype=object)
    elif col.ctype == ColumnType.BOOLEAN:
        uniques = np.array([bool(u) for u in uniques], dtype=object)
    else:
        uniques = np.asarray(uniques, dtype=object)
    return codes, uniques


def compute_frequencies(
    data: Table, grouping_columns: Sequence[str], num_rows: Optional[int] = None, mesh=None
) -> FrequenciesAndNumRows:
    """reference: GroupingAnalyzers.scala:53-80. Rows where ANY grouping
    column is NULL are excluded from groups; num_rows counts all rows.
    An in-memory table is one host pass; a streamed source folds batch by
    batch through `GroupCountAccumulator`, so host memory is O(groups)
    below the cap and bounded above it (the disk spill). With a `mesh`
    (parallel/distributed.py) a code space of at most _MAX_DEVICE_BINS
    groups is counted row-sharded on its devices (`sharded_bincount`).
    Traced, the `group_pass` span says whether the groups `spilled`."""
    with observe.span("group_pass", cat="group", columns=",".join(grouping_columns)) as sp:
        counters.record_group_pass(",".join(grouping_columns))
        state = _compute_frequencies(data, grouping_columns, num_rows, mesh)
        if sp:
            # whether the disk spill (its `spill_*` spans) holds the groups
            sp.set(spilled=not isinstance(state, FrequenciesAndNumRows))
        return state


def _compute_frequencies(
    data: Table, grouping_columns: Sequence[str], num_rows: Optional[int], mesh
) -> FrequenciesAndNumRows:
    if hasattr(data, "with_columns"):
        data = data.with_columns(list(grouping_columns))
    if getattr(data, "is_streaming", False):
        from deequ_tpu_torch.analyzers.freq_spill import GroupCountAccumulator

        acc = GroupCountAccumulator(grouping_columns)
        for batch in data.batches(data.batch_rows):
            acc.add(_frequencies_of_batch(batch, grouping_columns, mesh))
        state = acc.finalize()
    else:
        state = _frequencies_of_batch(data, grouping_columns, mesh)
    if num_rows is not None:
        state.num_rows = num_rows
    return state


# a raveled group-code space larger than this counts on the host
# (np.unique), as in the JAX package
_MAX_DEVICE_BINS = 1 << 20


def _frequencies_of_batch(
    data: Table, grouping_columns: Sequence[str], mesh=None
) -> FrequenciesAndNumRows:
    cols = [data.column(name) for name in grouping_columns]
    valid = np.ones(data.num_rows, dtype=np.bool_)
    for col in cols:
        valid &= col.valid

    if not valid.any():
        return FrequenciesAndNumRows(
            grouping_columns,
            [np.array([], dtype=object) for _ in cols],
            np.array([], dtype=np.int64),
            data.num_rows,
        )

    encoded = [_column_key_values(col) for col in cols]
    dims = [max(len(u), 1) for _, u in encoded]
    code_arrays = [np.where(valid, c, 0) for c, _ in encoded]
    combined_all = np.ravel_multi_index(code_arrays, dims)
    total_bins = int(np.prod(dims))
    if mesh is not None and total_bins <= _MAX_DEVICE_BINS:
        from deequ_tpu_torch.parallel.distributed import sharded_bincount

        bin_counts = sharded_bincount(np.where(valid, combined_all, -1), total_bins, mesh)
        unique_codes = np.nonzero(bin_counts)[0]
        counts = bin_counts[unique_codes]
    else:
        unique_codes, counts = np.unique(combined_all[valid], return_counts=True)
    unraveled = np.unravel_index(unique_codes, dims)
    # per-column gather of group-key values: one fancy-index per column
    key_columns = [encoded[j][1][unraveled[j]] for j in range(len(cols))]
    return FrequenciesAndNumRows(grouping_columns, key_columns, counts, data.num_rows)


# ---------------------------------------------------------------------------
# Analyzer bases
# ---------------------------------------------------------------------------


class FrequencyBasedAnalyzer(GroupingAnalyzer):
    """reference: GroupingAnalyzers.scala:28-41."""

    def grouping_columns(self) -> List[str]:
        return list(self.columns)

    @property
    def instance(self) -> str:
        return ",".join(self.columns)

    @property
    def entity(self) -> Entity:
        return entity_from(self.columns)

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [Preconditions.at_least_one(self.columns)] + [
            Preconditions.has_column(c) for c in self.columns
        ]

    def compute_state_from(self, table: Table, device=None) -> Optional[FrequenciesAndNumRows]:
        return compute_frequencies(table, self.grouping_columns())


class ScanShareableFrequencyBasedAnalyzer(FrequencyBasedAnalyzer):
    """Aggregations over the shared frequencies table
    (reference: GroupingAnalyzers.scala:84-121). `freq_reduce` is tensor
    ops over the float64 counts, on whichever device holds them: every
    analyzer of a grouping set runs over one copy (ops/freq_agg.py)."""

    def freq_reduce(self, counts: torch.Tensor, num_rows: torch.Tensor) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def metric_from_freq_agg(self, agg: Dict[str, float], state: FrequenciesAndNumRows) -> Metric:
        raise NotImplementedError

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows], device=None) -> Metric:
        """The shared aggregation of this one analyzer, on `device`: a run
        passes its own, and a state given alone reduces on the CPU."""
        if state is None:
            return self.empty_state_failure()
        from deequ_tpu_torch.ops.freq_agg import run_shared_freq_agg

        device = torch.device("cpu" if device is None else device)
        return run_shared_freq_agg(state, [self], device)[0]

    def to_success_metric(self, value: float) -> DoubleMetric:
        return DoubleMetric(self.entity, self.name, self.instance, Success(value))


# ---------------------------------------------------------------------------
# Concrete frequency analyzers
# ---------------------------------------------------------------------------


def _single_or_seq(columns) -> List[str]:
    if isinstance(columns, str):
        return [columns]
    return list(columns)


def _scala_list_repr(columns: Sequence[str]) -> str:
    return f"List({', '.join(columns)})"


def _count_where(mask: torch.Tensor) -> torch.Tensor:
    return mask.to(torch.float64).sum()


class Uniqueness(ScanShareableFrequencyBasedAnalyzer):
    """Fraction of values occurring exactly once
    (reference: analyzers/Uniqueness.scala:26)."""

    def __init__(self, columns):
        self.columns = _single_or_seq(columns)

    @property
    def name(self) -> str:
        return "Uniqueness"

    def freq_reduce(self, counts, num_rows):
        return {"unique": _count_where(counts == 1)}

    def metric_from_freq_agg(self, agg, state) -> Metric:
        if state.num_groups == 0:
            return self.empty_state_failure()  # SQL sum over empty -> NULL
        return self.to_success_metric(float(agg["unique"]) / state.num_rows)

    def __repr__(self) -> str:
        return f"Uniqueness({_scala_list_repr(self.columns)})"


class Distinctness(ScanShareableFrequencyBasedAnalyzer):
    """Fraction of distinct values (reference: analyzers/Distinctness.scala:29)."""

    def __init__(self, columns):
        self.columns = _single_or_seq(columns)

    @property
    def name(self) -> str:
        return "Distinctness"

    def freq_reduce(self, counts, num_rows):
        return {"distinct": _count_where(counts >= 1)}

    def metric_from_freq_agg(self, agg, state) -> Metric:
        if state.num_groups == 0:
            return self.empty_state_failure()
        return self.to_success_metric(float(agg["distinct"]) / state.num_rows)

    def __repr__(self) -> str:
        return f"Distinctness({_scala_list_repr(self.columns)})"


class UniqueValueRatio(ScanShareableFrequencyBasedAnalyzer):
    """#unique / #distinct groups (reference: analyzers/UniqueValueRatio.scala:25)."""

    def __init__(self, columns):
        self.columns = _single_or_seq(columns)

    @property
    def name(self) -> str:
        return "UniqueValueRatio"

    def freq_reduce(self, counts, num_rows):
        return {"unique": _count_where(counts == 1), "groups": _count_where(counts >= 1)}

    def metric_from_freq_agg(self, agg, state) -> Metric:
        if state.num_groups == 0:
            return self.empty_state_failure()
        return self.to_success_metric(float(agg["unique"]) / float(agg["groups"]))

    def __repr__(self) -> str:
        return f"UniqueValueRatio({_scala_list_repr(self.columns)})"


class CountDistinct(ScanShareableFrequencyBasedAnalyzer):
    """#groups; count(*) never nulls, so empty -> 0.0
    (reference: analyzers/CountDistinct.scala:24)."""

    def __init__(self, columns):
        self.columns = _single_or_seq(columns)

    @property
    def name(self) -> str:
        return "CountDistinct"

    def freq_reduce(self, counts, num_rows):
        return {"groups": _count_where(counts >= 1)}

    def metric_from_freq_agg(self, agg, state) -> Metric:
        return self.to_success_metric(float(agg["groups"]))

    def __repr__(self) -> str:
        return f"CountDistinct({_scala_list_repr(self.columns)})"


class Entropy(ScanShareableFrequencyBasedAnalyzer):
    """-sum (c/N)·ln(c/N) with N = total rows incl. nulls, exactly like the
    reference's UDF over group counts (reference: analyzers/Entropy.scala:28-41)."""

    def __init__(self, column: str):
        self.columns = [column]

    @property
    def name(self) -> str:
        return "Entropy"

    def freq_reduce(self, counts, num_rows):
        p = counts / num_rows.clamp(min=1.0)
        safe_p = torch.where(p > 0, p, 1.0)
        return {"entropy": torch.where(p > 0, -safe_p * torch.log(safe_p), 0.0).sum()}

    def metric_from_freq_agg(self, agg, state) -> Metric:
        if state.num_groups == 0:
            return self.empty_state_failure()
        return self.to_success_metric(float(agg["entropy"]))

    def __repr__(self) -> str:
        # Scala: case class Entropy(column: String)
        return f"Entropy({self.columns[0]})"


class MutualInformation(FrequencyBasedAnalyzer):
    """sum pxy·ln(pxy/(px·py)) over the joint frequencies; NOT shareable
    (joins marginals — reference: analyzers/MutualInformation.scala:35-90).
    A host pass over the groups after the shared aggregation."""

    def __init__(self, column_a, column_b=None):
        if column_b is None:
            self.columns = _single_or_seq(column_a)
        else:
            self.columns = [column_a, column_b]

    @property
    def name(self) -> str:
        return "MutualInformation"

    @property
    def entity(self) -> Entity:
        return Entity.MULTICOLUMN

    def preconditions(self) -> List[Callable[[Table], None]]:
        return [Preconditions.exactly_n_columns(self.columns, 2)] + super().preconditions()

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows], device=None) -> Metric:
        if state is None or state.num_groups == 0:
            return self.empty_state_failure()
        counters.record_pass("freq-agg:MutualInformation")
        total = state.num_rows
        # state columns may be sorted differently than self.columns
        ia = state.columns.index(self.columns[0])
        ib = state.columns.index(self.columns[1])
        if getattr(state, "is_spilled", False):
            value = _spilled_mutual_information(state, ia, ib, total)
            return DoubleMetric(self.entity, self.name, self.instance, Success(value))
        keys_a = state.key_columns[ia]
        keys_b = state.key_columns[ib]
        counts = state.counts.astype(np.float64)

        _, codes_a = np.unique(keys_a.astype(str), return_inverse=True)
        _, codes_b = np.unique(keys_b.astype(str), return_inverse=True)
        marg_a = np.bincount(codes_a, weights=counts)
        marg_b = np.bincount(codes_b, weights=counts)

        pxy = counts / total
        px = marg_a[codes_a] / total
        py = marg_b[codes_b] / total
        value = float(np.sum(pxy * np.log(pxy / (px * py))))
        return DoubleMetric(self.entity, self.name, self.instance, Success(value))

    def __repr__(self) -> str:
        return f"MutualInformation({_scala_list_repr(self.columns)})"


def _spilled_mutual_information(state, ia: int, ib: int, total: int) -> float:
    """Two passes over a spilled state's partitions: the marginal counts
    (memory O(|A| + |B|), far below the joint groups), then the joint sum
    in partition order."""
    marg_a: Dict[str, float] = {}
    marg_b: Dict[str, float] = {}
    for part in state.partitions():
        counts = part.counts.astype(np.float64)
        for keys, marg in ((part.key_columns[ia], marg_a), (part.key_columns[ib], marg_b)):
            uniq, inv = np.unique(keys.astype(str), return_inverse=True)
            for u, c in zip(uniq, np.bincount(inv, weights=counts)):
                marg[u] = marg.get(u, 0.0) + c
    value = 0.0
    for part in state.partitions():
        pxy = part.counts.astype(np.float64) / total
        ua, inv_a = np.unique(part.key_columns[ia].astype(str), return_inverse=True)
        ub, inv_b = np.unique(part.key_columns[ib].astype(str), return_inverse=True)
        px = np.array([marg_a[u] for u in ua])[inv_a] / total
        py = np.array([marg_b[u] for u in ub])[inv_b] / total
        value += float(np.sum(pxy * np.log(pxy / (px * py))))
    return value
