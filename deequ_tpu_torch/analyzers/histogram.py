"""Histogram analyzer: full value distribution with top-N detail bins.

reference: analyzers/Histogram.scala:38-116. Unlike the frequency
analyzers it keeps NULL rows (as the "NullValue" bin) and stringifies
values the way Spark's cast-to-string does. A host group-by over the
column's dictionary codes; `has_number_of_distinct_values` reads its
bin count.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from deequ_tpu_torch.analyzers.base import Analyzer, Preconditions
from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows, top_n_order
from deequ_tpu_torch.core.exceptions import (
    EmptyStateException,
    IllegalAnalyzerParameterException,
    wrap_if_necessary,
)
from deequ_tpu_torch.core.maybe import Failure, Try
from deequ_tpu_torch.core.metrics import (
    Distribution,
    DistributionValue,
    Entity,
    HistogramMetric,
    Metric,
)
from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.observe import counters

NULL_FIELD_REPLACEMENT = "NullValue"
MAXIMUM_ALLOWED_DETAIL_BINS = 1000


def _stringify(value, ctype: ColumnType) -> str:
    """Spark cast-to-string conventions for typed column values."""
    if ctype == ColumnType.BOOLEAN:
        return "true" if value else "false"
    if ctype == ColumnType.LONG:
        return str(int(value))
    if ctype in (ColumnType.DOUBLE, ColumnType.DECIMAL):
        return str(float(value))
    return str(value)


def _stringify_any(value) -> str:
    """Stringify by the VALUE's type: a binning udf may map numeric input
    to arbitrary labels."""
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, (int, np.integer)):
        return str(int(value))
    if isinstance(value, (float, np.floating)):
        return str(float(value))
    return str(value)


class Histogram(Analyzer):
    """Not scan-shareable: the runner computes it on its own
    (`Analyzer.calculate`), as the JAX package does."""

    def __init__(
        self,
        column: str,
        binning_udf: Optional[Callable] = None,
        max_detail_bins: int = MAXIMUM_ALLOWED_DETAIL_BINS,
    ):
        self.column = column
        self.binning_udf = binning_udf
        self.max_detail_bins = max_detail_bins

    @property
    def name(self) -> str:
        return "Histogram"

    @property
    def instance(self) -> str:
        return self.column

    def preconditions(self) -> List[Callable[[Table], None]]:
        def param_check(table: Table) -> None:
            if self.max_detail_bins > MAXIMUM_ALLOWED_DETAIL_BINS:
                raise IllegalAnalyzerParameterException(
                    "Cannot return histogram values for more than "
                    f"{MAXIMUM_ALLOWED_DETAIL_BINS} values"
                )

        return [param_check, Preconditions.has_column(self.column)]

    def compute_state_from(self, table: Table, device=None) -> Optional[FrequenciesAndNumRows]:
        counters.record_group_pass(f"histogram:{self.column}")
        if hasattr(table, "with_columns"):
            table = table.with_columns([self.column])
        if getattr(table, "is_streaming", False):
            # the bounded fold of compute_frequencies, with its disk spill:
            # a high-cardinality column must not hold every group in memory
            from deequ_tpu_torch.analyzers.freq_spill import GroupCountAccumulator

            acc = GroupCountAccumulator([self.column])
            for batch in table.batches(table.batch_rows):
                acc.add(self._state_of_batch(batch))
            return acc.finalize()
        return self._state_of_batch(table)

    def _state_of_batch(self, table: Table) -> FrequenciesAndNumRows:
        col = table.column(self.column)
        if self.binning_udf is None:
            # group on dictionary codes, stringify only the unique values
            from deequ_tpu_torch.ops import native

            codes, uniques = col.dict_encode()
            group_counts = native.bincount(codes, len(uniques) + 1, base=1)
            if group_counts is None:
                group_counts = np.bincount(codes + 1, minlength=len(uniques) + 1)
            labels = [NULL_FIELD_REPLACEMENT] + [_stringify(u, col.ctype) for u in uniques]
            label_totals: Dict[str, int] = {}
            for label, count in zip(labels, group_counts):
                if count > 0:
                    label_totals[label] = label_totals.get(label, 0) + int(count)
            keys = np.array(list(label_totals), dtype=object)
            counts = np.array(list(label_totals.values()), dtype=np.int64)
        else:
            values = np.array(
                [
                    _stringify_any(self.binning_udf(v)) if ok else NULL_FIELD_REPLACEMENT
                    for v, ok in zip(col.values, col.valid)
                ],
                dtype=str,
            )
            keys, counts = np.unique(values, return_counts=True)
        return FrequenciesAndNumRows([self.column], [keys], counts, table.num_rows)

    def compute_metric_from(self, state: Optional[FrequenciesAndNumRows], device=None) -> Metric:
        if state is None:
            return self.to_failure_metric(
                EmptyStateException(
                    f"Empty state for analyzer {self!r}, all input values were NULL."
                )
            )

        def build() -> Distribution:
            if getattr(state, "is_spilled", False):
                # the exact global top-N from each partition's top-N
                top_keys, top_counts = state.top_n(self.max_detail_bins)
                keys, counts = top_keys[0], top_counts
            else:
                # (count desc, key asc): a deterministic tie-break
                order = top_n_order(state.key_columns[0], state.counts, self.max_detail_bins)
                keys, counts = state.key_columns[0][order], state.counts[order]
            details = {
                value: DistributionValue(int(absolute), int(absolute) / state.num_rows)
                for value, absolute in zip(keys, counts)
            }
            return Distribution(details, number_of_bins=state.num_groups)

        return HistogramMetric(Entity.COLUMN, self.name, self.column, Try.of(build))

    def to_failure_metric(self, exception: BaseException) -> Metric:
        return HistogramMetric(
            Entity.COLUMN, self.name, self.column, Failure(wrap_if_necessary(exception))
        )

    def __repr__(self) -> str:
        udf = "None" if self.binning_udf is None else f"Some({self.binning_udf})"
        return f"Histogram({self.column},{udf},{self.max_detail_bins})"
