"""ColumnProfiler: full single-column profiles in at most three scans.

reference: profiles/ColumnProfiler.scala:54-669, whose passes are:
  1. Size, and per column Completeness and ApproxCountDistinct (and
     DataType for strings): one fused pass;
  2. for numeric columns (schema-numeric, or strings inferred numeric
     and cast on the host) Minimum, Maximum, Mean, StandardDeviation,
     Sum and ApproxQuantiles(0.01..1.00): one fused pass;
  3. exact histograms of the low-cardinality string and boolean columns:
     one counting pass.

As in the JAX package, a schema-numeric column's numeric statistics do
not depend on pass 1, so they ride pass 1; so do two host-only members
(profiles/internal_analyzers.py) that count low-cardinality values and
compute a string column's numeric statistics speculatively. Pass 2 runs
only for a numeric-looking string column whose speculation died, and
pass 3 only for a column whose counts were cut off. On the device pass 1
runs all four kernels: masked_moments and masked_centered_sumsq for the
numeric family, hll_register_max for every column's distinct count and
hist16 for each numeric column's quantiles.

The profile runs on CUDA unless the caller passes ``device="cpu"``. Over
a streamed source pass 2 casts batch by batch (a `MappedSource`) and the
histogram pass counts batch by batch, keyed by value.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantiles,
    Completeness,
    DataType,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers.scan import DataTypeInstances, determine_type
from deequ_tpu_torch.core.metrics import Distribution, DistributionValue
from deequ_tpu_torch.data.table import Column, ColumnType, Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.profiles.column_profile import (
    ColumnProfiles,
    NumericColumnProfile,
    StandardColumnProfile,
)
from deequ_tpu_torch.profiles.internal_analyzers import (
    LowCardCountsState,
    OptimisticNumericState,
    _LowCardCounts,
    _OptimisticNumericStats,
    synthesize_numeric_metrics,
)
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from deequ_tpu_torch.runners.context import AnalyzerContext

DEFAULT_CARDINALITY_THRESHOLD = 120

_PERCENTILES = tuple(i / 100 for i in range(1, 101))


def _numeric_stat_analyzers(name: str) -> List:
    """The numeric-statistics bundle of the reference's pass 2
    (ColumnProfiler.scala:219-235)."""
    return [
        Minimum(name),
        Maximum(name),
        Mean(name),
        StandardDeviation(name),
        Sum(name),
        ApproxQuantiles(name, _PERCENTILES),
    ]


@dataclass
class GenericColumnStatistics:
    num_records: int
    inferred_types: Dict[str, str]
    known_types: Dict[str, str]
    type_detection_histograms: Dict[str, Dict[str, int]]
    approximate_num_distincts: Dict[str, int]
    completenesses: Dict[str, float]

    def type_of(self, column: str) -> str:
        if column in self.inferred_types:
            return self.inferred_types[column]
        return self.known_types[column]


class ColumnProfiler:
    @staticmethod
    def profile(
        data: Table,
        restrict_to_columns: Optional[Sequence[str]] = None,
        print_status_updates: bool = False,
        low_cardinality_histogram_threshold: int = DEFAULT_CARDINALITY_THRESHOLD,
        metrics_repository=None,
        reuse_existing_results_for_key=None,
        fail_if_results_missing: bool = False,
        save_in_metrics_repository_using_key=None,
        engine: str = "auto",
        mesh=None,
        device: runtime.DeviceLike = None,
    ) -> ColumnProfiles:
        """reference: ColumnProfiler.scala:81-188. Every pass takes the
        metrics repository options (reference: :128-153) and the engine
        (runners/engine.py: "auto", "single", or "distributed" over
        `mesh`)."""
        device = runtime.resolve_device(device)
        relevant = (
            list(restrict_to_columns) if restrict_to_columns is not None else data.column_names
        )
        for name in relevant:
            data.column(name)  # raises NoSuchColumnException early

        # ---- Pass 1 (reference: :103-126) ---------------------------------
        may_need_pass2 = any(data.column(name).ctype == ColumnType.STRING for name in relevant)
        total_passes = 3 if may_need_pass2 else 2
        if print_status_updates:
            print(
                "### PROFILING: Computing generic column statistics in "
                f"pass (1/{total_passes})..."
            )
        # the count cap leaves the HLL estimate (rsd 0.05) generous
        # headroom over the histogram threshold
        lcc_cap = max(4 * low_cardinality_histogram_threshold, 256)
        analyzers_pass1 = [Size()]
        for name in relevant:
            analyzers_pass1.append(Completeness(name))
            analyzers_pass1.append(ApproxCountDistinct(name))
            ctype = data.column(name).ctype
            if ctype == ColumnType.STRING:
                analyzers_pass1.append(DataType(name))
                analyzers_pass1.append(_LowCardCounts(name, lcc_cap))
                analyzers_pass1.append(_OptimisticNumericStats(name))
            elif ctype == ColumnType.BOOLEAN:
                analyzers_pass1.append(_LowCardCounts(name, lcc_cap))
            elif ctype.is_numeric:
                analyzers_pass1.extend(_numeric_stat_analyzers(name))

        def run_pass(table, analyzers) -> AnalyzerContext:
            builder = (
                AnalysisRunner.on_data(table, device)
                .add_analyzers(analyzers)
                .with_engine(engine, mesh)
            )
            if metrics_repository is not None:
                builder = builder.use_repository(metrics_repository)
                if reuse_existing_results_for_key is not None:
                    builder = builder.reuse_existing_results_for_key(
                        reuse_existing_results_for_key, fail_if_results_missing
                    )
                if save_in_metrics_repository_using_key is not None:
                    builder = builder.save_or_append_result(save_in_metrics_repository_using_key)
            return builder.run()

        results_pass1 = run_pass(data, analyzers_pass1)

        generic_stats = _extract_generic_statistics(relevant, data, results_pass1)
        low_card_counts: Dict[str, LowCardCountsState] = {}
        optimistic_numeric: Dict[str, OptimisticNumericState] = {}
        for analyzer, metric in results_pass1.metric_map.items():
            if not metric.value.is_success:
                continue
            state = metric.value.get()
            if isinstance(analyzer, _LowCardCounts) and isinstance(state, LowCardCountsState):
                if not state.aborted:
                    low_card_counts[analyzer.column] = state
            elif isinstance(analyzer, _OptimisticNumericStats) and isinstance(
                state, OptimisticNumericState
            ):
                if state.usable:
                    optimistic_numeric[analyzer.column] = state

        # ---- Pass 2 (reference: :128-153, cast at :399-417) ---------------
        # only for inferred-numeric STRING columns whose speculative
        # statistics died
        cast_columns = [
            name
            for name in relevant
            if name in generic_stats.inferred_types
            and generic_stats.type_of(name)
            in (DataTypeInstances.INTEGRAL, DataTypeInstances.FRACTIONAL)
        ]
        combined = results_pass1
        # pass 1's optimistic statistics replace pass 2 where they lived;
        # with a reuse key pass 2 keeps the repository's short cut
        synthesized: Dict = {}
        if reuse_existing_results_for_key is None:
            for name in list(cast_columns):
                state = optimistic_numeric.get(name)
                if state is not None:
                    synthesized.update(synthesize_numeric_metrics(name, state, _PERCENTILES))
                    cast_columns.remove(name)
        if synthesized:
            synthesized_ctx = AnalyzerContext(synthesized)
            combined = combined + synthesized_ctx
            if metrics_repository is not None and save_in_metrics_repository_using_key is not None:
                AnalysisRunner._save_or_append(
                    metrics_repository, save_in_metrics_repository_using_key, synthesized_ctx
                )
        analyzers_pass2 = []
        for name in cast_columns:
            analyzers_pass2.extend(_numeric_stat_analyzers(name))
        if analyzers_pass2:
            if print_status_updates:
                print(
                    "### PROFILING: Computing numeric column statistics "
                    f"in pass (2/{total_passes})..."
                )
            casted_data = _cast_numeric_string_columns(cast_columns, data)
            combined = combined + run_pass(casted_data, analyzers_pass2)
        numeric_stats = _extract_numeric_statistics(combined)

        # ---- Pass 3 (reference: :487-565) ---------------------------------
        # normally answered by pass 1's _LowCardCounts; a counting pass
        # runs only for a column whose exact distinct count blew the cap
        # while its HLL estimate still cleared the threshold
        target_columns = _find_target_columns_for_histograms(
            data, generic_stats, low_cardinality_histogram_threshold
        )
        histograms: Dict[str, Distribution] = {}
        stragglers = []
        for name in target_columns:
            state = low_card_counts.get(name)
            if state is None:
                stragglers.append(name)
                continue
            histograms[name] = _distribution_from_counts(
                data.column(name).ctype,
                state.as_dict(),
                state.null_count,
                generic_stats.num_records,
            )
        if stragglers:
            if print_status_updates:
                print(
                    "### PROFILING: Computing histograms of low-cardinality "
                    f"columns in pass ({total_passes}/{total_passes})..."
                )
            histograms.update(_compute_histograms(data, stragglers, generic_stats.num_records))

        return _create_profiles(relevant, generic_stats, numeric_stats, histograms)


def _extract_generic_statistics(
    columns: Sequence[str], data: Table, results: AnalyzerContext
) -> GenericColumnStatistics:
    """reference: ColumnProfiler.scala:341-396."""
    num_records = 0
    inferred_types: Dict[str, str] = {}
    type_detection: Dict[str, Dict[str, int]] = {}
    approx_distincts: Dict[str, int] = {}
    completenesses: Dict[str, float] = {}

    for analyzer, metric in results.metric_map.items():
        if not metric.value.is_success:
            continue
        if isinstance(analyzer, Size):
            num_records = int(metric.value.get())
        elif isinstance(analyzer, DataType):
            dist = metric.value.get()
            inferred_types[analyzer.column] = determine_type(dist)
            type_detection[analyzer.column] = {
                key: dv.absolute for key, dv in dist.values.items()
            }
        elif isinstance(analyzer, ApproxCountDistinct):
            approx_distincts[analyzer.column] = int(metric.value.get())
        elif isinstance(analyzer, Completeness):
            completenesses[analyzer.column] = metric.value.get()

    known_types: Dict[str, str] = {}
    for name, ctype in data.schema:
        if name not in columns or ctype == ColumnType.STRING:
            continue
        known_types[name] = {
            ColumnType.LONG: DataTypeInstances.INTEGRAL,
            ColumnType.DOUBLE: DataTypeInstances.FRACTIONAL,
            ColumnType.DECIMAL: DataTypeInstances.FRACTIONAL,
            ColumnType.BOOLEAN: DataTypeInstances.BOOLEAN,
            ColumnType.TIMESTAMP: DataTypeInstances.STRING,
        }[ctype]

    return GenericColumnStatistics(
        num_records,
        inferred_types,
        known_types,
        type_detection,
        approx_distincts,
        completenesses,
    )


def _cast_numeric_string_columns(columns: Sequence[str], data: Table) -> Table:
    """The inferred-numeric string columns cast to DOUBLE for pass 2
    (reference: ColumnProfiler.scala:329-339, 399-417); a value that does
    not parse becomes NULL. Over a streamed source the cast is a lazy
    per-batch transform."""
    to_cast = list(columns)

    def cast_batch(batch: Table) -> Table:
        out = batch
        for name in to_cast:
            if not batch.has_column(name):
                continue  # a column-pruned batch: nothing to cast
            values, valid = batch.column(name).numeric_values()
            out = out.with_column(Column(name, ColumnType.DOUBLE, values, valid))
        return out

    if getattr(data, "is_streaming", False):
        from deequ_tpu_torch.data.source import MappedSource

        return MappedSource(
            data,
            cast_batch,
            schema_overrides=[(name, ColumnType.DOUBLE) for name in to_cast],
            # cast_batch rewrites the columns it reads in place, so it
            # needs no base columns beyond those the pass asks for
            fn_columns=(),
        )
    return cast_batch(data)


@dataclass
class NumericColumnStatistics:
    means: Dict[str, float] = field(default_factory=dict)
    maxima: Dict[str, float] = field(default_factory=dict)
    minima: Dict[str, float] = field(default_factory=dict)
    sums: Dict[str, float] = field(default_factory=dict)
    std_devs: Dict[str, float] = field(default_factory=dict)
    approx_percentiles: Dict[str, List[float]] = field(default_factory=dict)


def _extract_numeric_statistics(results: AnalyzerContext) -> NumericColumnStatistics:
    stats = NumericColumnStatistics()
    by_type = {
        Mean: stats.means,
        Maximum: stats.maxima,
        Minimum: stats.minima,
        Sum: stats.sums,
        StandardDeviation: stats.std_devs,
    }
    for analyzer, metric in results.metric_map.items():
        if not metric.value.is_success:
            continue
        if isinstance(analyzer, ApproxQuantiles):
            keyed = metric.value.get()
            stats.approx_percentiles[analyzer.column] = [
                keyed[k] for k in sorted(keyed, key=float)
            ]
        elif type(analyzer) in by_type:
            by_type[type(analyzer)][analyzer.column] = metric.value.get()
    return stats


def _find_target_columns_for_histograms(
    data: Table, stats: GenericColumnStatistics, threshold: int
) -> List[str]:
    """String and boolean columns with an approximate distinct count at
    most `threshold` (reference: ColumnProfiler.scala:487-516)."""
    out = []
    for name, count in stats.approximate_num_distincts.items():
        if data.column(name).ctype not in (ColumnType.STRING, ColumnType.BOOLEAN):
            continue
        if stats.type_of(name) not in (DataTypeInstances.STRING, DataTypeInstances.BOOLEAN):
            continue
        if count <= threshold:
            out.append(name)
    return out


def _distribution_from_counts(
    ctype: ColumnType, counts: Dict, null_count: int, num_records: int
) -> Distribution:
    """Exact value counts in the reference's Distribution shape: the null
    bucket is named 'NullValue', booleans are 'true'/'false'
    (reference: Histogram.scala:108, ColumnProfiler.scala:523-565)."""
    values: Dict[str, DistributionValue] = {}
    if null_count > 0:
        values["NullValue"] = DistributionValue(null_count, null_count / num_records)
    for unique, count in counts.items():
        if ctype == ColumnType.BOOLEAN:
            key = "true" if unique else "false"
        else:
            key = str(unique)
        prev = values.get(key)
        if prev is not None:
            count = count + prev.absolute
        values[key] = DistributionValue(count, count / num_records)
    return Distribution(values, number_of_bins=len(values))


def _compute_histograms(
    data: Table, target_columns: Sequence[str], num_records: int
) -> Dict[str, Distribution]:
    """One exact counting pass over all target columns
    (reference: ColumnProfiler.scala:523-565). A streamed source folds
    per-batch counts keyed by value (each batch has its own dictionary),
    so host memory is O(distinct values)."""
    if not target_columns:
        return {}
    runtime.record_group_pass("profiler-histograms:" + ",".join(target_columns))
    if hasattr(data, "with_columns"):
        data = data.with_columns(list(target_columns))
    totals: Dict[str, Dict[str, int]] = {name: {} for name in target_columns}
    null_counts: Dict[str, int] = {name: 0 for name in target_columns}

    def accumulate(batch: Table) -> None:
        from deequ_tpu_torch.ops import native

        for name in target_columns:
            col = batch.column(name)
            codes, uniques = col.dict_encode()
            counts = native.bincount(codes, len(uniques) + 1, base=1)
            if counts is None:
                counts = np.bincount(codes + 1, minlength=len(uniques) + 1)
            null_counts[name] += int(counts[0])
            bucket = totals[name]
            for i, unique in enumerate(uniques):
                if counts[i + 1] == 0:
                    continue
                if col.ctype == ColumnType.BOOLEAN:
                    key = "true" if unique else "false"
                else:
                    key = str(unique)
                bucket[key] = bucket.get(key, 0) + int(counts[i + 1])

    if getattr(data, "is_streaming", False):
        for batch in data.batches(data.batch_rows):
            accumulate(batch)
    else:
        accumulate(data)
    histograms: Dict[str, Distribution] = {}
    for name in target_columns:
        values: Dict[str, DistributionValue] = {}
        if null_counts[name] > 0:
            values["NullValue"] = DistributionValue(
                null_counts[name], null_counts[name] / num_records
            )
        for key, count in totals[name].items():
            values[key] = DistributionValue(count, count / num_records)
        histograms[name] = Distribution(values, number_of_bins=len(values))
    return histograms


def _create_profiles(
    columns: Sequence[str],
    generic_stats: GenericColumnStatistics,
    numeric_stats: NumericColumnStatistics,
    histograms: Dict[str, Distribution],
) -> ColumnProfiles:
    """reference: ColumnProfiler.scala:617-669."""
    profiles = {}
    for name in columns:
        common = dict(
            column=name,
            completeness=generic_stats.completenesses.get(name, 0.0),
            approximate_num_distinct_values=generic_stats.approximate_num_distincts.get(name, 0),
            data_type=generic_stats.type_of(name),
            is_data_type_inferred=name in generic_stats.inferred_types,
            type_counts=generic_stats.type_detection_histograms.get(name, {}),
            histogram=histograms.get(name),
        )
        if common["data_type"] in (DataTypeInstances.INTEGRAL, DataTypeInstances.FRACTIONAL):
            profiles[name] = NumericColumnProfile(
                **common,
                mean=numeric_stats.means.get(name),
                maximum=numeric_stats.maxima.get(name),
                minimum=numeric_stats.minima.get(name),
                sum=numeric_stats.sums.get(name),
                std_dev=numeric_stats.std_devs.get(name),
                approx_percentiles=numeric_stats.approx_percentiles.get(name),
            )
        else:
            profiles[name] = StandardColumnProfile(**common)
    return ColumnProfiles(profiles, generic_stats.num_records)
