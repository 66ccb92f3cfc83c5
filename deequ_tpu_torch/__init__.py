"""deequ_tpu_torch: data-quality verification ("unit tests for data") on
PyTorch and CUDA.

The PyTorch counterpart of `deequ_tpu`. A verification run packs each
batch of an in-memory table into a compact wire format, folds it on the
GPU in one fused pass whose numeric moments, HLL registers and quantile
histograms run as hand-written CUDA kernels (ops/cuda_kernels.py,
csrc/kernels.cu), groups the frequency analyzers' columns on the host
and aggregates their counts on the GPU, and judges the checks'
constraints on the host. Runs use CUDA unless the caller passes
``device="cpu"``.

    from deequ_tpu_torch import Check, CheckLevel, Table, VerificationSuite

    result = (
        VerificationSuite.on_data(table)
        .add_check(Check(CheckLevel.ERROR, "x").is_complete("x"))
        .run()
    )

`ColumnProfilerRunner.on_data(table).run()` profiles every column (types,
completeness, distinct counts, numeric statistics, histograms of the
low-cardinality columns), and `ConstraintSuggestionRunner` turns such a
profile into suggested checks.

Every entry point also takes a streamed source in place of a table:
`Table.scan_parquet(path)` for one Parquet file and
`Table.scan_parquet_dataset(directory)` for a dataset of partition files
(data/source.py), read in bounded batches on a decode thread while the
GPU folds the batch before.

Runs keep what they computed: state providers (`aggregate_with`,
`save_states_with`), metrics repositories (`use_repository`,
`save_or_append_result`, `reuse_existing_results_for_key`) and, over a
partitioned dataset, a partition-state repository
(`with_state_repository`) with which a rerun scans only its new
partitions (deequ_tpu_torch/repository/).

Before a run scans a row, a static pass (deequ_tpu_torch/lint/) checks
the plan and predicts its cost; `explain_plan(table, analyzers, checks)`
renders that prediction. Over a Parquet file it also proves from the
row-group statistics which groups no where filter can match, and the
scan skips them unread.
"""

from deequ_tpu_torch.checks.check import Check, CheckLevel, CheckStatus
from deequ_tpu_torch.constraints.constrainable_data_types import ConstrainableDataTypes
from deequ_tpu_torch.core.maybe import Failure, Success, Try
from deequ_tpu_torch.core.metrics import (
    Distribution,
    DistributionValue,
    DoubleMetric,
    Entity,
    HistogramMetric,
    KeyedDoubleMetric,
    Metric,
)
from deequ_tpu_torch.data.table import Column, ColumnType, Table
from deequ_tpu_torch.lint.explain import explain_plan
from deequ_tpu_torch.profiles.runner import ColumnProfilerRunner
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from deequ_tpu_torch.suggestions.rules import Rules
from deequ_tpu_torch.suggestions.runner import ConstraintSuggestionRunner
from deequ_tpu_torch.verification.result import VerificationResult
from deequ_tpu_torch.verification.suite import VerificationSuite

__all__ = [
    "AnalysisRunner",
    "Check",
    "CheckLevel",
    "CheckStatus",
    "Column",
    "ColumnProfilerRunner",
    "ColumnType",
    "ConstrainableDataTypes",
    "ConstraintSuggestionRunner",
    "Distribution",
    "DistributionValue",
    "DoubleMetric",
    "Entity",
    "Failure",
    "HistogramMetric",
    "KeyedDoubleMetric",
    "Metric",
    "Rules",
    "Success",
    "Table",
    "Try",
    "VerificationResult",
    "VerificationSuite",
    "explain_plan",
]
