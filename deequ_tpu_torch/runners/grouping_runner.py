"""Grouping-analyzer execution: one frequency computation per distinct
grouping-column set, shared by every analyzer over it, plus one shared
aggregation over the resulting counts on the run's device.

reference: runners/AnalysisRunner.scala:164-180 (grouping by column set),
:249-277 (runGroupingAnalyzers), :466-534 (shared aggregation over the
frequencies table). N analyzers on the same grouping columns cost one
group-by and one shared aggregation, not N of each.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import torch

from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers.frequency import (
    FrequencyBasedAnalyzer,
    ScanShareableFrequencyBasedAnalyzer,
    compute_frequencies,
)
from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer
from deequ_tpu_torch.core.metrics import Metric
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops.freq_agg import run_shared_freq_agg
from deequ_tpu_torch.runners.context import AnalyzerContext

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.state_provider import StateLoader, StatePersister


def run_grouping_analyzers(
    data: Table,
    analyzers: Sequence[GroupingAnalyzer],
    device: torch.device,
    aggregate_with: Optional["StateLoader"] = None,
    save_states_with: Optional["StatePersister"] = None,
    mesh=None,
) -> AnalyzerContext:
    """`mesh` (parallel/distributed.py) counts the groups row-sharded over
    its devices (`sharded_bincount`) where the code space is small enough."""
    metrics: Dict[object, Metric] = {}
    # group by sorted grouping-column set (reference: AnalysisRunner.scala:164-180)
    groups: Dict[Tuple[str, ...], List[FrequencyBasedAnalyzer]] = {}
    for analyzer in analyzers:
        if not isinstance(analyzer, FrequencyBasedAnalyzer):
            metrics[analyzer] = analyzer.calculate(
                data, aggregate_with, save_states_with, device=device
            )
            continue
        groups.setdefault(tuple(sorted(analyzer.grouping_columns())), []).append(analyzer)
    for cols, group in groups.items():
        with observe.span("grouping", cat="group", columns=",".join(cols), analyzers=len(group)):
            _run_column_set(
                data, cols, group, metrics, device, aggregate_with, save_states_with, mesh
            )
    return AnalyzerContext(metrics)


def _run_column_set(
    data, cols, group, metrics, device, aggregate_with=None, save_states_with=None, mesh=None
) -> None:
    """One grouping-column set: a shared frequency pass, then the shared
    aggregation, then the analyzers that are not shareable. With a state
    loader or persister each analyzer merges and saves its own state and
    aggregates it alone, still on the run's device."""
    try:
        shared_state = compute_frequencies(data, list(cols), mesh=mesh)
    except Exception as e:  # noqa: BLE001
        for analyzer in group:
            metrics[analyzer] = analyzer.to_failure_metric(e)
        return

    if aggregate_with is not None or save_states_with is not None:
        for analyzer in group:
            try:
                metrics[analyzer] = analyzer.calculate_metric(
                    shared_state, aggregate_with, save_states_with, device
                )
            except Exception as e:  # noqa: BLE001
                metrics[analyzer] = analyzer.to_failure_metric(e)
        return

    shareable = [a for a in group if isinstance(a, ScanShareableFrequencyBasedAnalyzer)]
    if shareable:
        try:
            for analyzer, metric in zip(
                shareable, run_shared_freq_agg(shared_state, shareable, device)
            ):
                metrics[analyzer] = metric
        except Exception as e:  # noqa: BLE001
            for analyzer in shareable:
                metrics[analyzer] = analyzer.to_failure_metric(e)
    for analyzer in group:
        if analyzer in shareable:
            continue
        # e.g. MutualInformation: a host pass after the shared aggregation
        try:
            metrics[analyzer] = analyzer.compute_metric_from(shared_state, device)
        except Exception as e:  # noqa: BLE001
            metrics[analyzer] = analyzer.to_failure_metric(e)

