"""Shared aggregation over a frequencies table.

Every requested frequency aggregation of one grouping set (uniqueness,
distinctness, entropy, ...) runs over ONE float64 copy of the counts on
the run's device, and every result comes back in one copy — the
analogue of the reference sharing `frequencies.agg(all fns)`
(reference: runners/AnalysisRunner.scala:466-534, esp. :497-500). The
JAX counterpart is deequ_tpu/ops/freq_agg.py.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, List, Sequence, Tuple

import numpy as np
import torch

from deequ_tpu_torch import observe
from deequ_tpu_torch.core.metrics import Metric
from deequ_tpu_torch.ops import runtime

if TYPE_CHECKING:
    from deequ_tpu_torch.analyzers.frequency import (
        FrequenciesAndNumRows,
        ScanShareableFrequencyBasedAnalyzer,
    )


def run_shared_freq_agg(
    state: "FrequenciesAndNumRows",
    analyzers: Sequence["ScanShareableFrequencyBasedAnalyzer"],
    device: torch.device,
) -> List[Metric]:
    """One shared aggregation on `device` -> one metric per analyzer (in
    order). A spilled state reduces partition by partition on `device`,
    and the leaves sum on the host in partition order: every aggregation
    is a sum over groups, so this is exact, and the whole counts array
    is never built."""
    spilled = bool(getattr(state, "is_spilled", False))
    with observe.span(
        "freq_agg",
        cat="group",
        analyzers=len(analyzers),
        groups=-1 if spilled else len(getattr(state, "counts", ())),
        spilled=spilled,
    ):
        return _run_shared_freq_agg(state, analyzers, device)


def _run_shared_freq_agg(state, analyzers, device: torch.device) -> List[Metric]:
    runtime.record_pass("freq-agg:" + ",".join(a.name for a in analyzers))
    num_rows = torch.tensor(float(state.num_rows), dtype=torch.float64, device=device)

    def reduce(counts) -> Tuple[list, np.ndarray]:
        runtime.record_launch()
        counts = torch.tensor(np.asarray(counts), dtype=torch.float64, device=device)
        outs = [a.freq_reduce(counts, num_rows) for a in analyzers]
        leaves = [value for out in outs for value in out.values()]
        return outs, (torch.stack(leaves).cpu().numpy() if leaves else np.zeros(0))

    if getattr(state, "is_spilled", False):
        outs, flat = reduce(np.zeros(0))
        for part in state.partitions():
            flat = flat + reduce(part.counts)[1]
    else:
        outs, flat = reduce(state.counts)
    metrics = []
    pos = 0
    for analyzer, out in zip(analyzers, outs):
        agg = dict(zip(out, flat[pos : pos + len(out)].tolist()))
        pos += len(out)
        metrics.append(analyzer.metric_from_freq_agg(agg, state))
    return metrics
