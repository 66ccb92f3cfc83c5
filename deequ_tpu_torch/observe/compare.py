"""Trace-side extraction of the execution shape the static cost
analyzer predicts (lint/cost.PlanCost.dispatch_signature).

`dispatch_signature(trace)` reduces an observed `RunTrace` to the same
{counters, spans, family_groups} structure, so the trace-differential
suite is one dict equality: `cost.dispatch_signature() ==
compare.dispatch_signature(ctx.run_trace)`. Nothing here interprets
plans — it only folds the span tree.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.observe.runtrace import RunTrace

#: the execution-layer span vocabulary (mirror of lint/cost.EXECUTION_SPANS)
EXECUTION_SPANS = (
    "plan_fuse",
    "fused_scan",
    "dist_scan",
    "dispatch",
    "host_fold",
    "transfer",
    "merge",
    "family_kernel",
    "grouping",
    "group_pass",
    "freq_agg",
    "state_allgather",
)

COUNTERS = ("device_passes", "device_launches", "group_passes")


def span_name_counts(
    trace: RunTrace, names: Optional[Sequence[str]] = None
) -> Dict[str, int]:
    """Histogram of span names over the whole tree, restricted to the
    execution vocabulary (or an explicit name set)."""
    wanted = set(EXECUTION_SPANS if names is None else names)
    counts: Dict[str, int] = {}
    for sp in trace.spans():
        if sp.name in wanted:
            counts[sp.name] = counts.get(sp.name, 0) + 1
    return counts


def observed_family_groups(trace: RunTrace) -> List[Tuple[Any, ...]]:
    """Distinct family-kernel dispatch groups seen in the trace, as
    (where, cap, dtype, columns, batched) — deduplicated across batches
    (a multi-batch scan dispatches every group once per batch)."""
    groups: set = set()
    for sp in trace.spans():
        if sp.name != "family_kernel":
            continue
        cols = sp.attrs.get("cols", "")
        groups.add(
            (
                str(sp.attrs.get("where")),
                int(sp.attrs.get("cap", 0)),
                str(sp.attrs.get("dtype")),
                tuple(cols.split(",")) if cols else (),
                bool(sp.attrs.get("batched", False)),
            )
        )
    return sorted(groups)


def dispatch_signature(trace: RunTrace) -> Dict[str, Any]:
    """The observed execution shape, directly comparable to
    `PlanCost.dispatch_signature()`."""
    counters = {k: int(trace.counters.get(k, 0)) for k in COUNTERS}
    return {
        "counters": counters,
        "spans": span_name_counts(trace),
        "family_groups": observed_family_groups(trace),
    }


__all__ = [
    "COUNTERS",
    "EXECUTION_SPANS",
    "dispatch_signature",
    "observed_family_groups",
    "span_name_counts",
]
