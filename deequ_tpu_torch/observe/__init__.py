"""Runtime observability: hierarchical spans, counters, trace export.

The paper's core claim — the mergeable-state algebra lets many metrics
share a minimal number of scan passes — becomes *measurable* here:
every run can record a span tree (suite → analysis run → plan/fuse →
per-family kernel dispatch → native call → state merge → constraint
eval) with wall/CPU time, rows/bytes scanned, device-transfer bytes and
pass/launch counters, exportable as Chrome-trace JSON (load it in
Perfetto / chrome://tracing) or rendered as a human-readable report.

Design constraints:
  * near-zero overhead when disabled: `span()` is one thread-local
    attribute probe returning a singleton no-op context manager;
  * no deequ_tpu dependencies outside `core.fileio` (imported lazily),
    so the engine layers (`ops/`, `runners/`, `parallel/`) can all
    import this package without cycles;
  * thread-correct: the context stack is thread-local, and worker-pool
    threads adopt the dispatching thread's context via `attached()`.

Enable per run with `.with_tracing(...)` on the builders, per block
with `tracing()`, or process-wide with `DEEQU_TPU_TRACE=1`
(`DEEQU_TPU_TRACE_OUT` overrides the output path).
"""

from deequ_tpu_torch.observe.spans import (
    Span,
    Tracer,
    annotate,
    attached,
    current_span,
    current_tracer,
    span,
    timed_call,
    tracing,
)
from deequ_tpu_torch.observe import counters
from deequ_tpu_torch.observe.export import (
    chrome_trace,
    merge_chrome_traces,
    write_chrome_trace,
)
from deequ_tpu_torch.observe.compare import (
    dispatch_signature,
    observed_family_groups,
    span_name_counts,
)
from deequ_tpu_torch.observe.report import (
    PHASES,
    PIPE_ITEM_SPAN,
    PIPE_STAGE_SPAN,
    phase_seconds,
    pipeline_occupancy,
    render_report,
)
from deequ_tpu_torch.observe.runtrace import (
    ENV_KNOB,
    ENV_OUT,
    RunTrace,
    default_trace_path,
    env_enabled,
    traced_run,
)
from deequ_tpu_torch.observe import heartbeat
from deequ_tpu_torch.observe.forensics import (
    ConstraintForensics,
    ForensicsCapture,
    ForensicsReport,
    ViolationSample,
    classify_constraints,
    render_forensics,
)
from deequ_tpu_torch.observe.heartbeat import scan_heartbeat
from deequ_tpu_torch.observe.telemetry import (
    engine_metric_record,
    latest_results,
    openmetrics_text,
    proc_resources,
)

__all__ = [
    "Span",
    "Tracer",
    "annotate",
    "attached",
    "current_span",
    "current_tracer",
    "span",
    "timed_call",
    "tracing",
    "counters",
    "chrome_trace",
    "merge_chrome_traces",
    "write_chrome_trace",
    "PHASES",
    "PIPE_ITEM_SPAN",
    "PIPE_STAGE_SPAN",
    "phase_seconds",
    "pipeline_occupancy",
    "render_report",
    "ENV_KNOB",
    "ENV_OUT",
    "ConstraintForensics",
    "ForensicsCapture",
    "ForensicsReport",
    "RunTrace",
    "ViolationSample",
    "classify_constraints",
    "default_trace_path",
    "dispatch_signature",
    "engine_metric_record",
    "env_enabled",
    "heartbeat",
    "render_forensics",
    "latest_results",
    "observed_family_groups",
    "openmetrics_text",
    "proc_resources",
    "scan_heartbeat",
    "span_name_counts",
    "traced_run",
]
