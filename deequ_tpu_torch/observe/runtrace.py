"""Top-level run tracing: the `DEEQU_TPU_TRACE` knob, `traced_run()`
entry points, and the `RunTrace` object attached to results.

`traced_run(name, enable=...)` is what the runners call around a whole
verification/analysis run:

  * already inside an active tracer (e.g. the suite traced and now the
    analysis run starts) → plain child span; the nested run still gets
    its own `RunTrace` covering its subtree;
  * `enable` True / a path / env knob set → a fresh root tracer for
    the run (the env knob reuses one process-wide tracer so sequential
    runs accumulate into one trace file);
  * otherwise → disabled: the handle is falsy and the body runs on the
    `span()` no-op fast path.

Env knob: `DEEQU_TPU_TRACE` unset/`0`/`false`/`off` disables; any
other value enables. A value that looks like a path (contains a
separator or ends in `.json`) doubles as the output path;
`DEEQU_TPU_TRACE_OUT` always wins. Default output lands in the system
temp dir, one file per OS process with the torch.distributed rank
appended under multihost (merge with `observe.merge_chrome_traces`).
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import threading
from typing import Any, Dict, Iterator, Optional

from deequ_tpu_torch.observe import export, report, spans
from deequ_tpu_torch.observe.spans import Span, Tracer

ENV_KNOB = "DEEQU_TPU_TRACE"
ENV_OUT = "DEEQU_TPU_TRACE_OUT"

_FALSEY = ("", "0", "false", "no", "off")
_TRUTHY_PLAIN = ("1", "true", "yes", "on")

# Keep at most this many env-traced runs in the process-wide tracer so
# a long-lived process (loops of runs, services) stays bounded.
_ENV_TRACER_MAX_ROOTS = 256

_env_lock = threading.Lock()
_env_tracer: Optional[Tracer] = None
_announced_paths: set = set()


def env_enabled() -> bool:
    return os.environ.get(ENV_KNOB, "").strip().lower() not in _FALSEY


def default_trace_path() -> str:
    return os.path.join(
        tempfile.gettempdir(), f"deequ_tpu_trace_{os.getpid()}.json"
    )


def _env_out_path() -> str:
    out = os.environ.get(ENV_OUT, "").strip()
    if out:
        return out
    value = os.environ.get(ENV_KNOB, "").strip()
    if value.lower() not in _TRUTHY_PLAIN and (
        os.sep in value or value.endswith(".json")
    ):
        return value
    return default_trace_path()


def _per_process_path(path: str) -> str:
    """Suffix the torch.distributed rank when the world size is above 1,
    so every process writes its own file (merged later by
    `merge_chrome_traces`)."""
    if export.process_count() > 1:
        stem, ext = os.path.splitext(path)
        return f"{stem}_p{export.process_index()}{ext or '.json'}"
    return path


def _get_env_tracer() -> Tracer:
    global _env_tracer
    with _env_lock:
        if _env_tracer is None:
            _env_tracer = Tracer()
        elif len(_env_tracer.roots) >= _ENV_TRACER_MAX_ROOTS:
            with _env_tracer.lock:
                del _env_tracer.roots[: -_ENV_TRACER_MAX_ROOTS // 2]
        return _env_tracer


class RunTrace:
    """One traced run: its root span, counter snapshot, and exporters.
    Attached to `VerificationResult.run_trace` / `AnalyzerContext
    .run_trace`."""

    __slots__ = ("root", "epoch", "counters", "path")

    def __init__(
        self,
        root: Span,
        epoch: float,
        counters: Dict[str, int],
        path: Optional[str] = None,
    ):
        self.root = root
        self.epoch = epoch
        self.counters = dict(counters)
        self.path = path  # where the trace file landed, when one was written

    @property
    def duration_s(self) -> float:
        return self.root.duration_s

    def phase_seconds(self) -> Dict[str, float]:
        return report.phase_seconds([self.root])

    def to_chrome_trace(self) -> dict:
        return export.chrome_trace([self.root], epoch=self.epoch)

    def write(self, path: Optional[str] = None) -> str:
        target = path or self.path or default_trace_path()
        self.path = export.write_chrome_trace(
            target, [self.root], epoch=self.epoch
        )
        return self.path

    def report(self) -> str:
        return report.render_report([self.root], counters=self.counters)

    def spans(self) -> Iterator[Span]:
        return self.root.walk()

    def __repr__(self) -> str:
        return (
            f"RunTrace({self.root.name!r}, {self.duration_s * 1e3:.1f}ms, "
            f"counters={self.counters})"
        )


class RunHandle:
    """Yielded by `traced_run`. Falsy when tracing is off; `.trace`
    holds the finished `RunTrace` after the block exits."""

    __slots__ = ("span", "trace")

    def __init__(self) -> None:
        self.span: Optional[Span] = None
        self.trace: Optional[RunTrace] = None

    def __bool__(self) -> bool:
        return self.span is not None


def _counter_delta(
    tracer: Tracer, before: Dict[str, int]
) -> Dict[str, int]:
    return {
        key: value - before.get(key, 0)
        for key, value in tracer.counters.items()
        if value - before.get(key, 0)
    }


def _set_resource_attrs(run_span: Span) -> None:
    """Stamp peak RSS / major faults on the run span (from /proc, no
    psutil), so run reports and telemetry records carry their own resource
    accounting. Both values are process-cumulative: for nested runs
    they describe the process at run end, not the run's own delta."""
    from deequ_tpu_torch.observe import telemetry

    try:
        res = telemetry.proc_resources()
    except Exception:
        return
    if "peak_rss_mb" in res:
        run_span.set(peak_rss_mb=round(res["peak_rss_mb"], 2))
    if "major_faults" in res:
        run_span.set(major_faults=int(res["major_faults"]))


@contextlib.contextmanager
def traced_run(
    name: str, enable: Any = None, **attrs: Any
) -> Iterator[RunHandle]:
    handle = RunHandle()
    active = spans.current_tracer()
    if active is not None:
        # Nested under an outer traced run: contribute a child subtree.
        before = dict(active.counters)
        with spans.span(name, cat="run", **attrs) as run_span:
            handle.span = run_span
            try:
                yield handle
            finally:
                delta = _counter_delta(active, before)
                run_span.set(**delta)
                _set_resource_attrs(run_span)
                handle.trace = RunTrace(run_span, active.epoch, delta)
        return

    out_path: Optional[str] = None
    if enable is None:
        if env_enabled():
            tracer = _get_env_tracer()
            out_path = _per_process_path(_env_out_path())
        else:
            yield handle
            return
    elif isinstance(enable, str):
        tracer = Tracer()
        out_path = _per_process_path(enable)
    elif enable:
        tracer = Tracer()
        out_path = os.environ.get(ENV_OUT, "").strip() or None
        if out_path:
            out_path = _per_process_path(out_path)
    else:
        yield handle
        return

    before = dict(tracer.counters)
    with spans.tracing(tracer):
        with spans.span(name, cat="run", **attrs) as run_span:
            handle.span = run_span
            try:
                yield handle
            finally:
                delta = _counter_delta(tracer, before)
                run_span.set(**delta)
                _set_resource_attrs(run_span)
                handle.trace = RunTrace(run_span, tracer.epoch, delta)
    if out_path is not None and handle.trace is not None:
        try:
            # The env tracer accumulates runs: rewrite the whole forest
            # so the file always holds everything traced so far.
            roots = tracer.roots if tracer is _env_tracer else [handle.trace.root]
            export.write_chrome_trace(out_path, roots, epoch=tracer.epoch)
            handle.trace.path = out_path
            if out_path not in _announced_paths:
                _announced_paths.add(out_path)
                sys.stderr.write(
                    f"# deequ_tpu: trace -> {out_path} "
                    f"(load in https://ui.perfetto.dev)\n"
                )
        except OSError:
            pass
