"""Hierarchical spans and the thread-local trace context stack.

A `Span` is one timed region (wall via perf_counter, CPU via
process_time) with attributes and children. A `Tracer` owns a forest of
root spans plus run-level counters; `tracing()` installs one on the
current thread, `span()` opens a child of whatever is innermost.

The disabled fast path is the design center: with no tracer installed,
`span()` is a single thread-local attribute probe returning the
singleton `_NOOP` (falsy, inert context manager), so instrumented hot
paths pay ~a function call when observability is off. The per-phase
accounting (DrJAX-style structured telemetry, arXiv:2403.07128; LaraDB
per-operator accounting, arXiv:1703.07342) only materializes when a
tracer is active.

Worker-pool threads see an empty stack by construction (thread-local);
a dispatcher that fans work out to a pool captures `current_tracer()` /
`current_span()` and has workers adopt them with `attached()`.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

_perf_counter = time.perf_counter
_process_time = time.process_time

_local = threading.local()


def _stack() -> List[Tuple["Tracer", Optional["Span"]]]:
    try:
        return _local.stack
    except AttributeError:
        st: List[Tuple["Tracer", Optional["Span"]]] = []
        _local.stack = st
        return st


def current_tracer() -> Optional["Tracer"]:
    st = getattr(_local, "stack", None)
    return st[-1][0] if st else None


def current_span() -> Optional["Span"]:
    st = getattr(_local, "stack", None)
    return st[-1][1] if st else None


class Span:
    """One timed region of a traced run. Context manager: times the
    block, attaches itself under the innermost open span (or as a
    tracer root), and is the innermost span for the duration."""

    __slots__ = (
        "name",
        "cat",
        "t0",
        "t1",
        "cpu0",
        "cpu1",
        "tid",
        "attrs",
        "children",
    )

    def __init__(self, name: str, cat: Optional[str] = None, attrs=None):
        self.name = name
        self.cat = cat
        self.t0 = self.t1 = 0.0
        self.cpu0 = self.cpu1 = 0.0
        self.tid = 0
        self.attrs: Dict[str, Any] = dict(attrs) if attrs else {}
        self.children: List[Span] = []

    @property
    def duration_s(self) -> float:
        return max(self.t1 - self.t0, 0.0)

    @property
    def cpu_s(self) -> float:
        return max(self.cpu1 - self.cpu0, 0.0)

    def set(self, **attrs: Any) -> "Span":
        self.attrs.update(attrs)
        return self

    def add(self, key: str, n: Any = 1) -> "Span":
        self.attrs[key] = self.attrs.get(key, 0) + n
        return self

    def walk(self) -> Iterator["Span"]:
        yield self
        for child in self.children:
            yield from child.walk()

    def __bool__(self) -> bool:
        return True

    def __enter__(self) -> "Span":
        st = _stack()
        tracer, parent = st[-1] if st else (None, None)
        self.tid = threading.get_ident()
        if tracer is not None:
            with tracer.lock:
                sink = parent.children if parent is not None else tracer.roots
                sink.append(self)
            st.append((tracer, self))
        self.cpu0 = _process_time()
        self.t0 = _perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        self.t1 = _perf_counter()
        self.cpu1 = _process_time()
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        st = getattr(_local, "stack", None)
        if st:
            if st[-1][1] is self:
                st.pop()
            else:  # unbalanced exit (span closed on another thread/path)
                for i in range(len(st) - 1, -1, -1):
                    if st[i][1] is self:
                        del st[i]
                        break
        return False

    def __repr__(self) -> str:
        return (
            f"Span({self.name!r}, cat={self.cat!r}, "
            f"dur={self.duration_s * 1e3:.3f}ms, "
            f"children={len(self.children)})"
        )


class _NoopSpan:
    """Singleton stand-in when no tracer is installed: falsy, inert."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        return False

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def add(self, key: str, n: Any = 1) -> "_NoopSpan":
        return self

    def __bool__(self) -> bool:
        return False


_NOOP = _NoopSpan()


def span(name: str, cat: Optional[str] = None, **attrs: Any):
    """Open a span under the current thread's trace context. Returns
    the inert singleton when tracing is off — the disabled fast path."""
    st = getattr(_local, "stack", None)
    if not st:
        return _NOOP
    return Span(name, cat, attrs)


def annotate(**attrs: Any) -> None:
    """Set attributes on the innermost open span; no-op when untraced."""
    s = current_span()
    if s is not None:
        s.attrs.update(attrs)


class Tracer:
    """Owns one trace: a forest of root spans, a monotonic epoch the
    exporter subtracts timestamps from, and run-level counters kept
    bit-identical to `ExecutionStats` (observe.counters feeds both)."""

    __slots__ = ("lock", "roots", "epoch", "epoch_unix", "counters", "labels")

    def __init__(self) -> None:
        self.lock = threading.Lock()
        self.roots: List[Span] = []
        self.epoch = _perf_counter()
        self.epoch_unix = time.time()
        self.counters: Dict[str, int] = {}
        self.labels: List[str] = []

    def count(self, name: str, n: int = 1, label: Optional[str] = None) -> None:
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n
            if label is not None:
                self.labels.append(label)
        s = current_span()
        if s is not None:
            s.add(name, n)


@contextlib.contextmanager
def tracing(tracer: Optional[Tracer] = None) -> Iterator[Tracer]:
    """Install a tracer on this thread for the block. Spans opened
    inside (on this thread, or on workers that `attached()` to it)
    land in `tracer.roots`."""
    if tracer is None:
        tracer = Tracer()
    st = _stack()
    base = len(st)
    st.append((tracer, None))
    try:
        yield tracer
    finally:
        del st[base:]


@contextlib.contextmanager
def attached(tracer: Optional[Tracer], parent: Optional[Span]) -> Iterator[None]:
    """Adopt another thread's (tracer, parent span) as this thread's
    trace context — how worker-pool threads keep their spans under the
    dispatching scan's subtree. No-op when `tracer` is None, so callers
    can capture `current_tracer()/current_span()` unconditionally."""
    if tracer is None:
        yield
        return
    st = _stack()
    base = len(st)
    st.append((tracer, parent))
    try:
        yield
    finally:
        del st[base:]


def timed_call(fn) -> float:
    """Wall-clock seconds of `fn()`: the timing helper for engine code,
    so that its clock reads stay in this package."""
    t0 = _perf_counter()
    fn()
    return _perf_counter() - t0
