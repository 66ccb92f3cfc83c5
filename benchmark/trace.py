"""The traced run's record: the program's spans, the device's operations
from torch.profiler, and the sizes of every K1-K4 launch.

Everything here reduces what the program and the profiler report to
numbers; the per-layer metrics in `benchmark/metrics/` read them.

Clocks: the program's spans are `time.perf_counter` seconds. The
profiler's events are microseconds on its own base; a marker opened at a
known `perf_counter` reading (`record_function`) gives the offset
between the two, so device gaps can be set against host spans.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

#: substrings of the CUDA kernels' symbols (csrc/kernels.cu), by wrapper
KERNEL_SYMBOLS = {  # chip_smoke.py:1139
    "masked_moments": "masked_moments_kernel",
    "masked_centered_sumsq": "centered_sumsq_kernel",
    "hll_register_max": "hll_max",
    "hist16": "hist16_count",
}
MARKER = "bench.window"


def self_seconds(roots) -> Dict[str, float]:
    """Self time by span category over a span forest: a span's duration
    less what its children cover (never below 0). Spans of other threads
    hang under the span that dispatched them, so their self time is busy
    thread-seconds, which can overlap the caller's. A pipeline stage's
    per-batch work (`pipe_item` spans) also counts under
    `pipe_item:<stage>`."""
    out: Dict[str, float] = {}
    stack = list(roots)
    while stack:
        span = stack.pop()
        covered = sum(max(c.t1 - c.t0, 0.0) for c in span.children)
        own = max(span.t1 - span.t0 - covered, 0.0)
        keys = [span.cat or "other"]
        if span.name == "pipe_item":
            keys.append(f"pipe_item:{span.attrs.get('stage')}")
        for key in keys:
            out[key] = out.get(key, 0.0) + own
        stack.extend(span.children)
    return out


def innermost(roots, tid: int, t: float) -> Optional[str]:
    """The category of the innermost span of thread `tid` open at `t`."""
    found, level = None, list(roots)
    while level:
        nxt = []
        for span in level:
            if span.tid == tid and span.t0 <= t < span.t1:
                found = span.cat or span.name
                nxt = span.children
                break
            if span.t0 <= t < span.t1:  # another thread's span may hold ours
                nxt.extend(span.children)
        level = nxt
    return found


class LaunchLog:
    """Wraps the port's four kernel wrappers (module attributes of
    `deequ_tpu_torch.ops.cuda_kernels`, through which the analyzers call
    them) to record each launch's sizes: rows, the value's bytes per row
    and, for hist16, a device tensor of its live rows, read after the
    window so that no launch waits for it."""

    def __init__(self) -> None:
        self.launches: List[Tuple[str, int, int, object]] = []
        self._lock = threading.Lock()
        self._saved = {}

    @contextlib.contextmanager
    def installed(self):
        from deequ_tpu_torch.ops import cuda_kernels as ck

        def wrap(name, original):
            @functools.wraps(original)  # with its launch counter, which the kernel bumps
            def wrapper(*args, **kwargs):
                x = args[0]
                live = args[1].sum() if name == "hist16" else None
                with self._lock:
                    self.launches.append((name, int(x.numel()), int(x.element_size()), live))
                return original(*args, **kwargs)
            return wrapper

        for name in KERNEL_SYMBOLS:
            self._saved[name] = getattr(ck, name)
            setattr(ck, name, wrap(name, self._saved[name]))
        try:
            yield self
        finally:
            for name, original in self._saved.items():
                setattr(ck, name, original)

    def sizes(self) -> List[Tuple[str, int, int, int]]:
        """(kernel, rows, value bytes, live rows) of every launch."""
        return [(name, n, item, int(live) if live is not None else n)
                for name, n, item, live in self.launches]


@dataclass
class DeviceRecord:
    ops: List[Tuple[float, float, str]] = field(default_factory=list)  # perf_counter s
    window: Tuple[float, float] = (0.0, 0.0)

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals inside the window
        (chip_smoke.py:1177 `device_busy_ms`, clipped to the window)."""
        lo, hi = self.window
        merged: List[List[float]] = []
        for start, stop, _ in sorted(self.ops):
            start, stop = max(start, lo), min(stop, hi)
            if stop <= start:
                continue
            if merged and start <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], stop)
            else:
                merged.append([start, stop])
        return [(a, b) for a, b in merged]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def gaps(self) -> List[Tuple[float, float]]:
        """The idle intervals of the device inside the window."""
        out, t = [], self.window[0]
        for a, b in self.busy_intervals():
            if a > t:
                out.append((t, a))
            t = max(t, b)
        if self.window[1] > t:
            out.append((t, self.window[1]))
        return out

    def op_seconds(self) -> Dict[str, float]:
        totals: Dict[str, float] = {}
        for start, stop, name in self.ops:
            totals[name] = totals.get(name, 0.0) + (stop - start)
        return totals

    def kernel_seconds(self) -> Dict[str, float]:
        """Device seconds of each of K1-K4, by wrapper name."""
        out = dict.fromkeys(KERNEL_SYMBOLS, 0.0)
        for start, stop, name in self.ops:
            for wrapper, symbol in KERNEL_SYMBOLS.items():
                if symbol in name:
                    out[wrapper] += stop - start
        return out


@contextlib.contextmanager
def profiled(record: DeviceRecord):
    """torch.profiler over the block; on exit `record` holds the device
    operations on the perf_counter clock."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(MARKER):
            marker_t = time.perf_counter()
            torch.cuda.synchronize()
        start = time.perf_counter()
        try:
            yield record
        finally:
            torch.cuda.synchronize()
            record.window = (start, time.perf_counter())
    from torch.autograd import DeviceType

    events = prof.events()
    marker = next(e for e in events if e.name == MARKER)
    offset = marker_t - marker.time_range.start / 1e6
    record.ops = [(e.time_range.start / 1e6 + offset, e.time_range.end / 1e6 + offset, e.name)
                  for e in events if e.device_type == DeviceType.CUDA]
