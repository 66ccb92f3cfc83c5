"""The port's wait spans, input builds, spill spans and per-batch device
times, read from a traced run's span forests (`Iteration.roots`).

A request's spans: the `pipe_wait` leaves (cat `wait`) at the queue
hand-offs, with `on` the stage waited for and `blocked` on a put that
found its queue full; the `build_s` attributes the input builds add to
the span open around them; the `spill_*` spans of the grouping's disk
spill, and `spilled` on each `group_pass` span; `device_ms` on each
`transfer` span, the time on the device's clock between two CUDA events
around that batch's fused program, gaps while the host still launches
its ops included. A program that records none of them (an older one)
gives None from every reader here, never 0.

The metrics that read this module (`metrics/<name>.py`):

- `pipeline.wait_s.scan`: seconds a run of `pipe_wait` spans with `on`
  "prep", the fold starved by the prep stage.
- `source.wait_s.scan`: seconds a run of `pipe_wait` spans with `on`
  "decode", the prep thread and the grouping pass waiting for decoded
  batches.
- `pipeline.build_s.scan`: the `build_s` attributes a run, input builds
  in thread-seconds.
- `fused.program_span_s.scan`: `device_ms` on the `transfer` spans a
  run, in seconds; it moves with launch overhead as much as with the
  kernels. None on the CPU.
- `grouping.spill_s.scan`: seconds a run of the `spill_write`,
  `spill_finalize` and `spill_read` spans; 0 where the group passes say
  (`spilled`) they did not spill.
- `device.idle_wait_share.scan`: the share of the device's idle time in
  the window that the requesting thread spends in `pipe_wait` spans.

Blocked puts (`blocked=True`) count in none of them.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, List, Optional, Tuple

WAIT_SPAN = "pipe_wait"


def walk(roots) -> Iterator:
    stack = list(roots or [])
    while stack:
        span = stack.pop()
        yield span
        stack.extend(span.children)


def per_request(run, value: Callable[[object], Optional[float]]) -> Optional[float]:
    """Mean over the window's completed requests of `value(iteration)`,
    which is None where the request's spans hold nothing to read; None
    when no request holds anything."""
    done = run.done
    if not run.trace or not done:
        return None
    values = [value(it) for it in done]
    if all(v is None for v in values):
        return None
    return sum(v or 0.0 for v in values) / len(done)


def _wait_s(it, on: str) -> Optional[float]:
    """Seconds of the request's waits for stage `on` (not blocked puts);
    None when the request has no wait span at all."""
    total, seen = 0.0, False
    for span in walk(it.roots):
        if span.name != WAIT_SPAN:
            continue
        seen = True
        if span.attrs.get("on") == on and not span.attrs.get("blocked"):
            total += span.t1 - span.t0
    return total if seen else None


def wait_s(run, on: str) -> Optional[float]:
    return per_request(run, lambda it: _wait_s(it, on))


def attr_sum(run, key: str, name: Optional[str] = None) -> Optional[float]:
    """Mean per request of the sum of attribute `key` over the spans
    (named `name`, when given) that carry it."""
    def one(it) -> Optional[float]:
        values = [span.attrs[key] for span in walk(it.roots)
                  if key in span.attrs and (name is None or span.name == name)]
        return float(sum(values)) if values else None
    return per_request(run, one)


def spill_s(run) -> Optional[float]:
    """Mean per request of the `spill_*` spans' durations: 0 for a request
    whose group passes say they did not spill, None for one with no group
    pass that says whether it spilled (none ran, or an older program)."""
    def one(it) -> Optional[float]:
        spans = list(walk(it.roots))
        if not any(span.name == "group_pass" and "spilled" in span.attrs for span in spans):
            return None
        return sum(span.t1 - span.t0 for span in spans if span.name.startswith("spill_"))
    return per_request(run, one)


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def _overlap(xs: List[Tuple[float, float]], ys: List[Tuple[float, float]]) -> float:
    """Total length of the intersection of two sorted disjoint interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo, hi = max(xs[i][0], ys[j][0]), min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_wait_share(run, tid: Optional[int] = None) -> Optional[float]:
    """100 x the device's idle time inside the window that the requesting
    thread spends in its wait spans, over the device's idle time in the
    window: each gap counts over its whole length. Requests run on the
    harness's thread (`tid`, this thread by default). None without a
    device record, idle time or wait spans."""
    device = run.device
    if device is None or not run.trace:
        return None
    tid = threading.get_ident() if tid is None else tid
    waits = _union((span.t0, span.t1) for it in run.iterations for span in walk(it.roots)
                   if span.name == WAIT_SPAN and span.tid == tid)
    gaps = _union(device.gaps())
    idle = sum(b - a for a, b in gaps)
    if not waits or idle <= 0:
        return None
    return 100.0 * _overlap(gaps, waits) / idle
