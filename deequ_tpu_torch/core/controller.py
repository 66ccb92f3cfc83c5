"""Cooperative run control: a cancel token and a deadline, honoured at
batch and partition boundaries.

A `RunController` threads suite -> runner -> fused scan. The scan calls
`check()` before each batch (and before each partition of a partitioned
source); a tripped check raises `RunCancelled` with the run's progress.
The raise unwinds through `contextlib.closing` around the staged
pipeline and the source's `batches()` generator, so every stage thread,
decode thread and open file joins through the same shutdown an exhausted
scan takes.

A soft cancel (`cancel_at_boundary()`) trips only at checks marked
`boundary=True`: the partition boundaries of a partitioned scan, where
every finished partition has saved its states, so a rerun resumes from
them. A boundary probe (`set_boundary_probe`) runs at each such check
and may return a soft-cancel reason; `bind_shared_cancel` chains a
`SharedCancelToken` (one file every shard of a sharded scan can see)
into it.

A `StallWatchdog` watches the controller's beat count (one beat per
folded batch): one silent window dumps the stages' state, a second
cancels the run. `retry_call` and `backoff_s` are the bounded retry with
deterministic jitter around the C reader's pread.

Codes: DQ401 an explicit `cancel()`, DQ402 a deadline, DQ403 reserved
for a retry budget run out with no degrade path (every retry site today
degrades to pyarrow instead), DQ404 a stall the watchdog cancelled; soft
cancels DQ405 a preemption, DQ406 a quota run out mid-run, DQ407 a
graceful drain.

The JAX counterpart is deequ_tpu/core/controller.py.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

DQ_CANCELLED = "DQ401"
DQ_DEADLINE = "DQ402"
DQ_RETRIES_EXHAUSTED = "DQ403"  # reserved: see the module docstring
DQ_STALLED = "DQ404"
DQ_PREEMPTED = "DQ405"
DQ_QUOTA = "DQ406"
DQ_DRAIN = "DQ407"

_REASON_CODES = {
    "cancelled": DQ_CANCELLED,
    "deadline": DQ_DEADLINE,
    "stalled": DQ_STALLED,
    "preempted": DQ_PREEMPTED,
    "quota": DQ_QUOTA,
    "drain": DQ_DRAIN,
}

#: soft-cancel reasons: they trip only at `boundary=True` checks
SOFT_REASONS = frozenset({"preempted", "quota", "drain"})


class RunCancelled(RuntimeError):
    """A run ended early on purpose (a cancel, a deadline or the stall
    watchdog). Carries the
    DQ4xx code and the progress made: batches, rows and, for partitioned
    runs, partitions."""

    def __init__(
        self, reason: str, *, where: str = "", progress: Optional[Dict[str, Any]] = None
    ) -> None:
        self.reason = reason
        self.code = _REASON_CODES.get(reason, DQ_CANCELLED)
        self.where = where
        self.progress = dict(progress or {})
        detail = f" at {where}" if where else ""
        extra = ""
        if self.progress:
            extra = " (" + ", ".join(f"{k}={v}" for k, v in sorted(self.progress.items())) + ")"
        super().__init__(f"[{self.code}] run {reason}{detail}{extra}")


class RunController:
    """Cancel token and optional deadline for one run. Any thread may
    `cancel()`; the fold loop calls `check()` between batches."""

    def __init__(self, deadline_s: Optional[float] = None) -> None:
        self._deadline_at = (
            time.monotonic() + float(deadline_s) if deadline_s is not None else None
        )
        self._cancel = threading.Event()
        self._reason = "cancelled"
        self._soft_cancel = threading.Event()
        self._soft_reason = "preempted"
        self._boundary_probe: Optional[Callable[[Dict[str, Any]], Optional[str]]] = None
        self.beats = 0

    def cancel(self, reason: str = "cancelled") -> None:
        """Trip the token: the run raises at its next check. The first
        cancel's reason wins."""
        if not self._cancel.is_set():
            self._reason = reason
            self._cancel.set()

    def cancel_at_boundary(self, reason: str = "preempted") -> None:
        """Soft cancel: the run raises at its next `boundary=True` check
        only, so the partition in flight finishes and saves its states
        first. The first soft cancel's reason wins; `cancel()` still
        trips everywhere."""
        if not self._soft_cancel.is_set():
            self._soft_reason = reason
            self._soft_cancel.set()

    def set_boundary_probe(
        self, probe: Optional[Callable[[Dict[str, Any]], Optional[str]]]
    ) -> None:
        """A hook run at every boundary check with the progress dict; a
        reason it returns soft-cancels the run."""
        self._boundary_probe = probe

    def bind_shared_cancel(self, token: "SharedCancelToken") -> None:
        """Chain a `SharedCancelToken` into the boundary probe: a token
        tripped by any shard cancels this run at its next partition
        boundary. A probe already set keeps running, and its reason wins."""
        prev = self._boundary_probe

        def probe(progress: Dict[str, Any]) -> Optional[str]:
            if prev is not None:
                reason = prev(progress)
                if reason:
                    return reason
            return token.reason()

        self._boundary_probe = probe

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def soft_cancelled(self) -> bool:
        return self._soft_cancel.is_set()

    def remaining_s(self) -> Optional[float]:
        """Seconds until the deadline, or None when none is set."""
        if self._deadline_at is None:
            return None
        return self._deadline_at - time.monotonic()

    def beat(self) -> None:
        """One unit of forward progress (a folded batch). Written by the
        fold thread alone."""
        self.beats += 1

    def check(
        self,
        where: str = "",
        progress: Optional[Dict[str, Any]] = None,
        *,
        boundary: bool = False,
    ) -> None:
        """Raise RunCancelled when cancelled or past the deadline. At a
        `boundary` (everything before it has saved its states) the probe
        runs and a soft cancel trips too."""
        if self._cancel.is_set():
            raise RunCancelled(self._reason, where=where, progress=progress)
        if self._deadline_at is not None and time.monotonic() > self._deadline_at:
            self._reason = "deadline"
            self._cancel.set()
            raise RunCancelled("deadline", where=where, progress=progress)
        if boundary:
            probe = self._boundary_probe
            if probe is not None:
                reason = probe(dict(progress or {}))
                if reason:
                    self.cancel_at_boundary(reason)
            if self._soft_cancel.is_set():
                raise RunCancelled(self._soft_reason, where=where, progress=progress)


class SharedCancelToken:
    """A cancel that crosses processes: one file every shard of a sharded
    scan can see. `trip` publishes a reason atomically (tmp file and
    rename); a shard's boundary probe (`RunController.bind_shared_cancel`)
    reads it at each partition boundary, a stat of one path. Any
    published reason cancels. A token whose directory vanished never
    trips: it cannot wedge or crash a run."""

    def __init__(self, path: str) -> None:
        self.path = str(path)

    def trip(self, reason: str = "cancelled") -> None:
        if os.path.exists(self.path):
            return
        tmp = f"{self.path}.{os.getpid()}.tmp"
        try:
            with open(tmp, "w", encoding="utf-8") as handle:
                handle.write(reason)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass

    def reason(self) -> Optional[str]:
        """The published reason, or None while untripped; an empty or
        unreadable file reads as "cancelled"."""
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path, encoding="utf-8") as handle:
                text = handle.read().strip()
        except OSError:
            return "cancelled"
        return text or "cancelled"

    @property
    def tripped(self) -> bool:
        return self.reason() is not None


class StallWatchdog:
    """A stall detector: a timer thread that watches the controller's
    beat count. One full window with no beat dumps the stages' state (the
    live heartbeat snapshot when one runs, else the deequ-* thread stacks)
    to stderr; a second silent window in a row cancels the run with
    reason "stalled" (DQ404), so a wedged scan fails with a diagnosis
    instead of hanging. A slow batch that recovers costs one dump, not
    the run."""

    def __init__(
        self,
        controller: RunController,
        timeout_s: float,
        *,
        out=None,
        snapshot_fn: Optional[Callable[[], Any]] = None,
    ) -> None:
        self.controller = controller
        self.timeout_s = float(timeout_s)
        self.dumps = 0
        self._out = out if out is not None else sys.stderr
        self._snapshot_fn = snapshot_fn
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "StallWatchdog":
        self._thread = threading.Thread(target=self._run, daemon=True, name="deequ-watchdog")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def _run(self) -> None:
        last = self.controller.beats
        silent_windows = 0
        while not self._stop.wait(self.timeout_s):
            now = self.controller.beats
            if now != last:
                last = now
                silent_windows = 0
                continue
            silent_windows += 1
            self._dump(now, silent_windows)
            if silent_windows >= 2:
                self.controller.cancel("stalled")
                return

    def _dump(self, beats: int, silent_windows: int) -> None:
        self.dumps += 1
        lines = [
            f"deequ-watchdog: no batch progress for "
            f"{silent_windows * self.timeout_s:g}s "
            f"(beats={beats}, window={self.timeout_s:g}s)"
        ]
        snap = None
        if self._snapshot_fn is not None:
            try:
                snap = self._snapshot_fn()
            except Exception:  # noqa: BLE001 - a diagnosis must not kill the run
                snap = None
        if snap:
            lines.append(f"deequ-watchdog: stage state: {snap}")
        else:
            lines.extend(_engine_thread_stacks())
        try:
            self._out.write("\n".join(lines) + "\n")
            self._out.flush()
        except Exception:  # noqa: BLE001 - a closed stream must not kill the run
            pass


def _engine_thread_stacks(prefix: str = "deequ-") -> list:
    """Where each of the engine's worker threads stands, one line each:
    the stages' state when no heartbeat snapshot is live."""
    frames = sys._current_frames()
    lines = []
    for t in threading.enumerate():
        if not t.name.startswith(prefix) or t.name == "deequ-watchdog":
            continue
        frame = frames.get(t.ident)
        if frame is None:
            continue
        stack = traceback.extract_stack(frame)
        tail = stack[-1] if stack else None
        where = f"{tail.filename}:{tail.lineno} {tail.name}" if tail else "?"
        lines.append(f"deequ-watchdog:   {t.name} @ {where}")
    return lines or ["deequ-watchdog:   (no engine worker threads alive)"]


def backoff_s(base_s: float, attempt: int, key: str = "") -> float:
    """Exponential backoff with a deterministic jitter for retry attempt
    `attempt` (0-based): `base * 2**attempt * U`, U in [0.5, 1.5) hashed
    from (key, attempt), so a fixed key gives a fixed schedule."""
    jitter = 0.5 + random.Random(f"{key}:{attempt}").random()
    return base_s * (2.0 ** attempt) * jitter


def retry_call(
    fn: Callable[[], Any],
    *,
    attempts: int,
    base_s: float,
    key: str = "",
    retryable: Tuple[type, ...] = (OSError,),
) -> Tuple[Any, int, bool]:
    """Call `fn` with up to `attempts` retries and exponential backoff.

    A `None` return counts as a transient failure too (the C reader's
    short read). Returns `(result, retries_used, recovered)`; when the
    budget runs out, `(None, attempts, False)`: the caller degrades (to
    pyarrow), it never raises. Exceptions outside `retryable` propagate."""
    retries = 0
    for attempt in range(attempts + 1):
        try:
            result = fn()
        except retryable:
            result = None
        if result is not None:
            return result, retries, retries > 0
        if attempt < attempts:
            retries += 1
            time.sleep(backoff_s(base_s, attempt, key))
    return None, retries, False


__all__ = [
    "DQ_CANCELLED",
    "DQ_DEADLINE",
    "DQ_DRAIN",
    "DQ_PREEMPTED",
    "DQ_QUOTA",
    "DQ_RETRIES_EXHAUSTED",
    "DQ_STALLED",
    "SOFT_REASONS",
    "RunCancelled",
    "RunController",
    "SharedCancelToken",
    "StallWatchdog",
    "backoff_s",
    "retry_call",
]
