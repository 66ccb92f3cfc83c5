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

Codes: DQ401 an explicit `cancel()`, DQ402 a deadline; soft cancels
DQ405 a preemption, DQ406 a quota run out mid-run, DQ407 a graceful
drain.

The JAX counterpart is deequ_tpu/core/controller.py.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Callable, Dict, Optional

DQ_CANCELLED = "DQ401"
DQ_DEADLINE = "DQ402"
DQ_PREEMPTED = "DQ405"
DQ_QUOTA = "DQ406"
DQ_DRAIN = "DQ407"

_REASON_CODES = {
    "cancelled": DQ_CANCELLED,
    "deadline": DQ_DEADLINE,
    "preempted": DQ_PREEMPTED,
    "quota": DQ_QUOTA,
    "drain": DQ_DRAIN,
}

#: soft-cancel reasons: they trip only at `boundary=True` checks
SOFT_REASONS = frozenset({"preempted", "quota", "drain"})


class RunCancelled(RuntimeError):
    """A run ended early on purpose (a cancel or a deadline). Carries the
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
