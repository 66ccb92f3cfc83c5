"""Cooperative run control: a cancel token and a deadline, honoured at
batch and partition boundaries.

A `RunController` threads suite -> runner -> fused scan. The scan calls
`check()` before each batch (and before each partition of a partitioned
source); a tripped check raises `RunCancelled` with the run's progress.
The raise unwinds through `contextlib.closing` around the staged
pipeline and the source's `batches()` generator, so every stage thread,
decode thread and open file joins through the same shutdown an exhausted
scan takes.

Codes: DQ401 an explicit `cancel()`, DQ402 a deadline.

The JAX counterpart is deequ_tpu/core/controller.py.
"""

from __future__ import annotations

import threading
import time
from typing import Any, Dict, Optional

DQ_CANCELLED = "DQ401"
DQ_DEADLINE = "DQ402"

_REASON_CODES = {
    "cancelled": DQ_CANCELLED,
    "deadline": DQ_DEADLINE,
}


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

    def cancel(self, reason: str = "cancelled") -> None:
        """Trip the token: the run raises at its next check. The first
        cancel's reason wins."""
        if not self._cancel.is_set():
            self._reason = reason
            self._cancel.set()

    def check(self, where: str = "", progress: Optional[Dict[str, Any]] = None) -> None:
        """Raise RunCancelled when cancelled or past the deadline."""
        if self._cancel.is_set():
            raise RunCancelled(self._reason, where=where, progress=progress)
        if self._deadline_at is not None and time.monotonic() > self._deadline_at:
            self._reason = "deadline"
            self._cancel.set()
            raise RunCancelled("deadline", where=where, progress=progress)
