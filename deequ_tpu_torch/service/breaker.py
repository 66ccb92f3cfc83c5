"""Circuit breakers per (tenant, dataset).

A dataset that keeps failing its runs (a corrupt file, a schema that
drifted, a flaky filesystem) must not burn the pool's workers for ever,
and its failures must not spill into other tenants' budgets. Each
(tenant, dataset) pair gets a three-state breaker:

  CLOSED    healthy; failures are counted, and ``threshold`` in a row
            trip the breaker OPEN.
  OPEN      submissions are rejected (DQ413) until ``cooldown_s`` has
            passed, then the breaker turns HALF_OPEN.
  HALF_OPEN exactly one probe submission is admitted: success closes
            the breaker, failure opens it again with a fresh cooldown.

A probe that ends for a neutral reason (preempted, drained: the run
said nothing about the dataset's health) frees the probe slot and
stays HALF_OPEN, so the next submission probes again.

The JAX counterpart is deequ_tpu/service/breaker.py; under one clock
and one sequence of outcomes both boards end in the same states.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Tuple

CLOSED = "closed"
OPEN = "open"
HALF_OPEN = "half_open"


class _Breaker:
    __slots__ = ("state", "failures", "opened_at", "probing")

    def __init__(self) -> None:
        self.state = CLOSED
        self.failures = 0
        self.opened_at = 0.0
        self.probing = False


class BreakerBoard:
    """The circuit breakers of every (tenant, dataset) pair, safe across
    threads."""

    def __init__(
        self,
        *,
        threshold: int = 3,
        cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self._threshold = max(1, int(threshold))
        self._cooldown_s = float(cooldown_s)
        self._clock = clock
        self._breakers: Dict[Tuple[str, str], _Breaker] = {}
        self._transitions = 0

    def _get_locked(self, tenant: str, dataset: str) -> _Breaker:
        return self._breakers.setdefault((tenant, dataset), _Breaker())

    def allow(self, tenant: str, dataset: str) -> bool:
        """Whether a submission of this pair may enter the pool now. An
        OPEN breaker past its cooldown turns HALF_OPEN here, and a
        HALF_OPEN one grants one probe at a time."""
        with self._lock:
            b = self._get_locked(tenant, dataset)
            if b.state == CLOSED:
                return True
            if b.state == OPEN:
                if self._clock() - b.opened_at < self._cooldown_s:
                    return False
                b.state = HALF_OPEN
                b.probing = False
                self._transitions += 1
            if b.probing:
                return False
            b.probing = True
            return True

    def open_now(self, tenant: str, dataset: str) -> bool:
        """True while the pair is OPEN inside its cooldown. A pure read,
        unlike ``allow()``: a caller can fail fast before any work per
        submission without taking a half-open probe."""
        with self._lock:
            b = self._get_locked(tenant, dataset)
            return b.state == OPEN and self._clock() - b.opened_at < self._cooldown_s

    def record_success(self, tenant: str, dataset: str) -> None:
        with self._lock:
            b = self._get_locked(tenant, dataset)
            if b.state != CLOSED:
                self._transitions += 1
            b.state = CLOSED
            b.failures = 0
            b.probing = False

    def record_failure(self, tenant: str, dataset: str) -> None:
        with self._lock:
            b = self._get_locked(tenant, dataset)
            if b.state == HALF_OPEN:
                b.state = OPEN
                b.opened_at = self._clock()
                b.probing = False
                self._transitions += 1
                return
            b.failures += 1
            if b.state == CLOSED and b.failures >= self._threshold:
                b.state = OPEN
                b.opened_at = self._clock()
                self._transitions += 1

    def record_neutral(self, tenant: str, dataset: str) -> None:
        """The run ended without a word on the dataset's health
        (preempted, drained): free the probe slot, keep the state."""
        with self._lock:
            self._get_locked(tenant, dataset).probing = False

    def state(self, tenant: str, dataset: str) -> str:
        with self._lock:
            return self._get_locked(tenant, dataset).state

    def open_count(self) -> int:
        with self._lock:
            return sum(1 for b in self._breakers.values() if b.state == OPEN)

    def transitions(self) -> int:
        with self._lock:
            return self._transitions

    def pairs(self) -> List[Tuple[str, str]]:
        with self._lock:
            return sorted(self._breakers)


__all__ = ["CLOSED", "HALF_OPEN", "OPEN", "BreakerBoard"]
