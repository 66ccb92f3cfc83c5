"""Tenant quotas and the sliding-window scan ledger.

A tenant's quota bounds three resources:

  * concurrency: how many of its runs may hold workers at once
    (``max_concurrent``) and how many may be in the service at all,
    running or queued (``max_pending``);
  * scan bytes: how many predicted scan bytes it may use inside a
    sliding window (``scan_bytes_per_window`` over ``window_s``
    seconds), charged per committed partition at run boundaries, so a
    long heavy run cannot outrun its budget;
  * state disk: how many bytes its committed partition states may hold
    in the state repository (``state_disk_bytes``), checked at admission
    and at every partition boundary.

The ledger is a plain sliding window, not a token bucket: charges carry
their time and expire, so a tenant that bursts is held back for one
window and is then whole again.

The JAX counterpart is deequ_tpu/service/quotas.py; under one clock and
one sequence of charges both ledgers end in the same state.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable, Deque, Dict, List, Optional, Tuple


@dataclass(frozen=True)
class TenantQuota:
    """One tenant's budget. A ``None`` field is unmetered."""

    #: runs that may hold workers at once
    max_concurrent: int = 2
    #: runs that may be in the service at all (running and queued)
    max_pending: int = 16
    #: predicted scan bytes admitted inside one sliding window
    scan_bytes_per_window: Optional[float] = None
    #: the width of the scan-bytes window, in seconds
    window_s: float = 60.0
    #: bytes the tenant's committed states may hold in the state repository
    state_disk_bytes: Optional[int] = None


DEFAULT_QUOTA = TenantQuota()


class QuotaLedger:
    """Per-tenant scan-bytes ledger over a sliding window, safe across
    threads. Every clock read goes through the injected ``clock``, so a
    test can drive time by hand."""

    def __init__(
        self,
        quotas: Optional[Dict[str, TenantQuota]] = None,
        *,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        self._lock = threading.Lock()
        self._quotas: Dict[str, TenantQuota] = dict(quotas or {})
        self._clock = clock
        # tenant -> (charged_at, nbytes) in charge order, pruned lazily
        self._charges: Dict[str, Deque[Tuple[float, float]]] = {}
        # lifetime totals outlive the window, for telemetry
        self._totals: Dict[str, float] = {}

    def set_quota(self, tenant: str, quota: TenantQuota) -> None:
        with self._lock:
            self._quotas[tenant] = quota

    def quota(self, tenant: str) -> TenantQuota:
        with self._lock:
            return self._quotas.get(tenant, DEFAULT_QUOTA)

    def charge_scan(self, tenant: str, nbytes: float) -> None:
        """Charge ``nbytes`` of scan to the tenant's window."""
        if nbytes <= 0:
            return
        now = self._clock()
        with self._lock:
            self._charges.setdefault(tenant, deque()).append((now, float(nbytes)))
            self._totals[tenant] = self._totals.get(tenant, 0.0) + float(nbytes)

    def _prune_locked(self, tenant: str, now: float) -> Deque[Tuple[float, float]]:
        window = self._quotas.get(tenant, DEFAULT_QUOTA).window_s
        charges = self._charges.setdefault(tenant, deque())
        while charges and now - charges[0][0] > window:
            charges.popleft()
        return charges

    def bytes_in_window(self, tenant: str) -> float:
        now = self._clock()
        with self._lock:
            return sum(n for _, n in self._prune_locked(tenant, now))

    def scan_headroom(self, tenant: str) -> Optional[float]:
        """The window budget left: negative when overdrawn, None when
        unmetered."""
        quota = self.quota(tenant)
        if quota.scan_bytes_per_window is None:
            return None
        return quota.scan_bytes_per_window - self.bytes_in_window(tenant)

    def over_scan_budget(self, tenant: str) -> bool:
        headroom = self.scan_headroom(tenant)
        return headroom is not None and headroom < 0

    def bytes_total(self, tenant: str) -> float:
        with self._lock:
            return self._totals.get(tenant, 0.0)

    def tenants(self) -> List[str]:
        with self._lock:
            return sorted(set(self._quotas) | set(self._totals))


__all__ = ["DEFAULT_QUOTA", "QuotaLedger", "TenantQuota"]
