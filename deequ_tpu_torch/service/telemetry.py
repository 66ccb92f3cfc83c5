"""The DQ service's telemetry.

Counters are plain integers under one lock: the service's hot paths
already hold their own locks there, so this costs one more uncontended
acquire. ``snapshot()`` flattens them into the ``engine.service.*``
float namespace, so the engine-metric repository
(repository/engine.py) persists them and the sentinel trends them like
any other engine metric.

The JAX counterpart is deequ_tpu/service/telemetry.py, with the same
series names.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, Mapping, Optional

from deequ_tpu_torch.repository.engine import engine_result_key, persist_engine_record

PREFIX = "engine.service."

#: the counters every snapshot carries, zeros included
COUNTERS = (
    "submitted",
    "admitted",
    "rejected",
    "shed",
    "preempted",
    "drained",
    "quota_stops",
    "completed",
    "failed",
    "queue_faults",
    "worker_faults",
    "admission_faults",
    # scan sharing (service/sharing.py)
    "shared_scans",
    "shared_participants",
    "sharing_declined",
)


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c in "-_" else "_" for c in name)


class ServiceTelemetry:
    """Counters and per-tenant scan-byte sums, safe across threads."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {name: 0 for name in COUNTERS}
        self._tenant_bytes: Dict[str, float] = {}

    def count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def value(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def charge_tenant_bytes(self, tenant: str, nbytes: float) -> None:
        if nbytes <= 0:
            return
        with self._lock:
            self._tenant_bytes[tenant] = self._tenant_bytes.get(tenant, 0.0) + float(nbytes)

    def snapshot(
        self,
        *,
        queue_depths: Mapping[str, int],
        running: int,
        workers: int,
        breaker_open: int,
        breaker_transitions: int,
    ) -> Dict[str, float]:
        """One flat ``engine.service.*`` record, ready to persist."""
        with self._lock:
            counts = dict(self._counts)
            tenant_bytes = dict(self._tenant_bytes)
        record: Dict[str, float] = {PREFIX + name: float(value) for name, value in counts.items()}
        for tier, depth in queue_depths.items():
            record[PREFIX + f"queue_depth.{tier}"] = float(depth)
        record[PREFIX + "running"] = float(running)
        record[PREFIX + "workers"] = float(workers)
        record[PREFIX + "breaker_open"] = float(breaker_open)
        record[PREFIX + "breaker_transitions"] = float(breaker_transitions)
        submitted = counts.get("submitted", 0)
        if submitted > 0:
            record[PREFIX + "shed_ratio"] = counts.get("shed", 0) / submitted
        for tenant, nbytes in tenant_bytes.items():
            record[PREFIX + f"tenant.{_sanitize(tenant)}.bytes_scanned"] = nbytes
        return record


def publish(
    repository: Any,
    record: Dict[str, float],
    *,
    suite: str = "service",
    dataset: str = "fleet",
    tags: Optional[Dict[str, str]] = None,
) -> None:
    """Persist one service snapshot through the engine-metric repository."""
    key = engine_result_key(suite=suite, dataset=dataset, tags=dict(tags or {"component": "service"}))
    persist_engine_record(repository, record, key, instance="service")


__all__ = ["COUNTERS", "PREFIX", "ServiceTelemetry", "publish"]
