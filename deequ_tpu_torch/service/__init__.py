"""The data-quality service: many tenants' suites on one bounded worker
pool, none of them hurting the others.

  * `admission`  EXPLAIN-first admission control (DQ410, DQ411, DQ413);
  * `quotas`     budgets per tenant and the sliding scan-bytes ledger;
  * `breaker`    circuit breakers per (tenant, dataset);
  * `service`    the `DQService` pool: tiered queues, preemptive
                 scheduling (interactive work bumps heavy runs at
                 partition boundaries), shedding on overload, drain;
  * `sharing`    scan sharing: one proven superset scan for the
                 submissions over one dataset, fanned out per tenant;
  * `telemetry`  the `engine.service.*` counters the sentinel watches;
  * `codes`      the DQ41x submission codes.

The JAX counterpart is deequ_tpu/service/, with the same names.
"""

from .admission import AdmissionController, AdmissionDecision
from .breaker import BreakerBoard
from .codes import (
    CODE_MEANINGS,
    DQ_BREAKER_OPEN,
    DQ_DRAINED,
    DQ_QUOTA_EXCEEDED,
    DQ_REJECTED,
    DQ_SHED,
)
from .quotas import DEFAULT_QUOTA, QuotaLedger, TenantQuota
from .service import DEFAULT_QUEUE_LIMITS, TIERS, DQService, SubmissionHandle
from .telemetry import ServiceTelemetry

__all__ = [
    "CODE_MEANINGS",
    "DEFAULT_QUEUE_LIMITS",
    "DEFAULT_QUOTA",
    "DQ_BREAKER_OPEN",
    "DQ_DRAINED",
    "DQ_QUOTA_EXCEEDED",
    "DQ_REJECTED",
    "DQ_SHED",
    "TIERS",
    "AdmissionController",
    "AdmissionDecision",
    "BreakerBoard",
    "DQService",
    "QuotaLedger",
    "ServiceTelemetry",
    "SubmissionHandle",
    "TenantQuota",
]
