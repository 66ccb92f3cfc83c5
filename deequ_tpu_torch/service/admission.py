"""EXPLAIN-first admission control.

Every submission is costed before any kernel launches: the same
``explain_plan`` that renders EXPLAIN runs over the submission's schema
and checks on the service's device, and its ``PlanCost`` decides the
scheduling tier (interactive, batch or heavy) and whether the
submission may enter at all. The gates, in order:

  1. EXPLAIN itself failed, or gave the DQ319 never-admittable lint (the
     plan predicts more scan bytes than the tenant's whole quota
     window): DQ410, rejected at admission;
  2. the tenant is at its pending-run budget, or its state-repository
     disk budget is already exceeded: DQ411, quota exceeded;
  3. the (tenant, dataset) circuit breaker denies entry: DQ413.

The breaker is asked last, so a submission rejected anyway never takes
a HALF_OPEN probe slot.

The JAX counterpart is deequ_tpu/service/admission.py: the same gates
in the same order.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Sequence

from deequ_tpu_torch.lint.cost import PlanCost
from deequ_tpu_torch.lint.explain import explain_plan
from deequ_tpu_torch.testing import faults

from .breaker import BreakerBoard
from .codes import DQ_BREAKER_OPEN, DQ_QUOTA_EXCEEDED, DQ_REJECTED
from .quotas import QuotaLedger

# the EXPLAIN lint that proves a plan can never fit the quota window
_NEVER_ADMITTABLE_CODE = "DQ319"


@dataclass(frozen=True)
class AdmissionDecision:
    admitted: bool
    #: the scheduling tier when admitted (interactive | batch | heavy)
    tier: Optional[str] = None
    #: the DQ41x code when not admitted
    code: Optional[str] = None
    reason: str = ""
    cost: Optional[PlanCost] = None


class AdmissionController:
    """Decisions over the ledger and the breaker board; no state of its
    own. ``device`` is the device the admitted runs use (None: the
    runners' default, the card): the cost model's placement is that
    device's."""

    def __init__(self, ledger: QuotaLedger, breakers: BreakerBoard, device: Any = None) -> None:
        self._ledger = ledger
        self._breakers = breakers
        self._device = device

    def evaluate(
        self,
        tenant: str,
        dataset: str,
        data: Any,
        checks: Sequence[Any],
        analyzers: Sequence[Any],
        *,
        pending_count: int,
        state_disk_usage: Optional[int] = None,
    ) -> AdmissionDecision:
        faults.fault_point("service.admission")
        quota = self._ledger.quota(tenant)

        # gate 1: cost the plan before anything runs
        try:
            report = explain_plan(
                data,
                analyzers=analyzers,
                checks=checks,
                quota_scan_bytes=quota.scan_bytes_per_window,
                device=self._device,
            )
        except Exception as exc:  # noqa: BLE001 — contain: reject, never crash the pool
            return AdmissionDecision(
                admitted=False, code=DQ_REJECTED, reason=f"EXPLAIN failed at admission: {exc}"
            )
        cost = report.cost
        for diag in report.diagnostics:
            if diag.code == _NEVER_ADMITTABLE_CODE:
                return AdmissionDecision(
                    admitted=False,
                    code=DQ_REJECTED,
                    reason=f"never admittable: {diag.message}",
                    cost=cost,
                )
        return self.decide(
            tenant, dataset, cost, pending_count=pending_count, state_disk_usage=state_disk_usage
        )

    def decide(
        self,
        tenant: str,
        dataset: str,
        cost: Optional[PlanCost],
        *,
        pending_count: int,
        state_disk_usage: Optional[int] = None,
    ) -> AdmissionDecision:
        """Gates 2 and 3 and the tier over a PlanCost already computed:
        the entry point of submissions that cost themselves (a window
        query costs its merge tree through `WindowQuery.admission_cost`);
        `evaluate` ends here after its EXPLAIN gate."""
        quota = self._ledger.quota(tenant)

        # gate 2: the tenant's budgets that are known before running
        if pending_count >= quota.max_pending:
            return AdmissionDecision(
                admitted=False,
                code=DQ_QUOTA_EXCEEDED,
                reason=f"tenant {tenant!r} at max_pending={quota.max_pending} runs",
                cost=cost,
            )
        if (
            quota.state_disk_bytes is not None
            and state_disk_usage is not None
            and state_disk_usage > quota.state_disk_bytes
        ):
            return AdmissionDecision(
                admitted=False,
                code=DQ_QUOTA_EXCEEDED,
                reason=(
                    f"tenant {tenant!r} state repository holds {state_disk_usage} "
                    f"bytes, budget {quota.state_disk_bytes}"
                ),
                cost=cost,
            )

        # gate 3: the breaker last, so no probe is spent on a reject
        if not self._breakers.allow(tenant, dataset):
            return AdmissionDecision(
                admitted=False,
                code=DQ_BREAKER_OPEN,
                reason=f"circuit breaker open for ({tenant!r}, {dataset!r})",
                cost=cost,
            )

        tier = (cost.admission_tier if cost is not None else None) or "batch"
        return AdmissionDecision(admitted=True, tier=tier, cost=cost)


__all__ = ["AdmissionController", "AdmissionDecision"]
