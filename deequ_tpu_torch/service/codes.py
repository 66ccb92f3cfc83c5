"""The service's DQ41x codes: why a SUBMISSION was turned away.

The codes a RUN ends with (DQ401-DQ407: cancelled, deadline, stalled,
preempted, quota at a boundary, drain) live in `core/controller.py`;
this module holds the codes a submission gets before, or instead of,
running:

  * DQ410 — rejected at admission: EXPLAIN proved the plan can never fit
    the tenant's quota window (the DQ319 lint), or admission failed;
  * DQ411 — quota exceeded at admission: the tenant is at its
    pending-run budget or over its state-repository disk budget (the
    mid-run stop at a partition boundary is the controller's DQ406);
  * DQ412 — shed on overload: the tier queue was full and this
    submission, or the queued one it displaced, lost the
    priority-then-deadline comparison, or its deadline passed while it
    queued;
  * DQ413 — circuit breaker open: the (tenant, dataset) pair failed its
    runs again and again and stays fenced off until a half-open probe
    succeeds after the cooldown;
  * DQ414 — drained: the service was shut down (SIGTERM or close()) and
    returned this queued submission unrun; partition states that earlier
    attempts committed still resume it after a restart.

The JAX counterpart is deequ_tpu/service/codes.py, with the same codes.
"""

from __future__ import annotations

DQ_REJECTED = "DQ410"
DQ_QUOTA_EXCEEDED = "DQ411"
DQ_SHED = "DQ412"
DQ_BREAKER_OPEN = "DQ413"
DQ_DRAINED = "DQ414"

#: code -> one-line meaning, for operators
CODE_MEANINGS = {
    DQ_REJECTED: "rejected at admission (EXPLAIN-first gate)",
    DQ_QUOTA_EXCEEDED: "tenant quota exceeded at admission",
    DQ_SHED: "shed on overload (priority/deadline)",
    DQ_BREAKER_OPEN: "circuit breaker open for (tenant, dataset)",
    DQ_DRAINED: "returned unrun by a graceful drain",
}

__all__ = [
    "CODE_MEANINGS",
    "DQ_BREAKER_OPEN",
    "DQ_DRAINED",
    "DQ_QUOTA_EXCEEDED",
    "DQ_REJECTED",
    "DQ_SHED",
]
