"""The long-lived DQ service: a bounded worker pool with admission
control, tiered queues, preemptive scheduling and graceful drain.

Life of a submission
--------------------
``submit()`` EXPLAINs the plan first (admission.py): rejected work never
reaches a worker. Admitted work joins its tier's bounded FIFO
(interactive, batch, heavy); a full queue sheds by priority, then
deadline slack (DQ412). Workers take interactive before batch before
heavy, passing over tenants at their concurrency cap. An interactive
arrival with no idle worker soft-cancels one running heavy run
(``RunController.cancel_at_boundary("preempted")``, DQ405): the heavy
run's partition in flight still commits its states, the run re-queues
at the head of its tier, and its retry scans only the partitions left,
with the bits of an uninterrupted run, since partition states are a
mergeable semigroup.

Quotas are held in two steps: admission rejects what can never fit
(DQ410, DQ411, DQ413), and a probe at each partition boundary charges
the progress made against the tenant's sliding scan-bytes window and
disk budget and stops an overdrawn run with DQ406 *after* the partition
committed: the tenant loses headroom, not progress.

Drain (``drain()``, SIGTERM) stops intake, returns queued work with
DQ414, soft-cancels running work (DQ407, partitions in flight commit),
then joins every worker and the scheduler. ``close()`` may be called
again, and the service is a context manager.

One device per service: ``device`` (None: the card) is resolved once,
at construction, as the runners resolve theirs, and every run, plan
environment, tenant signature and window query of the service uses it.
On the card each worker's fused pass launches its kernels on the
worker thread's current stream, with a copy stream of its own.

The JAX counterpart is deequ_tpu/service/service.py, with the same
scheduling, codes and telemetry.
"""

from __future__ import annotations

import itertools
import signal
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.core.controller import RunCancelled, RunController
from deequ_tpu_torch.observe.heartbeat import publish_event
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.testing import faults

from .admission import AdmissionController
from .breaker import BreakerBoard
from .codes import DQ_BREAKER_OPEN, DQ_DRAINED, DQ_REJECTED, DQ_SHED
from .quotas import QuotaLedger, TenantQuota
from .telemetry import ServiceTelemetry
from .telemetry import publish as publish_telemetry

TIERS = ("interactive", "batch", "heavy")

DEFAULT_QUEUE_LIMITS = {"interactive": 16, "batch": 16, "heavy": 8}


class SubmissionHandle:
    """The caller's view of a submission: status, code and result.

    ``status`` moves through submitted -> queued -> running -> one of
    done | failed | rejected | shed | drained | cancelled | quota. A
    preempted run goes back to queued; only an end state sets the event
    ``wait()`` blocks on.
    """

    def __init__(self, tenant: str, dataset: str) -> None:
        self.tenant = tenant
        self.dataset = dataset
        self.status = "submitted"
        self.code: Optional[str] = None
        self.reason = ""
        self.result: Any = None
        self.error: Optional[BaseException] = None
        self.tier: Optional[str] = None
        self.cost: Any = None
        self.attempts = 0
        self.preemptions = 0
        # scan sharing: None when the run never met a share group, else
        # {"shared": bool, ...} with the subsumption proof and its drift
        # after the run (all zero on a sound share) or the decline reason
        self.sharing: Optional[Dict[str, Any]] = None
        self._done = threading.Event()

    def done(self) -> bool:
        return self._done.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        code = f" {self.code}" if self.code else ""
        return f"<SubmissionHandle {self.tenant}/{self.dataset} {self.status}{code}>"


class _Submission:
    """The service's record of one unit of queued or running work."""

    __slots__ = (
        "tenant", "dataset", "data", "checks", "analyzers", "priority",
        "deadline_s", "submitted_at", "handle", "tier", "cost",
        "controller", "seq", "counted", "engine", "fingerprint",
    )

    def __init__(
        self,
        tenant: str,
        dataset: str,
        data: Any,
        checks: Sequence[Any],
        analyzers: Sequence[Any],
        priority: int,
        deadline_s: Optional[float],
        submitted_at: float,
        handle: SubmissionHandle,
        tier: str,
        cost: Any,
        seq: int,
        engine: str = "single",
    ) -> None:
        self.tenant = tenant
        self.dataset = dataset
        self.data = data
        self.checks = list(checks)
        self.analyzers = list(analyzers)
        self.priority = priority
        self.deadline_s = deadline_s
        self.submitted_at = submitted_at
        self.handle = handle
        self.tier = tier
        self.cost = cost
        self.controller: Optional[RunController] = None
        self.seq = seq
        self.engine = engine
        # the dataset's identity by content, for scan sharing; None: the
        # run scans solo
        self.fingerprint: Optional[str] = None
        # whether this submission counts against the tenant's pending
        # budget (taken off exactly once)
        self.counted = True


class DQService:
    """A data-quality service for many tenants over a bounded worker pool."""

    def __init__(
        self,
        workers: Optional[int] = None,
        *,
        state_repository: Any = None,
        metrics_repository: Any = None,
        quotas: Optional[Dict[str, TenantQuota]] = None,
        queue_limits: Optional[Dict[str, int]] = None,
        breaker_threshold: int = 3,
        breaker_cooldown_s: float = 30.0,
        clock: Callable[[], float] = time.monotonic,
        tick_s: float = 0.05,
        name: str = "dq",
        device: runtime.DeviceLike = None,
    ) -> None:
        # once, here: never per worker thread
        self._device = runtime.resolve_device(device)
        self._workers_n = workers if workers is not None else runtime.service_workers()
        self._state_repository = state_repository
        self._metrics_repository = metrics_repository
        self._clock = clock
        self._tick_s = float(tick_s)
        self._name = name

        self.ledger = QuotaLedger(quotas, clock=clock)
        self.breakers = BreakerBoard(
            threshold=breaker_threshold, cooldown_s=breaker_cooldown_s, clock=clock
        )
        self.telemetry = ServiceTelemetry()
        self._admission = AdmissionController(self.ledger, self.breakers, device=self._device)

        self._cv = threading.Condition()
        self._queues: Dict[str, Deque[_Submission]] = {t: deque() for t in TIERS}
        self._queue_limits = dict(DEFAULT_QUEUE_LIMITS)
        if queue_limits:
            self._queue_limits.update(queue_limits)
        self._running: List[_Submission] = []
        self._pending: Dict[str, int] = {}
        self._seq = itertools.count()
        self._accepting = True
        self._stopping = False
        self._stop_event = threading.Event()
        self._prev_sigterm: Any = None

        self._threads: List[threading.Thread] = []
        for i in range(self._workers_n):
            t = threading.Thread(
                target=self._worker_loop, name=f"deequ-{name}-service-worker-{i}", daemon=True
            )
            t.start()
            self._threads.append(t)
        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name=f"deequ-{name}-service-scheduler", daemon=True
        )
        self._scheduler.start()

    # ------------------------------------------------------------------
    # intake

    def submit(
        self,
        tenant: str,
        dataset: str,
        data: Any,
        *,
        checks: Sequence[Any] = (),
        analyzers: Sequence[Any] = (),
        priority: int = 0,
        deadline_s: Optional[float] = None,
        engine: str = "single",
    ) -> SubmissionHandle:
        """Submit a suite; returns at once with a handle.

        ``data`` is the table to verify, or a callable with no arguments
        returning it (a factory; admission then costs the plan over the
        factory's result, so it should open the table lazily).
        """
        handle = SubmissionHandle(tenant, dataset)
        self.telemetry.count("submitted")

        with self._cv:
            if not self._accepting:
                return self._finalize_locked_handle(
                    handle, "drained", DQ_DRAINED, "service is draining; resubmit after restart"
                )
            pending = self._pending.get(tenant, 0)

        # fail fast on an open breaker before the factory runs: no work
        # for a fenced-off pair, and no half-open probe taken
        if self.breakers.open_now(tenant, dataset):
            self.telemetry.count("rejected")
            return self._finalize_locked_handle(
                handle, "rejected", DQ_BREAKER_OPEN,
                f"circuit breaker open for ({tenant!r}, {dataset!r})",
            )

        try:
            table = data() if callable(data) else data
        except Exception as exc:  # noqa: BLE001 — a factory that cannot
            # open its dataset (a corrupt file, a dead mount) is the
            # dataset's failure, not the service's: it feeds the breaker
            self.breakers.record_failure(tenant, dataset)
            self.telemetry.count("failed")
            handle.error = exc
            return self._finalize_locked_handle(
                handle, "failed", None, f"dataset open failed: {type(exc).__name__}: {exc}"
            )
        try:
            decision = self._admission.evaluate(
                tenant, dataset, table, checks, analyzers,
                pending_count=pending,
                state_disk_usage=self._state_disk_usage(tenant, dataset),
            )
        except faults.InjectedFaultError as exc:
            # contained: admission's bookkeeping failed, the pool did not
            self.telemetry.count("admission_faults")
            return self._finalize_locked_handle(
                handle, "rejected", DQ_REJECTED, f"admission unavailable: {exc}"
            )
        if not decision.admitted:
            self.telemetry.count("rejected")
            handle.cost = decision.cost
            publish_event("service.rejected", tenant=tenant, dataset=dataset, code=decision.code)
            return self._finalize_locked_handle(handle, "rejected", decision.code, decision.reason)

        self.telemetry.count("admitted")
        tier = decision.tier or "batch"
        handle.tier = tier
        handle.cost = decision.cost
        sub = _Submission(
            tenant, dataset, data, checks, analyzers, priority, deadline_s, self._clock(),
            handle, tier, decision.cost, next(self._seq), engine,
        )
        if engine == "single" and runtime.scan_sharing_enabled():
            from .sharing import dataset_fingerprint

            try:
                sub.fingerprint = dataset_fingerprint(data, table)
            except Exception:  # fault-ok: no identity, no sharing
                sub.fingerprint = None
        return self._admit(sub)

    def submit_window(
        self,
        tenant: str,
        dataset: str,
        source: Any,
        *,
        window: Any,
        analyzers: Sequence[Any],
        priority: int = 0,
        deadline_s: Optional[float] = None,
        extractor: Any = None,
        warm: bool = True,
    ) -> SubmissionHandle:
        """Submit a windowed metrics query (windows/query.py) as an
        ordinary submission costed at admission. The plan costs itself
        through `WindowQuery.admission_cost`: over warm segments it
        predicts almost no scan bytes, so a windowed suite run at every
        ingest admits as 'interactive'. The handle's result is the
        window's `AnalyzerContext` (with `window_plan` attached)."""
        from deequ_tpu_torch.windows.query import WindowQuery

        handle = SubmissionHandle(tenant, dataset)
        self.telemetry.count("submitted")

        with self._cv:
            if not self._accepting:
                return self._finalize_locked_handle(
                    handle, "drained", DQ_DRAINED, "service is draining; resubmit after restart"
                )
            pending = self._pending.get(tenant, 0)

        if self._state_repository is None:
            self.telemetry.count("rejected")
            return self._finalize_locked_handle(
                handle, "rejected", DQ_REJECTED,
                "window submissions need a state repository "
                "(the merge tree resolves against cached states)",
            )
        if self.breakers.open_now(tenant, dataset):
            self.telemetry.count("rejected")
            return self._finalize_locked_handle(
                handle, "rejected", DQ_BREAKER_OPEN,
                f"circuit breaker open for ({tenant!r}, {dataset!r})",
            )

        try:
            src = source() if callable(source) else source
            query = WindowQuery(
                src,
                list(analyzers),
                repository=self._state_repository,
                dataset=self._state_dataset(tenant, dataset),
                extractor=extractor,
                device=self._device,
            )
            cost = query.admission_cost(window)
        except Exception as exc:  # noqa: BLE001 — a bad source or spec is
            # the submission's failure, not the pool's
            self.breakers.record_failure(tenant, dataset)
            self.telemetry.count("failed")
            handle.error = exc
            return self._finalize_locked_handle(
                handle, "failed", None, f"window plan failed: {type(exc).__name__}: {exc}"
            )
        try:
            decision = self._admission.decide(
                tenant, dataset, cost,
                pending_count=pending,
                state_disk_usage=self._state_disk_usage(tenant, dataset),
            )
        except faults.InjectedFaultError as exc:
            self.telemetry.count("admission_faults")
            return self._finalize_locked_handle(
                handle, "rejected", DQ_REJECTED, f"admission unavailable: {exc}"
            )
        if not decision.admitted:
            self.telemetry.count("rejected")
            handle.cost = decision.cost
            publish_event("service.rejected", tenant=tenant, dataset=dataset, code=decision.code)
            return self._finalize_locked_handle(handle, "rejected", decision.code, decision.reason)

        self.telemetry.count("admitted")
        tier = decision.tier or "batch"
        handle.tier = tier
        handle.cost = decision.cost

        def run_window():
            return query.run(window, warm=warm, tracing=True)

        sub = _Submission(
            tenant, dataset, run_window, (), tuple(analyzers), priority, deadline_s,
            self._clock(), handle, tier, decision.cost, next(self._seq), "window",
        )
        return self._admit(sub)

    def _admit(self, sub: _Submission) -> SubmissionHandle:
        """Queue an admitted submission, unless the service began
        draining meanwhile or the queue sheds it."""
        with self._cv:
            if not self._accepting:
                return self._finalize_locked_handle(
                    sub.handle, "drained", DQ_DRAINED, "service began draining during admission"
                )
            if not self._enqueue_locked(sub):
                return sub.handle  # shed; the handle is final
            self._pending[sub.tenant] = self._pending.get(sub.tenant, 0) + 1
            sub.handle.status = "queued"
            if sub.tier == "interactive":
                self._maybe_preempt_locked()
            self._cv.notify_all()
        return sub.handle

    def _enqueue_locked(self, sub: _Submission) -> bool:
        """FIFO enqueue, shedding when the queue is full. False when the
        new submission itself was shed."""
        q = self._queues[sub.tier]
        if len(q) < self._queue_limits[sub.tier]:
            q.append(sub)
            return True
        # full: compare with the worst queued item by (priority, deadline
        # slack); a bigger key is more worth keeping
        now = self._clock()

        def keep_key(s: _Submission) -> Tuple[int, float]:
            slack = float("inf") if s.deadline_s is None else (s.submitted_at + s.deadline_s) - now
            # high priority first; on a tie LESS slack (a closer deadline
            # is more urgent) is more worth keeping
            return (s.priority, -slack)

        worst = min(q, key=keep_key)
        if keep_key(sub) > keep_key(worst):
            q.remove(worst)
            self._shed_locked(worst, "displaced by higher-priority work")
            q.append(sub)
            return True
        self.telemetry.count("shed")
        self._finalize_locked_handle(
            sub.handle, "shed", DQ_SHED,
            f"{sub.tier} queue saturated ({self._queue_limits[sub.tier]} deep)",
        )
        return False

    def _shed_locked(self, sub: _Submission, why: str) -> None:
        self.telemetry.count("shed")
        self._decrement_pending_locked(sub)
        publish_event("service.shed", tenant=sub.tenant, dataset=sub.dataset, why=why)
        self._finalize_locked_handle(sub.handle, "shed", DQ_SHED, why)

    def _finalize_locked_handle(
        self,
        handle: SubmissionHandle,
        status: str,
        code: Optional[str],
        reason: str,
    ) -> SubmissionHandle:
        handle.status = status
        handle.code = code
        handle.reason = reason
        handle._done.set()
        return handle

    def _decrement_pending_locked(self, sub: _Submission) -> None:
        if not sub.counted:
            return
        sub.counted = False
        n = self._pending.get(sub.tenant, 0)
        if n <= 1:
            self._pending.pop(sub.tenant, None)
        else:
            self._pending[sub.tenant] = n - 1

    def _state_disk_usage(self, tenant: str, dataset: str) -> Optional[int]:
        if self._state_repository is None:
            return None
        try:
            return self._state_repository.disk_usage(self._state_dataset(tenant, dataset))
        except OSError:  # fault-ok: an unknowable usage never blocks admission
            return None

    @staticmethod
    def _state_dataset(tenant: str, dataset: str) -> str:
        return f"{tenant}/{dataset}"

    # ------------------------------------------------------------------
    # scheduling

    def _pop_next_locked(self) -> Optional[_Submission]:
        for tier in TIERS:
            q = self._queues[tier]
            if not q:
                continue
            # highest priority first, FIFO within a priority; tenants at
            # their concurrency cap wait
            best: Optional[_Submission] = None
            for s in q:
                if self._at_concurrency_cap_locked(s.tenant):
                    continue
                if best is None or (s.priority, -s.seq) > (best.priority, -best.seq):
                    best = s
            if best is None:
                continue
            faults.fault_point("service.queue")
            q.remove(best)
            return best
        return None

    def _at_concurrency_cap_locked(self, tenant: str) -> bool:
        running = sum(1 for s in self._running if s.tenant == tenant)
        return running >= self.ledger.quota(tenant).max_concurrent

    def _collect_share_group_locked(self, lead: _Submission) -> List[_Submission]:
        """Gather the queued submissions over provably the SAME data as
        ``lead`` (the same dataset fingerprint) into one share group.
        Peers leave their queues and join ``_running`` at once: the group
        holds ONE worker and runs one superset scan. Tenant concurrency
        caps count group members; ``DEEQU_TPU_SHARE_GROUP_MAX`` bounds the
        group."""
        if lead.fingerprint is None or lead.engine != "single" or not runtime.scan_sharing_enabled():
            return [lead]
        group = [lead]
        limit = runtime.share_group_max()
        for tier in TIERS:
            if len(group) >= limit:
                break
            q = self._queues[tier]
            for s in list(q):
                if len(group) >= limit:
                    break
                if s.fingerprint != lead.fingerprint or s.engine != "single":
                    continue
                # members already joined _running, so the cap counts them
                if self._at_concurrency_cap_locked(s.tenant):
                    continue
                q.remove(s)
                self._running.append(s)
                s.handle.status = "running"
                group.append(s)
        return group

    def _maybe_preempt_locked(self) -> None:
        """An interactive arrival with no idle worker bumps one running
        heavy run (a soft cancel: its partition commits)."""
        if not self._queues["interactive"] or len(self._running) < self._workers_n:
            return  # nothing waits, or an idle worker takes it
        for s in self._running:
            if s.tier != "heavy" or s.controller is None:
                continue
            if s.controller.soft_cancelled or s.controller.cancelled:
                continue
            s.controller.cancel_at_boundary("preempted")
            publish_event("service.preempt", tenant=s.tenant, dataset=s.dataset)
            return

    def _scheduler_loop(self) -> None:
        while not self._stop_event.wait(self._tick_s):
            try:
                faults.fault_point("service.scheduler")
            except OSError:  # fault-ok: a raise-kind fault loses one tick
                continue
            with self._cv:
                self._expire_queued_locked()
                self._maybe_preempt_locked()
                self._cv.notify_all()

    def _expire_queued_locked(self) -> None:
        now = self._clock()
        for tier in TIERS:
            q = self._queues[tier]
            expired = [
                s for s in q
                if s.deadline_s is not None and (s.submitted_at + s.deadline_s) <= now
            ]
            for s in expired:
                q.remove(s)
                self._shed_locked(s, "deadline expired while queued")

    # ------------------------------------------------------------------
    # workers

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                sub = None
                while sub is None:
                    if self._stopping:
                        return
                    try:
                        sub = self._pop_next_locked()
                    except faults.InjectedFaultError:
                        # contained: the pop failed before the item left
                        # its queue; count it and retry on the next wake
                        self.telemetry.count("queue_faults")
                        sub = None
                    if sub is None:
                        self._cv.wait(timeout=0.1)
                self._running.append(sub)
                sub.handle.status = "running"
                group = self._collect_share_group_locked(sub)
            try:
                if len(group) > 1:
                    self._execute_shared(group)
                else:
                    self._execute(sub)
            finally:
                with self._cv:
                    for s in group:
                        if s in self._running:
                            self._running.remove(s)
                    self._cv.notify_all()

    def _finish_done(self, sub: _Submission, result: Any) -> None:
        self.breakers.record_success(sub.tenant, sub.dataset)
        self.telemetry.count("completed")
        sub.handle.result = result
        with self._cv:
            self._decrement_pending_locked(sub)
            self._finalize_locked_handle(sub.handle, "done", None, "")

    def _finish_failed(self, sub: _Submission, exc: BaseException) -> None:
        self.breakers.record_failure(sub.tenant, sub.dataset)
        sub.handle.error = exc
        with self._cv:
            self._decrement_pending_locked(sub)
            self._finalize_locked_handle(sub.handle, "failed", None, f"{type(exc).__name__}: {exc}")

    def _execute(self, sub: _Submission) -> None:
        # the verification stack loads on the first run, so importing the
        # service for its codes stays light
        from deequ_tpu_torch.verification.suite import VerificationSuite

        handle = sub.handle
        handle.attempts += 1
        remaining: Optional[float] = None
        if sub.deadline_s is not None:
            remaining = (sub.submitted_at + sub.deadline_s) - self._clock()
            if remaining <= 0:
                with self._cv:
                    self._shed_locked(sub, "deadline expired before start")
                return
        ctl = RunController(deadline_s=remaining)
        ctl.set_boundary_probe(self._boundary_probe(sub))
        with self._cv:
            sub.controller = ctl
        try:
            faults.fault_point("service.worker")
            if sub.engine == "window":
                # a window query carries its own closure (WindowQuery.run):
                # no suite, no scan over warm segments
                self._finish_done(sub, sub.data())
                return
            table = sub.data() if callable(sub.data) else sub.data
            builder = VerificationSuite.on_data(table, device=self._device).with_controller(ctl)
            for check in sub.checks:
                builder = builder.add_check(check)
            for analyzer in sub.analyzers:
                builder = builder.add_required_analyzer(analyzer)
            builder = builder.with_engine(sub.engine)
            if self._state_repository is not None:
                builder = builder.with_state_repository(
                    self._state_repository, dataset=self._state_dataset(sub.tenant, sub.dataset)
                )
            result = builder.run()
        except RunCancelled as exc:
            self._on_cancelled(sub, exc)
            return
        except Exception as exc:  # noqa: BLE001 — contained: one bad run (a
            # chaos fault, a corrupt dataset, a kernel error) takes neither
            # the worker thread nor the pool down; it fails its handle
            self.telemetry.count("failed")
            if isinstance(exc, faults.InjectedFaultError):
                self.telemetry.count("worker_faults")
            self._finish_failed(sub, exc)
            publish_event("service.failed", tenant=sub.tenant, dataset=sub.dataset)
            return
        self._finish_done(sub, result)

    # ------------------------------------------------------------------
    # shared scans (service/sharing.py)

    def _execute_shared(self, group: List[_Submission]) -> None:
        """Run one share group: prove every member's plan contained in the
        union plan, run ONE superset scan, and fan the folded states out
        to each member's constraint evaluation. Members the prover
        declines run solo on the same worker: sharing saves work, it
        never gates it."""
        from . import sharing

        live: List[_Submission] = []
        for sub in group:
            if sub.deadline_s is not None and (sub.submitted_at + sub.deadline_s) - self._clock() <= 0:
                with self._cv:
                    self._shed_locked(sub, "deadline expired before start")
                continue
            live.append(sub)
        if not live:
            return

        participants: List[_Submission] = []
        proofs: List[Any] = []
        solo: List[_Submission] = []
        table = None
        if len(live) > 1:
            lead = live[0]
            try:
                table = lead.data() if callable(lead.data) else lead.data
                plans = [sharing.submission_plan(s.checks, s.analyzers) for s in live]
                _union, group_proofs, declines = sharing.plan_share_group(
                    plans, table, device=self._device
                )
            except Exception:  # noqa: BLE001 — a failed proof or open never
                # fails the work: everything runs solo
                solo = live
            else:
                for sub, proof, decline in zip(live, group_proofs, declines):
                    if decline is None:
                        participants.append(sub)
                        proofs.append(proof)
                    else:
                        self.telemetry.count("sharing_declined")
                        sub.handle.sharing = {"shared": False, "reason": decline}
                        solo.append(sub)
                if len(participants) < 2:
                    solo = participants + solo
                    participants, proofs = [], []
        else:
            solo = live

        if participants:
            self._run_shared_scan(participants, proofs, table)
        for sub in solo:
            self._execute(sub)

    def _run_shared_scan(
        self,
        participants: List[_Submission],
        proofs: List[Any],
        table: Any,
    ) -> None:
        from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
        from deequ_tpu_torch.runners.context import AnalyzerContext
        from deequ_tpu_torch.verification.suite import VerificationSuite

        from . import sharing

        self.telemetry.count("shared_scans")
        self.telemetry.count("shared_participants", len(participants))

        plans = [sharing.submission_plan(s.checks, s.analyzers) for s in participants]
        union, _memberships = self._union_plan(plans)

        ctl = RunController()
        overdrawn: set = set()
        ctl.set_boundary_probe(self._shared_boundary_probe(participants, overdrawn))
        with self._cv:
            for sub in participants:
                sub.controller = ctl
                sub.handle.attempts += 1

        fanout_repo = None
        if self._state_repository is not None:
            # each tenant's entries are signed as its own solo run on this
            # service's device signs them: the same analyzers in the same
            # order, the same fold variant
            tenants = [
                sharing.TenantStatePlan(
                    self._state_dataset(s.tenant, s.dataset),
                    sharing._solo_order(s.checks, s.analyzers),
                    table,
                    device=self._device,
                )
                for s in participants
            ]
            fanout_repo = sharing.FanoutStateRepository(self._state_repository, tenants)

        captures = None
        forensics = None
        if runtime.forensics_enabled():
            from deequ_tpu_torch.observe.forensics import ForensicsCapture

            captures = [ForensicsCapture(s.checks) for s in participants]
            forensics = sharing.ForensicsFanout(captures)

        try:
            faults.fault_point("service.worker")
            context = AnalysisRunner.do_analysis_run(
                table,
                union,
                device=self._device,
                engine="single",
                validation="off",
                state_repository=fanout_repo,
                dataset_name=sharing.shared_dataset_name(participants[0].fingerprint or "anon"),
                forensics=forensics,
                controller=ctl,
            )
        except RunCancelled as exc:
            # one scan, one fate: EVERY participant resumes (a preemption
            # re-queues) or ends with the same DQ40x, never a partial
            # fan-out
            for sub in participants:
                self._on_cancelled(sub, exc)
            return
        except Exception as exc:  # noqa: BLE001 — contained, as a solo run
            self.telemetry.count("failed")
            if isinstance(exc, faults.InjectedFaultError):
                self.telemetry.count("worker_faults")
            for sub in participants:
                self._finish_failed(sub, exc)
                publish_event("service.failed", tenant=sub.tenant, dataset=sub.dataset)
            return

        executed = [repr(a) for a in context.metric_map]
        try:
            from deequ_tpu_torch.lint import SchemaInfo

            schema = SchemaInfo.from_table(table)
        except Exception:  # noqa: BLE001 — the diagnostics are advisory
            schema = None
        publish_event(
            "service.shared_scan",
            participants=len(participants),
            fingerprint=participants[0].fingerprint,
        )
        for i, sub in enumerate(participants):
            handle = sub.handle
            if sub.tenant in overdrawn:
                self._on_cancelled(
                    sub,
                    RunCancelled(
                        "quota",
                        where="shared scan fan-out",
                        progress={"participants": len(participants)},
                    ),
                )
                continue
            try:
                metrics = {a: context.metric_map[a] for a in plans[i] if a in context.metric_map}
                result = VerificationSuite.evaluate(sub.checks, AnalyzerContext(metrics))
                if schema is not None:
                    try:
                        from deequ_tpu_torch.lint.planlint import validate_plan

                        report = validate_plan(
                            schema,
                            sub.checks,
                            sub.analyzers,
                            mode="lenient",
                            num_rows=int(table.num_rows),
                            sharing_with=union,
                            device=self._device,
                        )
                        result.validation_warnings = list(report.diagnostics)
                        result.plan_cost = report.plan_cost
                    except Exception:  # fault-ok: the lint diagnostics are
                        # advisory; the verified result stands without them
                        pass
                if captures is not None:
                    result.forensics_report = captures[i].finalize(result.check_results)
                handle.sharing = {
                    "shared": True,
                    "participants": len(participants),
                    "proof": proofs[i].to_dict(),
                    "drift": proofs[i].pin(executed),
                }
                self._finish_done(sub, result)
            except Exception as exc:  # noqa: BLE001 — one tenant's evaluation
                # failing must not poison its co-tenants
                self.telemetry.count("failed")
                self._finish_failed(sub, exc)

    @staticmethod
    def _union_plan(plans: List[List[Any]]) -> Tuple[List[Any], List[List[int]]]:
        from deequ_tpu_torch.ops.fused import build_union_plan

        return build_union_plan(plans)

    def _shared_boundary_probe(
        self, subs: List[_Submission], overdrawn: set
    ) -> Callable[[Dict[str, Any]], Optional[str]]:
        """Pro-rata quotas for one shared scan: each newly committed
        partition's bytes (the UNION's read, taken as the widest
        participant's prediction) are split among the participants in
        proportion to their own solo demand. An overdrawn tenant is marked
        and dropped at the fan-out (DQ406) while the scan goes on for the
        others; the scan itself stops only when every participant is
        overdrawn."""
        from .sharing import prorata_weights

        predicted = [
            float(s.cost.predicted_scan_bytes)
            if s.cost is not None and s.cost.predicted_scan_bytes is not None
            else 0.0
            for s in subs
        ]
        _union_bytes, shares = prorata_weights(predicted)
        charged = {"parts": 0}

        def probe(progress: Dict[str, Any]) -> Optional[str]:
            done = int(progress.get("partitions_done", 0))
            scanned = done - int(progress.get("partitions_cached", 0))
            total = int(progress.get("partitions_total", 0)) or 1
            new = scanned - charged["parts"]
            if new > 0:
                charged["parts"] = scanned
                for s, share in zip(subs, shares):
                    if s.tenant in overdrawn:
                        continue
                    charge = new * share / total
                    if charge > 0:
                        self.ledger.charge_scan(s.tenant, charge)
                        self.telemetry.charge_tenant_bytes(s.tenant, charge)
            for s in subs:
                if s.tenant not in overdrawn and self._over_quota(s):
                    overdrawn.add(s.tenant)
            if all(s.tenant in overdrawn for s in subs):
                return "quota"
            return None

        return probe

    def _over_quota(self, sub: _Submission) -> bool:
        """Whether the tenant is past its scan window or its state-disk
        budget now."""
        if self.ledger.over_scan_budget(sub.tenant):
            return True
        quota = self.ledger.quota(sub.tenant)
        if quota.state_disk_bytes is None:
            return False
        usage = self._state_disk_usage(sub.tenant, sub.dataset)
        return usage is not None and usage > quota.state_disk_bytes

    def _on_cancelled(self, sub: _Submission, exc: RunCancelled) -> None:
        handle = sub.handle
        # a cancel says nothing about the dataset's health
        self.breakers.record_neutral(sub.tenant, sub.dataset)
        if exc.reason == "preempted":
            # re-queue at the HEAD so the run resumes next
            self.telemetry.count("preempted")
            handle.preemptions += 1
            with self._cv:
                if self._accepting and not self._stopping:
                    sub.controller = None
                    handle.status = "queued"
                    self._queues[sub.tier].appendleft(sub)
                    self._cv.notify_all()
                    return
                # preempted during a drain: drained
                self._decrement_pending_locked(sub)
                self._finalize_locked_handle(
                    handle, "drained", DQ_DRAINED,
                    "preempted while service drained; committed partition "
                    "states resume the run after restart",
                )
            return
        if exc.reason == "quota":
            self.telemetry.count("quota_stops")
            status = "quota"
        elif exc.reason == "drain":
            self.telemetry.count("drained")
            status = "drained"
        else:
            status = "cancelled"
        handle.error = exc
        with self._cv:
            self._decrement_pending_locked(sub)
            self._finalize_locked_handle(handle, status, exc.code, str(exc))
        publish_event("service." + status, tenant=sub.tenant, dataset=sub.dataset, code=exc.code)

    def _boundary_probe(self, sub: _Submission) -> Callable[[Dict[str, Any]], Optional[str]]:
        """Quotas at each partition boundary: each newly committed
        partition is charged to the tenant's sliding window (the EXPLAIN
        cost split evenly over the partitions), and once overdrawn the run
        stops with DQ406, after the partition committed, so no progress
        is lost."""
        cost = sub.cost
        predicted = 0.0
        if cost is not None and cost.predicted_scan_bytes is not None:
            predicted = float(cost.predicted_scan_bytes)
        charged = {"parts": 0}

        def probe(progress: Dict[str, Any]) -> Optional[str]:
            done = int(progress.get("partitions_done", 0))
            # only SCANNED partitions are charged: a cache hit reads no data
            scanned = done - int(progress.get("partitions_cached", 0))
            # the static plan may not know the partition split; the
            # progress of a partitioned run always does
            total = int(progress.get("partitions_total", 0)) or 1
            per_part = predicted / total
            new = scanned - charged["parts"]
            if new > 0 and per_part > 0:
                charge = new * per_part
                self.ledger.charge_scan(sub.tenant, charge)
                self.telemetry.charge_tenant_bytes(sub.tenant, charge)
                charged["parts"] = scanned
            return "quota" if self._over_quota(sub) else None

        return probe

    # ------------------------------------------------------------------
    # introspection and telemetry

    def queue_depths(self) -> Dict[str, int]:
        with self._cv:
            return {tier: len(q) for tier, q in self._queues.items()}

    def running_count(self) -> int:
        with self._cv:
            return len(self._running)

    def telemetry_snapshot(self) -> Dict[str, float]:
        return self.telemetry.snapshot(
            queue_depths=self.queue_depths(),
            running=self.running_count(),
            workers=self._workers_n,
            breaker_open=self.breakers.open_count(),
            breaker_transitions=self.breakers.transitions(),
        )

    def publish_telemetry(self) -> Optional[Dict[str, float]]:
        if self._metrics_repository is None:
            return None
        record = self.telemetry_snapshot()
        publish_telemetry(self._metrics_repository, record)
        return record

    # ------------------------------------------------------------------
    # drain and shutdown

    def drain(self, timeout_s: Optional[float] = None) -> None:
        """Graceful shutdown: stop intake, return queued work with DQ414,
        soft-cancel running work so its partitions in flight commit, then
        join every thread. At the timeout the soft cancel turns hard."""
        if timeout_s is None:
            timeout_s = runtime.service_drain_s()
        with self._cv:
            already = self._stopping and not self._accepting
            self._accepting = False
            queued: List[_Submission] = []
            for tier in TIERS:
                q = self._queues[tier]
                queued.extend(q)
                q.clear()
            for sub in queued:
                self.telemetry.count("drained")
                self._decrement_pending_locked(sub)
                self._finalize_locked_handle(
                    sub.handle, "drained", DQ_DRAINED,
                    "returned unrun by graceful drain; committed partition "
                    "states resume the run after restart",
                )
            for sub in self._running:
                if sub.controller is not None:
                    sub.controller.cancel_at_boundary("drain")
            self._cv.notify_all()
        if already:
            return
        publish_event("service.drain", name=self._name, queued=len(queued))
        deadline = self._clock() + float(timeout_s)
        with self._cv:
            while self._running and self._clock() < deadline:
                self._cv.wait(timeout=0.1)
            # past the timeout: the soft cancel turns hard
            for sub in self._running:
                if sub.controller is not None:
                    sub.controller.cancel("drain")
            while self._running:
                self._cv.wait(timeout=0.1)
        try:
            self.publish_telemetry()
        except Exception:  # fault-ok: telemetry must not block the drain
            pass
        self._shutdown_threads()

    def _shutdown_threads(self) -> None:
        self._stop_event.set()
        with self._cv:
            self._stopping = True
            self._cv.notify_all()
        for t in self._threads:
            t.join(timeout=10.0)
        self._scheduler.join(timeout=10.0)

    def close(self) -> None:
        self.drain()

    def __enter__(self) -> "DQService":
        return self

    def __exit__(self, *exc_info: Any) -> None:
        self.close()

    # ------------------------------------------------------------------
    # SIGTERM

    def install_sigterm(self) -> None:
        """Drain on SIGTERM (from the main thread only, as Python allows).
        The handler does not exit the process: the host decides what
        happens once the pool is quiet."""

        def _handler(signum: int, frame: Any) -> None:
            self.drain()

        self._prev_sigterm = signal.signal(signal.SIGTERM, _handler)

    def uninstall_sigterm(self) -> None:
        if self._prev_sigterm is not None:
            signal.signal(signal.SIGTERM, self._prev_sigterm)
            self._prev_sigterm = None


__all__ = [
    "DEFAULT_QUEUE_LIMITS",
    "TIERS",
    "DQService",
    "SubmissionHandle",
]
