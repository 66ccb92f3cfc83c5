"""Chaos containment of the service on the port (the `service.*` fault
points of deequ_tpu_torch/service/).

Port-mapped from tests/test_service_chaos.py, every run on the CPU
(tests/torch_cpu.py). The claim is the blast radius: a fault injected
into the service's own machinery (admission's bookkeeping, a queue pop,
a worker, the scheduler's tick) may fail or delay the submission it
hits, but never (a) takes the pool down, (b) leaks into another tenant's
result bits, or (c) leaves threads behind after close(). Every case runs
two tenants and holds the untouched tenant's snapshot to a clean solo
run's.
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import threading
import time

import pytest

from deequ_tpu_torch import Check, CheckLevel, VerificationSuite
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.service import DQService
from deequ_tpu_torch.testing import faults
from test_suite_differential_fuzz import suite_snapshot

pytestmark = pytest.mark.usefixtures("cpu_default")


def _table(seed: int) -> Table:
    return Table.from_pydict(
        {
            "item": [str(i) for i in range(1, 7)],
            "att1": ["a", "b", "a", None, "b", "a"][seed % 2 :] + ["a"] * (seed % 2),
        }
    )


def _check() -> Check:
    return Check(CheckLevel.ERROR, "chaos").is_complete("item")


def _solo_snapshot(table: Table) -> tuple:
    return suite_snapshot(
        VerificationSuite().on_data(table).add_check(_check()).with_engine("single").run()
    )


def _service_threads() -> list:
    return [t for t in threading.enumerate() if "-service-" in (t.name or "")]


# one spec per service fault point, persistent and transient
SERVICE_CHAOS_MATRIX = [
    "seed=201,service.admission:1.0:1",   # one admission failure
    "seed=202,service.admission:0.6:3",   # flaky admission bookkeeping
    "seed=203,service.worker:1.0:1",      # one worker death mid-run
    "seed=204,service.worker:0.5:2",      # flaky workers
    "seed=205,service.queue:1.0:2",       # two queue pops fail
    "seed=206,stall=0.02,service.scheduler:1.0:4",  # wedged housekeeping
]


def test_matrix_is_the_reference_matrix():
    import test_service_chaos as reference

    assert SERVICE_CHAOS_MATRIX == reference.SERVICE_CHAOS_MATRIX


@pytest.mark.parametrize("spec", SERVICE_CHAOS_MATRIX)
def test_service_faults_contained_no_cross_tenant_blast(spec):
    """Inject each service.* fault while two tenants submit: the pool
    survives, at least one submission completes, and every COMPLETED
    result equals its solo run bit for bit: faults fail submissions,
    never corrupt them."""
    table_a, table_b = _table(0), _table(1)
    solo = {"a": _solo_snapshot(table_a), "b": _solo_snapshot(table_b)}

    svc = DQService(workers=2, tick_s=0.02)
    try:
        with faults.install(spec) as plan:
            handles = []
            for _round in range(3):
                handles.append(("a", svc.submit("tenant-a", "ds", table_a, checks=[_check()])))
                handles.append(("b", svc.submit("tenant-b", "ds", table_b, checks=[_check()])))
            for _, h in handles:
                assert h.wait(timeout=120), h
            injected = sum(plan.injected.values())

        done = [(t, h) for t, h in handles if h.status == "done"]
        assert done, "chaos must not starve the pool entirely"
        for tenant, h in done:
            assert suite_snapshot(h.result) == solo[tenant], (spec, tenant)
        # a failed submission says why
        for _, h in handles:
            if h.status == "failed":
                assert h.reason or h.error is not None
        if "scheduler" not in spec:
            assert injected >= 1, spec
    finally:
        svc.close()
    assert _service_threads() == []


def test_admission_fault_rejects_submission_but_pool_survives():
    """A raise-kind fault in admission's bookkeeping turns into a DQ410
    rejection of THAT submission; the next one (the fault budget spent)
    is admitted and runs to done."""
    table = _table(0)
    with DQService(workers=1) as svc:
        with faults.install("seed=42,service.admission:1.0:1"):
            h1 = svc.submit("t", "ds", table, checks=[_check()])
            assert h1.done() and h1.status == "rejected"
            assert "admission unavailable" in h1.reason
            h2 = svc.submit("t", "ds", table, checks=[_check()])
            assert h2.wait(timeout=60) and h2.status == "done"
        assert svc.telemetry.value("admission_faults") == 1


def test_worker_fault_feeds_breaker_not_pool():
    """A persistent worker fault fails every run of the tenant it hits
    and trips that tenant's breaker, while the OTHER tenant's runs on the
    same two workers keep completing bit for bit."""
    table_a, table_b = _table(0), _table(1)
    solo_b = _solo_snapshot(table_b)
    with DQService(workers=2, breaker_threshold=3, breaker_cooldown_s=3600) as svc:
        with faults.install("seed=7,service.worker:1.0"):
            failed = []
            for _ in range(3):
                h = svc.submit("victim", "ds", table_a, checks=[_check()])
                assert h.wait(timeout=60)
                failed.append(h.status)
        assert failed == ["failed", "failed", "failed"]
        assert svc.breakers.state("victim", "ds") == "open"
        assert svc.telemetry.value("worker_faults") == 3

        ok = svc.submit("bystander", "ds", table_b, checks=[_check()])
        assert ok.wait(timeout=60) and ok.status == "done"
        assert suite_snapshot(ok.result) == solo_b


def test_queue_fault_delays_but_never_drops_work():
    """A raise-kind fault on the queue pop comes BEFORE the item leaves
    its queue: the worker counts it, tries again, and the submission
    still runs, late but never lost."""
    table = _table(0)
    with DQService(workers=1) as svc:
        with faults.install("seed=11,service.queue:1.0:3") as plan:
            h = svc.submit("t", "ds", table, checks=[_check()])
            assert h.wait(timeout=120) and h.status == "done"
            assert sum(plan.injected.values()) >= 1
        assert svc.telemetry.value("queue_faults") >= 1


def test_scheduler_stall_does_not_block_execution():
    """Sleep-kind faults wedge the scheduler's tick; the workers do not
    depend on it, so submissions still complete."""
    table = _table(0)
    with DQService(workers=1, tick_s=0.01) as svc:
        with faults.install("seed=13,stall=0.05,service.scheduler:1.0:10"):
            h = svc.submit("t", "ds", table, checks=[_check()])
            assert h.wait(timeout=60) and h.status == "done"


def test_close_joins_all_threads_even_under_faults():
    """drain() leaves no service thread behind, even with chaos armed on
    every service point."""
    table = _table(0)
    spec = "seed=99,service.worker:0.5:2,service.queue:0.5:2,stall=0.01,service.scheduler:0.5:5"
    svc = DQService(workers=3, tick_s=0.01)
    with faults.install(spec):
        for _ in range(4):
            svc.submit("t", "ds", table, checks=[_check()])
        time.sleep(0.05)
        svc.close()
    assert _service_threads() == []
    # a second close does nothing
    svc.close()
    assert _service_threads() == []
