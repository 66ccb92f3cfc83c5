"""The data-quality service on the port (deequ_tpu_torch/service/):
admission control, tenant quotas, circuit breakers, preemptive
scheduling, and the preempt-then-resume bit-identity contract.

Port-mapped from tests/test_service.py: the same cases against
deequ_tpu_torch, every run on the CPU (tests/torch_cpu.py), the suites
drawn by the JAX fuzzer's `random_check` bound to the port's Check DSL.
Then the SIGTERM drain case of tests/test_pipeline_shutdown.py.

The cases at the end hold the port to the JAX package: the four service
knobs; admission's tier, code and quota headroom over the same schema,
quotas and plans; and the ledger and the breakers under one fake clock
and one sequence of events.
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import os
import threading
import time

import numpy as np
import pytest

import test_suite_differential_fuzz as fuzz
from deequ_tpu_torch import Check, CheckLevel, CheckStatus, VerificationSuite
from deequ_tpu_torch.core.controller import (
    DQ_DRAIN,
    DQ_PREEMPTED,
    DQ_QUOTA,
    RunCancelled,
    RunController,
)
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.lint.explain import explain_plan
from deequ_tpu_torch.repository import InMemoryMetricsRepository
from deequ_tpu_torch.repository.engine import engine_series
from deequ_tpu_torch.repository.states import FileSystemStateRepository
from deequ_tpu_torch.service import (
    DQ_BREAKER_OPEN,
    DQ_DRAINED,
    DQ_QUOTA_EXCEEDED,
    DQ_REJECTED,
    DQ_SHED,
    BreakerBoard,
    DQService,
    QuotaLedger,
    TenantQuota,
)
from deequ_tpu_torch.service.admission import AdmissionController
from torch_stream_helpers import port_random_check, port_table

pytestmark = pytest.mark.usefixtures("cpu_default")

random_check = port_random_check(fuzz)
random_table = fuzz.random_table
suite_snapshot = fuzz.suite_snapshot
_write_partition = fuzz._write_partition


def _small_table() -> Table:
    return Table.from_pydict(
        {
            "item": ["1", "2", "3", "4"],
            "att1": ["a", "a", "a", "b"],
        }
    )


def _basic_check() -> Check:
    return Check(CheckLevel.ERROR, "basic").is_complete("item")


# ---------------------------------------------------------------------------
# quotas: the sliding scan-bytes ledger
# ---------------------------------------------------------------------------


class FakeClock:
    def __init__(self) -> None:
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


def test_quota_ledger_sliding_window():
    clock = FakeClock()
    ledger = QuotaLedger(
        {"acme": TenantQuota(scan_bytes_per_window=100.0, window_s=10.0)},
        clock=clock,
    )
    ledger.charge_scan("acme", 60.0)
    assert ledger.bytes_in_window("acme") == 60.0
    assert ledger.scan_headroom("acme") == 40.0
    assert not ledger.over_scan_budget("acme")

    ledger.charge_scan("acme", 60.0)
    assert ledger.scan_headroom("acme") == -20.0
    assert ledger.over_scan_budget("acme")

    # the window slides: old charges expire and the tenant is whole
    clock.advance(11.0)
    assert ledger.bytes_in_window("acme") == 0.0
    assert not ledger.over_scan_budget("acme")
    # lifetime totals outlive the pruning (telemetry)
    assert ledger.bytes_total("acme") == 120.0


def test_quota_ledger_unmetered_tenant_has_no_headroom_concept():
    ledger = QuotaLedger()
    ledger.charge_scan("anon", 1e12)
    assert ledger.scan_headroom("anon") is None
    assert not ledger.over_scan_budget("anon")


# ---------------------------------------------------------------------------
# circuit breakers
# ---------------------------------------------------------------------------


def test_breaker_trips_after_threshold_and_cools_down():
    clock = FakeClock()
    board = BreakerBoard(threshold=3, cooldown_s=30.0, clock=clock)
    pair = ("acme", "orders")

    for _ in range(2):
        board.record_failure(*pair)
        assert board.allow(*pair)  # still closed below the threshold
    board.record_failure(*pair)
    assert board.state(*pair) == "open"
    assert not board.allow(*pair)
    assert board.open_count() == 1

    # the cooldown passes: half-open grants exactly ONE probe
    clock.advance(31.0)
    assert board.allow(*pair)
    assert board.state(*pair) == "half_open"
    assert not board.allow(*pair)  # a second caller: the slot is taken

    # the probe succeeds: closed, failures reset
    board.record_success(*pair)
    assert board.state(*pair) == "closed"
    assert board.allow(*pair)


def test_breaker_half_open_failure_reopens_with_fresh_cooldown():
    clock = FakeClock()
    board = BreakerBoard(threshold=1, cooldown_s=10.0, clock=clock)
    board.record_failure("t", "d")
    clock.advance(11.0)
    assert board.allow("t", "d")
    board.record_failure("t", "d")  # the probe failed
    assert board.state("t", "d") == "open"
    clock.advance(5.0)
    assert not board.allow("t", "d")  # a fresh cooldown, not the old one
    clock.advance(6.0)
    assert board.allow("t", "d")


def test_breaker_neutral_probe_releases_slot_stays_half_open():
    clock = FakeClock()
    board = BreakerBoard(threshold=1, cooldown_s=10.0, clock=clock)
    board.record_failure("t", "d")
    clock.advance(11.0)
    assert board.allow("t", "d")
    # the probe was preempted or drained: it says nothing about health
    board.record_neutral("t", "d")
    assert board.state("t", "d") == "half_open"
    assert board.allow("t", "d")  # the next submission probes again


def test_breaker_isolates_pairs():
    board = BreakerBoard(threshold=1)
    board.record_failure("acme", "orders")
    assert not board.allow("acme", "orders")
    assert board.allow("acme", "payments")
    assert board.allow("globex", "orders")


# ---------------------------------------------------------------------------
# admission control: the EXPLAIN-first gates
# ---------------------------------------------------------------------------


def _admission(quotas=None):
    ledger = QuotaLedger(quotas)
    board = BreakerBoard(threshold=1)
    return AdmissionController(ledger, board), ledger, board


def test_admission_admits_small_plan_as_interactive():
    ctl, _, _ = _admission()
    d = ctl.evaluate("acme", "orders", _small_table(), [_basic_check()], [], pending_count=0)
    assert d.admitted
    assert d.tier == "interactive"
    assert d.cost is not None and d.cost.admission_tier == "interactive"


def test_admission_rejects_never_admittable_plan_dq410():
    """A plan predicting more scan than the tenant's whole window is
    DQ319 at EXPLAIN and DQ410 at admission: it never reaches a worker."""
    ctl, _, _ = _admission({"acme": TenantQuota(scan_bytes_per_window=1.0, window_s=60.0)})
    d = ctl.evaluate("acme", "orders", _small_table(), [_basic_check()], [], pending_count=0)
    assert not d.admitted
    assert d.code == DQ_REJECTED
    assert "never admittable" in d.reason


def test_admission_rejects_at_max_pending_dq411():
    ctl, _, _ = _admission({"acme": TenantQuota(max_pending=2)})
    d = ctl.evaluate("acme", "orders", _small_table(), [_basic_check()], [], pending_count=2)
    assert not d.admitted
    assert d.code == DQ_QUOTA_EXCEEDED


def test_admission_rejects_blown_state_disk_budget_dq411():
    ctl, _, _ = _admission({"acme": TenantQuota(state_disk_bytes=100)})
    d = ctl.evaluate(
        "acme", "orders", _small_table(), [_basic_check()], [],
        pending_count=0, state_disk_usage=101,
    )
    assert not d.admitted
    assert d.code == DQ_QUOTA_EXCEEDED


def test_admission_breaker_open_dq413_and_checked_last():
    ctl, _, board = _admission({"acme": TenantQuota(max_pending=1)})
    board.record_failure("acme", "orders")

    d = ctl.evaluate("acme", "orders", _small_table(), [_basic_check()], [], pending_count=0)
    assert not d.admitted and d.code == DQ_BREAKER_OPEN

    # the breaker runs LAST: a quota-rejected submission must not take
    # the half-open probe slot
    board2 = BreakerBoard(threshold=1, cooldown_s=0.0)
    ctl2 = AdmissionController(QuotaLedger({"acme": TenantQuota(max_pending=1)}), board2)
    board2.record_failure("acme", "orders")
    time.sleep(0.01)  # past the zero cooldown: half-open on the next allow
    d = ctl2.evaluate(
        "acme", "orders", _small_table(), [_basic_check()], [],
        pending_count=1,  # quota-rejected before the breaker is asked
    )
    assert d.code == DQ_QUOTA_EXCEEDED
    assert board2.allow("acme", "orders")  # the probe slot is still free


# ---------------------------------------------------------------------------
# EXPLAIN: the admission line and the DQ319 lint
# ---------------------------------------------------------------------------


def test_explain_renders_admission_line_with_headroom():
    report = explain_plan(_small_table(), checks=[_basic_check()], quota_scan_bytes=1 << 20)
    text = report.render()
    assert "admission: tier=interactive" in text
    assert "quota headroom" in text
    assert not any(d.code == "DQ319" for d in report.diagnostics)


def test_explain_dq319_when_plan_exceeds_quota_window():
    report = explain_plan(_small_table(), checks=[_basic_check()], quota_scan_bytes=1.0)
    codes = [d.code for d in report.diagnostics]
    assert "DQ319" in codes
    assert "quota overdrawn" in report.render()


def test_cost_tier_thresholds(monkeypatch):
    from deequ_tpu_torch.lint import cost as cost_mod

    report = explain_plan(_small_table(), checks=[_basic_check()])
    cost = report.cost
    assert cost.predicted_scan_bytes is not None
    assert cost.admission_tier == "interactive"

    # the thresholds around the plan's prediction
    monkeypatch.setattr(cost_mod, "ADMISSION_INTERACTIVE_BYTES", 0.0)
    monkeypatch.setattr(cost_mod, "ADMISSION_HEAVY_BYTES", 1e18)
    assert cost_mod.cost_tier(cost) == "batch"
    monkeypatch.setattr(cost_mod, "ADMISSION_HEAVY_BYTES", 1.0)
    assert cost_mod.cost_tier(cost) == "heavy"


# ---------------------------------------------------------------------------
# the controller: soft cancels at partition boundaries
# ---------------------------------------------------------------------------


def test_soft_cancel_only_trips_at_boundary():
    ctl = RunController()
    ctl.cancel_at_boundary("preempted")
    ctl.check(where="mid-batch")  # checks off a boundary pass
    with pytest.raises(RunCancelled) as exc:
        ctl.check(where="partition 2", boundary=True)
    assert exc.value.code == DQ_PREEMPTED
    assert exc.value.reason == "preempted"


def test_boundary_probe_can_stop_run_with_quota():
    ctl = RunController()
    ctl.set_boundary_probe(
        lambda progress: "quota" if progress.get("partitions_done", 0) >= 2 else None
    )
    ctl.check(progress={"partitions_done": 1}, boundary=True)
    with pytest.raises(RunCancelled) as exc:
        ctl.check(progress={"partitions_done": 2}, boundary=True)
    assert exc.value.code == DQ_QUOTA


def test_drain_reason_maps_to_dq407():
    ctl = RunController()
    ctl.cancel_at_boundary("drain")
    with pytest.raises(RunCancelled) as exc:
        ctl.check(boundary=True)
    assert exc.value.code == DQ_DRAIN


# ---------------------------------------------------------------------------
# preempt, then resume: bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("placement", ["host", "device"])
def test_preempt_resume_bit_identical_both_placements(placement, monkeypatch, tmp_path):
    """Soft-cancel a partitioned run after its first committed partition,
    then run it again over the same repository: the resumed run loads the
    committed states, scans only the rest, and its result is EXACTLY the
    uninterrupted run's, sketches included."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    rng = np.random.default_rng(41_000)
    checks = [random_check(rng) for _ in range(2)]
    data_dir = tmp_path / "dataset"
    data_dir.mkdir()
    n_parts = 4
    for i in range(n_parts):
        _write_partition(random_table(rng), str(data_dir / f"part-{i}.parquet"))

    def build(repo=None):
        data = Table.scan_parquet_dataset(str(data_dir))
        builder = VerificationSuite().on_data(data)
        for check in checks:
            builder = builder.add_check(check)
        if repo is not None:
            builder = builder.with_state_repository(repo, "svc")
        return builder.with_engine("single")

    baseline = suite_snapshot(build().run())

    repo = FileSystemStateRepository(str(tmp_path / "states"))
    ctl = RunController()
    seen = {"parts": 0}

    def preempt_after_first(progress):
        seen["parts"] = progress.get("partitions_done", 0)
        return "preempted" if seen["parts"] >= 1 else None

    ctl.set_boundary_probe(preempt_after_first)
    with pytest.raises(RunCancelled) as exc:
        build(repo).with_controller(ctl).run()
    assert exc.value.code == DQ_PREEMPTED
    done_at_preempt = exc.value.progress.get("partitions_done", seen["parts"])
    assert 1 <= done_at_preempt < n_parts

    # resume: the committed partitions load from the repository
    resumed = build(repo).with_tracing(True).run()
    counters = resumed.run_trace.counters
    assert counters["partitions_cached"] == done_at_preempt
    assert counters["partitions_scanned"] == n_parts - done_at_preempt
    assert suite_snapshot(resumed) == baseline


# ---------------------------------------------------------------------------
# the service end to end
# ---------------------------------------------------------------------------


def _wait_all(handles, timeout=60.0):
    deadline = time.monotonic() + timeout
    for h in handles:
        assert h.wait(timeout=max(0.1, deadline - time.monotonic())), h
    return handles


def test_service_runs_suite_to_done():
    with DQService(workers=2) as svc:
        h = svc.submit("acme", "orders", _small_table(), checks=[_basic_check()])
        assert h.wait(timeout=60)
        assert h.status == "done" and h.code is None
        assert h.tier == "interactive"
        assert h.result.status == CheckStatus.SUCCESS
        snap = svc.telemetry_snapshot()
        assert snap["engine.service.completed"] == 1.0
        assert snap["engine.service.admitted"] == 1.0


def test_service_rejects_after_close_dq414():
    svc = DQService(workers=1)
    svc.close()
    h = svc.submit("acme", "orders", _small_table(), checks=[_basic_check()])
    assert h.done() and h.status == "drained" and h.code == DQ_DRAINED


def test_service_rejects_never_admittable_dq410():
    quotas = {"acme": TenantQuota(scan_bytes_per_window=1.0)}
    with DQService(workers=1, quotas=quotas) as svc:
        h = svc.submit("acme", "orders", _small_table(), checks=[_basic_check()])
        assert h.done()  # rejected at once, before any dispatch
        assert h.status == "rejected" and h.code == DQ_REJECTED


def test_service_breaker_trips_on_corrupt_dataset(tmp_path):
    """Three runs over an unreadable dataset trip the (tenant, dataset)
    breaker; the fourth is DQ413 without a worker, while the tenant's
    OTHER dataset still runs."""
    bad = tmp_path / "corrupt.parquet"
    bad.write_bytes(b"PAR1 this is not parquet")

    def bad_data():
        return Table.scan_parquet_dataset(str(tmp_path))

    with DQService(workers=1, breaker_threshold=3, breaker_cooldown_s=3600) as svc:
        for _ in range(3):
            h = svc.submit("acme", "bad", bad_data, checks=[_basic_check()])
            assert h.wait(timeout=60)
            assert h.status == "failed"
        assert svc.breakers.state("acme", "bad") == "open"

        h = svc.submit("acme", "bad", bad_data, checks=[_basic_check()])
        assert h.done() and h.code == DQ_BREAKER_OPEN

        ok = svc.submit("acme", "good", _small_table(), checks=[_basic_check()])
        assert ok.wait(timeout=60) and ok.status == "done"


def test_service_sheds_on_saturated_queue_dq412(monkeypatch):
    """With no idle worker and an interactive queue 2 deep, the fourth
    low-priority submission is shed, and a high-priority arrival
    displaces a queued low-priority one instead."""
    gate = threading.Event()

    def slow_data():
        gate.wait(timeout=30)
        return _small_table()

    svc = DQService(workers=1, queue_limits={"interactive": 2})
    try:
        running = svc.submit("t", "d0", slow_data, checks=[_basic_check()])
        # wait until the worker took it, so the queue is empty behind it
        for _ in range(200):
            if running.status == "running":
                break
            time.sleep(0.01)
        q1 = svc.submit("t", "d1", _small_table(), checks=[_basic_check()])
        q2 = svc.submit("t", "d2", _small_table(), checks=[_basic_check()])
        shed = svc.submit("t", "d3", _small_table(), checks=[_basic_check()])
        assert shed.done() and shed.status == "shed" and shed.code == DQ_SHED

        vip = svc.submit("t", "vip", _small_table(), checks=[_basic_check()], priority=5)
        # the worst queued low-priority item was displaced
        displaced = [h for h in (q1, q2) if h.done() and h.status == "shed"]
        assert len(displaced) == 1
        gate.set()
        survivors = [h for h in (running, q1, q2, vip) if not h.done()]
        _wait_all(survivors)
        assert vip.status == "done"
        assert svc.telemetry.value("shed") == 2
    finally:
        gate.set()
        svc.close()


def test_service_quota_stop_mid_run_dq406(tmp_path):
    """The tenant's window already holds an earlier run's charges on
    another dataset; the next run is admissible (DQ319 needs a prediction
    above the whole window) but overdraws the window at a partition
    boundary: DQ406 AFTER that partition committed, so a later run
    resumes instead of starting over."""
    rng = np.random.default_rng(7)
    check = Check(CheckLevel.ERROR, "x").is_complete("x")
    dirs = []
    for d in ("d1", "d2"):
        data_dir = tmp_path / d
        data_dir.mkdir()
        for i in range(4):
            _write_partition(random_table(rng), str(data_dir / f"part-{i}.parquet"))
        dirs.append(str(data_dir))

    repo = FileSystemStateRepository(str(tmp_path / "states"))
    p1 = explain_plan(Table.scan_parquet_dataset(dirs[0]), checks=[check]).cost.predicted_scan_bytes
    p2 = explain_plan(Table.scan_parquet_dataset(dirs[1]), checks=[check]).cost.predicted_scan_bytes
    assert p1 and p2
    # fits either run alone (no DQ319) but not both in one window
    window = max(p1, p2) * 1.25
    quotas = {"tight": TenantQuota(scan_bytes_per_window=window, window_s=3600)}

    with DQService(workers=1, quotas=quotas, state_repository=repo) as svc:
        first = svc.submit(
            "tight", "d1", lambda: Table.scan_parquet_dataset(dirs[0]), checks=[check]
        )
        assert first.wait(timeout=120) and first.status == "done", first.reason
        h = svc.submit("tight", "d2", lambda: Table.scan_parquet_dataset(dirs[1]), checks=[check])
        assert h.wait(timeout=120)
        assert h.status == "quota"
        assert h.code == DQ_QUOTA
        assert svc.telemetry.value("quota_stops") == 1
    # the stopped run committed the partitions it finished
    committed = list((tmp_path / "states").rglob("*.dqstate"))
    assert committed


def test_service_preempts_heavy_for_interactive_then_resumes(monkeypatch, tmp_path):
    """Preemptive scheduling on one worker: a running heavy run is
    soft-cancelled when interactive work arrives, the interactive check
    runs first, and the heavy run resumes from its committed partition
    states to its solo run's bits."""
    from deequ_tpu_torch.lint import cost as cost_mod

    rng = np.random.default_rng(31_337)
    check = Check(CheckLevel.ERROR, "x").is_complete("x")
    data_dir = tmp_path / "heavy"
    data_dir.mkdir()
    n_parts = 4
    for i in range(n_parts):
        _write_partition(random_table(rng), str(data_dir / f"part-{i}.parquet"))

    def heavy_data():
        return Table.scan_parquet_dataset(str(data_dir))

    solo = suite_snapshot(
        VerificationSuite().on_data(heavy_data()).add_check(check).with_engine("single").run()
    )

    # slow each row-group read so the preemption window is wide
    monkeypatch.setenv("DEEQU_TPU_SOURCE_STALL_MS", "150")
    repo = FileSystemStateRepository(str(tmp_path / "states"))
    with DQService(workers=1, state_repository=repo) as svc:
        # classify the submission as heavy whatever its size
        monkeypatch.setattr(cost_mod, "ADMISSION_INTERACTIVE_BYTES", 0.0)
        monkeypatch.setattr(cost_mod, "ADMISSION_HEAVY_BYTES", 1.0)
        heavy = svc.submit("works", "big", heavy_data, checks=[check])
        assert heavy.tier == "heavy"
        monkeypatch.setattr(cost_mod, "ADMISSION_INTERACTIVE_BYTES", 64 << 20)
        monkeypatch.setattr(cost_mod, "ADMISSION_HEAVY_BYTES", 1 << 30)

        for _ in range(500):
            if heavy.status == "running":
                break
            time.sleep(0.01)
        assert heavy.status == "running"

        monkeypatch.delenv("DEEQU_TPU_SOURCE_STALL_MS")
        inter = svc.submit("ops", "ping", _small_table(), checks=[_basic_check()])
        assert inter.tier == "interactive"
        assert inter.wait(timeout=120) and inter.status == "done"
        assert heavy.wait(timeout=180)
        assert heavy.status == "done", (heavy.status, heavy.reason)
        if heavy.preemptions:
            # the interactive check finished BEFORE the preempted heavy
            # run resumed, and the resume loaded committed partitions
            assert svc.telemetry.value("preempted") >= 1
        assert suite_snapshot(heavy.result) == solo
    committed = list((tmp_path / "states").rglob("*.dqstate"))
    assert committed


def test_service_telemetry_persists_via_engine_repository():
    metrics = InMemoryMetricsRepository()
    with DQService(workers=1, metrics_repository=metrics) as svc:
        h = svc.submit("acme", "orders", _small_table(), checks=[_basic_check()])
        assert h.wait(timeout=60) and h.status == "done"
        svc.publish_telemetry()
    series = engine_series(metrics, "engine.service.completed", instance="service")
    assert series and series[-1].metric_value >= 1.0


def test_service_multi_tenant_fuzz_isolation(tmp_path):
    """N tenants submit at once; every run's result equals the same
    suite's solo run bit for bit: nothing of one tenant leaks into
    another through the shared pool, repository or ledger."""
    rng = np.random.default_rng(9_900)
    tenants = []
    for t in range(4):
        table = port_table(random_table(rng))
        checks = [random_check(rng)]
        builder = VerificationSuite().on_data(table)
        for c in checks:
            builder = builder.add_check(c)
        solo = suite_snapshot(builder.with_engine("single").run())
        tenants.append((f"tenant-{t}", table, checks, solo))

    repo = FileSystemStateRepository(str(tmp_path / "states"))
    with DQService(workers=3, state_repository=repo) as svc:
        handles = []
        for name, table, checks, _ in tenants * 2:  # two rounds each
            handles.append(svc.submit(name, "ds", table, checks=checks))
        _wait_all(handles, timeout=180)
        for h, (name, _, _, solo) in zip(handles, tenants * 2):
            assert h.status == "done", (name, h.status, h.reason)
            assert suite_snapshot(h.result) == solo, name


# ---------------------------------------------------------------------------
# SIGTERM drains the service (tests/test_pipeline_shutdown.py)
# ---------------------------------------------------------------------------


def _threads(prefix: str):
    return [t for t in threading.enumerate() if t.name.startswith(prefix) and t.is_alive()]


def _wait_no_threads(prefix: str, timeout: float = 10.0) -> bool:
    deadline = time.time() + timeout
    while time.time() < deadline:
        if not _threads(prefix):
            return True
        time.sleep(0.02)
    return False


def _open_fd_targets():
    fd_dir = "/proc/self/fd"
    if not os.path.isdir(fd_dir):  # pragma: no cover - not Linux
        return None
    targets = []
    for fd in os.listdir(fd_dir):
        try:
            targets.append(os.readlink(os.path.join(fd_dir, fd)))
        except OSError:
            continue
    return targets


@pytest.fixture
def parquet_path(tmp_path):
    import pyarrow as pa
    import pyarrow.parquet as pq

    path = str(tmp_path / "shutdown.parquet")
    pq.write_table(pa.table({"x": np.arange(200_000, dtype=np.float64)}), path, row_group_size=10_000)
    return path


def test_service_drain_on_sigterm_joins_all_and_closes_all(parquet_path):
    """SIGTERM drains the service through the pipeline's shutdown
    contract: queued work comes back DQ414, the running run either
    commits or is drained at a boundary, EVERY service, pipeline and
    decode thread joins, and no Parquet fd stays open."""
    import signal

    from deequ_tpu_torch.data.source import ParquetSource

    gate = threading.Event()

    def slow_data():
        gate.wait(timeout=30)
        return ParquetSource(parquet_path, batch_rows=10_000)

    svc = DQService(workers=1)
    svc.install_sigterm()
    try:
        check = Check(CheckLevel.ERROR, "drain").has_size(lambda s: s > 0)
        running = svc.submit("t", "d0", slow_data, checks=[check])
        for _ in range(300):
            if running.status == "running":
                break
            time.sleep(0.01)
        queued = svc.submit("t", "d1", slow_data, checks=[check])
        gate.set()

        # a real SIGTERM to this process; the handler runs svc.drain() in
        # the main thread
        os.kill(os.getpid(), signal.SIGTERM)

        assert queued.done()
        assert queued.status == "drained" and queued.code == DQ_DRAINED
        assert running.done()
        # the run in flight finished before the soft cancel reached a
        # boundary, or was drained at one: never killed half-way
        assert running.status in ("done", "drained")
    finally:
        svc.uninstall_sigterm()
        gate.set()
        svc.close()

    assert _wait_no_threads("deequ-dq-service"), "service threads leaked"
    assert _wait_no_threads("deequ-pipe"), "pipeline threads leaked"
    assert _wait_no_threads("deequ-decode"), "decode threads leaked"
    targets = _open_fd_targets()
    if targets is not None:
        assert parquet_path not in targets, "parquet fd leaked past drain"

    # after the drain, submissions are turned away with the drain code
    late = svc.submit("t", "d2", slow_data, checks=[])
    assert late.done() and late.code == DQ_DRAINED


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("value", [None, "", "0", "5", "-2", "2.5", "x", "off"])
def test_service_knobs_equal_jax(value, monkeypatch):
    from deequ_tpu.ops import runtime as jruntime
    from deequ_tpu_torch.ops import runtime

    knobs = ("DEEQU_TPU_SCAN_SHARING", "DEEQU_TPU_SHARE_GROUP_MAX",
             "DEEQU_TPU_SERVICE_WORKERS", "DEEQU_TPU_SERVICE_DRAIN_S")
    for knob in knobs:
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
    for name in ("scan_sharing_enabled", "share_group_max", "service_workers", "service_drain_s"):
        got, want = getattr(runtime, name)(), getattr(jruntime, name)()
        assert (type(got), got) == (type(want), want), (name, value)


def _jax_small_table():
    from deequ_tpu.data.table import Table as JTable

    return JTable.from_pydict({"item": ["1", "2", "3", "4"], "att1": ["a", "a", "a", "b"]})


def _jax_basic_check():
    from deequ_tpu import Check as JCheck, CheckLevel as JLevel

    return JCheck(JLevel.ERROR, "basic").is_complete("item")


@pytest.mark.parametrize(
    "quota, pending, usage",
    [
        ({}, 0, None),
        ({"scan_bytes_per_window": 1.0, "window_s": 60.0}, 0, None),
        ({"scan_bytes_per_window": float(1 << 20)}, 0, None),
        ({"max_pending": 2}, 2, None),
        ({"state_disk_bytes": 100}, 0, 101),
        ({"state_disk_bytes": 100}, 0, 99),
    ],
    ids=["default", "never-admittable", "headroom", "max-pending", "disk-over", "disk-under"],
)
def test_admission_equals_jax(quota, pending, usage, monkeypatch):
    """The same schema, quota and plan give the same admission, tier,
    code and quota headroom in both packages, under the tier thresholds
    at their defaults and moved around the plan's prediction."""
    from deequ_tpu.service import (
        BreakerBoard as JBoard,
        QuotaLedger as JLedger,
        TenantQuota as JQuota,
    )
    from deequ_tpu.service.admission import AdmissionController as JAdmission

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    for thresholds in (None, ("0", "1e18"), ("0", "1")):
        if thresholds is None:
            monkeypatch.delenv("DEEQU_TPU_TIER_INTERACTIVE_BYTES", raising=False)
            monkeypatch.delenv("DEEQU_TPU_TIER_HEAVY_BYTES", raising=False)
        else:
            monkeypatch.setenv("DEEQU_TPU_TIER_INTERACTIVE_BYTES", thresholds[0])
            monkeypatch.setenv("DEEQU_TPU_TIER_HEAVY_BYTES", thresholds[1])
        want = JAdmission(JLedger({"acme": JQuota(**quota)}), JBoard()).evaluate(
            "acme", "orders", _jax_small_table(), [_jax_basic_check()], [],
            pending_count=pending, state_disk_usage=usage,
        )
        got = AdmissionController(QuotaLedger({"acme": TenantQuota(**quota)}), BreakerBoard()).evaluate(
            "acme", "orders", _small_table(), [_basic_check()], [],
            pending_count=pending, state_disk_usage=usage,
        )
        label = (quota, thresholds)
        assert (got.admitted, got.tier, got.code) == (want.admitted, want.tier, want.code), label
        assert got.reason.split(":")[0] == want.reason.split(":")[0], label
        assert (got.cost is None) == (want.cost is None), label
        if want.cost is not None:
            assert got.cost.predicted_scan_bytes == want.cost.predicted_scan_bytes, label
            assert got.cost.quota_headroom_bytes == want.cost.quota_headroom_bytes, label
            assert got.cost.admission_tier == want.cost.admission_tier, label


# one event sequence over three tenants and pairs: (time step, event, args)
_EVENTS = [
    (0.0, "charge", ("a", 40.0)), (1.0, "charge", ("a", 70.0)), (0.5, "charge", ("b", 5.0)),
    (0.0, "fail", ("a", "d")), (0.0, "fail", ("a", "d")), (2.0, "allow", ("a", "d")),
    (0.0, "fail", ("a", "d")), (0.0, "allow", ("a", "d")), (0.0, "open_now", ("a", "d")),
    (9.0, "charge", ("a", 1.0)), (3.0, "allow", ("a", "d")), (0.0, "allow", ("a", "d")),
    (0.0, "neutral", ("a", "d")), (0.0, "allow", ("a", "d")), (0.0, "fail", ("a", "d")),
    (0.0, "fail", ("b", "e")), (0.0, "success", ("b", "e")), (12.0, "allow", ("a", "d")),
    (0.0, "success", ("a", "d")), (0.0, "charge", ("c", 500.0)), (61.0, "charge", ("c", 1.0)),
]


def _replay(ledger_cls, quota_cls, board_cls):
    clock = FakeClock()
    ledger = ledger_cls(
        {"a": quota_cls(scan_bytes_per_window=100.0, window_s=10.0),
         "c": quota_cls(scan_bytes_per_window=200.0)},
        clock=clock,
    )
    board = board_cls(threshold=3, cooldown_s=10.0, clock=clock)
    answers = []
    for dt, event, args in _EVENTS:
        clock.advance(dt)
        if event == "charge":
            ledger.charge_scan(*args)
        elif event == "fail":
            board.record_failure(*args)
        elif event == "success":
            board.record_success(*args)
        elif event == "neutral":
            board.record_neutral(*args)
        else:
            answers.append(getattr(board, event)(*args))
        tenant = args[0]
        answers.append((ledger.bytes_in_window(tenant), ledger.scan_headroom(tenant),
                        ledger.over_scan_budget(tenant), ledger.bytes_total(tenant)))
    states = {pair: board.state(*pair) for pair in board.pairs()}
    return answers, states, board.open_count(), board.transitions(), ledger.tenants()


def test_ledger_and_breakers_equal_jax():
    from deequ_tpu.service import (
        BreakerBoard as JBoard,
        QuotaLedger as JLedger,
        TenantQuota as JQuota,
    )

    assert _replay(QuotaLedger, TenantQuota, BreakerBoard) == _replay(JLedger, JQuota, JBoard)
