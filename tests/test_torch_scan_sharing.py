"""Scan sharing on the port (deequ_tpu_torch/service/sharing.py and the
DQService's group scheduler): one proven superset scan per table, fanned
out to every participating tenant with its solo run's bits.

Port-mapped from tests/test_scan_sharing.py, every run on the CPU
(tests/torch_cpu.py), and the three seeds of
tests/test_suite_differential_fuzz.py's
`test_scan_sharing_shared_vs_solo_bit_identical`. The invariants:

* fan-out exactness: every participant's metrics, check statuses and
  forensics samples equal its solo run's;
* pinned proofs: each participant carries a CONTAINED subsumption proof
  whose drift after the run is zero;
* isolation: pro-rata quota charges (one scan's bytes split among the
  group), forensics reservoirs per tenant, and the per-tenant cache
  entries the shared scan warms, signed for the service's device;
* consistency under scheduling: a preempted shared scan re-queues EVERY
  participant; a member the prover declines runs solo.

The cases at the end hold the port to the JAX package: the union plan of
random plans, and a shared round over the same three Parquet partitions
(each tenant's metrics, statuses, proof verdicts and pro-rata charges).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import time

import numpy as np
import pytest

import test_suite_differential_fuzz as fuzz
from deequ_tpu_torch import Check, CheckLevel, VerificationSuite
from deequ_tpu_torch.core.controller import DQ_QUOTA
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.repository.states import FileSystemStateRepository
from deequ_tpu_torch.service import DQService, TenantQuota
from deequ_tpu_torch.service import sharing
from torch_stream_helpers import assert_metric_equal, plain_route, port_random_check

pytestmark = pytest.mark.usefixtures("cpu_default")

suite_snapshot = fuzz.suite_snapshot


# ---------------------------------------------------------------------------
# fixtures and helpers
# ---------------------------------------------------------------------------


def _make_dataset(tmp_path, seed=7, parts=3):
    data_dir = tmp_path / "ds"
    data_dir.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(parts):
        fuzz._write_partition(fuzz.random_table(rng), str(data_dir / f"p{i}.parquet"))
    return data_dir


def _factory(data_dir):
    return lambda: Table.scan_parquet_dataset(str(data_dir))


def _tenant_checks():
    return {
        "t1": Check(CheckLevel.ERROR, "c1").is_complete("x").has_mean("x", lambda m: True),
        "t2": Check(CheckLevel.ERROR, "c2").is_complete("s").has_mean("x", lambda m: True),
        "t3": Check(CheckLevel.ERROR, "c3")
        .has_size(lambda v: v > 0)
        .has_standard_deviation("x", lambda s: True),
    }


def _solo_snapshots(factory, checks):
    out = {}
    for tenant, check in checks.items():
        result = VerificationSuite().on_data(factory()).add_check(check).with_engine("single").run()
        out[tenant] = suite_snapshot(result)
    return out


def _blocker():
    """A submission over ANOTHER dataset (in memory, unshareable) whose
    slow assertion holds the one worker while the group queues behind."""
    table = Table.from_pydict({"k": ["a", "b", "c"]})
    check = Check(CheckLevel.ERROR, "blocker").has_size(lambda v: (time.sleep(0.8) or v >= 0))
    return (lambda: table), check


def _submit_group(svc, factory, checks):
    bdata, bcheck = _blocker()
    blocker = svc.submit("blocker", "other", bdata, checks=[bcheck])
    time.sleep(0.25)
    handles = {
        tenant: svc.submit(tenant, "ds", factory, checks=[check]) for tenant, check in checks.items()
    }
    return blocker, handles


def _await_done(handles, timeout=60):
    for tenant, handle in handles.items():
        assert handle.wait(timeout), (tenant, handle.status)


# ---------------------------------------------------------------------------
# fan-out exactness and pinned proofs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("placement", ["host", "device"])
def test_shared_scan_bit_identical_to_solo_with_pinned_proofs(placement, monkeypatch, tmp_path):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    data_dir = _make_dataset(tmp_path)
    factory = _factory(data_dir)
    checks = _tenant_checks()
    solo = _solo_snapshots(factory, checks)

    with DQService(workers=1) as svc:
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        assert svc.telemetry.value("shared_scans") >= 1
        shared = [t for t, h in handles.items() if h.sharing and h.sharing["shared"]]
        assert len(shared) >= 2, "group never formed"
        for tenant, handle in handles.items():
            assert handle.status == "done", (tenant, handle.reason, handle.error)
            assert suite_snapshot(handle.result) == solo[tenant], tenant
        for tenant in shared:
            info = handles[tenant].sharing
            assert info["proof"]["verdict"] == "CONTAINED"
            assert info["participants"] == len(shared)
            assert all(v == 0 for v in info["drift"].values()), (tenant, info)


def test_kill_switch_disables_grouping_but_not_results(monkeypatch, tmp_path):
    monkeypatch.setenv("DEEQU_TPU_SCAN_SHARING", "0")
    data_dir = _make_dataset(tmp_path)
    factory = _factory(data_dir)
    checks = _tenant_checks()
    solo = _solo_snapshots(factory, checks)

    with DQService(workers=1) as svc:
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        assert svc.telemetry.value("shared_scans") == 0
        for tenant, handle in handles.items():
            assert handle.status == "done"
            assert handle.sharing is None
            assert suite_snapshot(handle.result) == solo[tenant], tenant


def test_share_group_max_caps_participation(monkeypatch, tmp_path):
    monkeypatch.setenv("DEEQU_TPU_SHARE_GROUP_MAX", "2")
    data_dir = _make_dataset(tmp_path)
    factory = _factory(data_dir)
    checks = _tenant_checks()
    solo = _solo_snapshots(factory, checks)

    with DQService(workers=1) as svc:
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        for tenant, handle in handles.items():
            assert handle.status == "done"
            assert suite_snapshot(handle.result) == solo[tenant], tenant
            if handle.sharing and handle.sharing["shared"]:
                assert handle.sharing["participants"] <= 2


# ---------------------------------------------------------------------------
# pro-rata quota accounting
# ---------------------------------------------------------------------------


def test_prorata_weights_sum_to_one_scan():
    union, shares = sharing.prorata_weights([300.0, 100.0, 100.0])
    assert union == 300.0
    assert shares == pytest.approx([180.0, 60.0, 60.0])
    assert sum(shares) == pytest.approx(union)
    assert sharing.prorata_weights([]) == (0.0, [])
    assert sharing.prorata_weights([0.0, 0.0]) == (0.0, [0.0, 0.0])


def test_shared_scan_charges_one_scan_pro_rata(monkeypatch, tmp_path):
    data_dir = _make_dataset(tmp_path)
    factory = _factory(data_dir)
    checks = _tenant_checks()

    # what each tenant pays when it scans alone
    solo_charge = {}
    for tenant, check in checks.items():
        with DQService(workers=1) as ref:
            handle = ref.submit(tenant, "ds", factory, checks=[check])
            assert handle.wait(60) and handle.status == "done"
            solo_charge[tenant] = ref.ledger.bytes_total(tenant)
    assert all(b > 0 for b in solo_charge.values()), solo_charge

    with DQService(workers=1) as svc:
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        shared = [t for t, h in handles.items() if h.sharing and h.sharing["shared"]]
        assert len(shared) >= 2
        per_tenant = {t: svc.ledger.bytes_total(t) for t in shared}
        assert all(b > 0 for b in per_tenant.values()), per_tenant
        # together the group paid for ONE union scan, the WIDEST
        # participant's solo bill split pro rata, not K scans
        total = sum(per_tenant.values())
        solo_shared = [solo_charge[t] for t in shared]
        assert total == pytest.approx(max(solo_shared), rel=0.05), (per_tenant, solo_charge)
        assert total < 0.8 * sum(solo_shared)
        # and no participant pays more shared than alone
        for tenant in shared:
            assert per_tenant[tenant] <= solo_charge[tenant] * 1.05, tenant


def test_overdrawn_tenant_dropped_at_fanout_scan_continues(monkeypatch, tmp_path):
    data_dir = _make_dataset(tmp_path)
    factory = _factory(data_dir)
    checks = _tenant_checks()
    solo = _solo_snapshots(factory, checks)
    window = 50 * 1024 * 1024

    quotas = {"t1": TenantQuota(scan_bytes_per_window=float(window), window_s=3600.0)}
    with DQService(workers=1, quotas=quotas) as svc:
        # t1's window is blown before its run starts; admission still
        # admits (the plan itself fits the window) but the shared scan's
        # boundary probe marks it overdrawn and drops it at the fan-out,
        # while its co-tenants' scan completes untouched
        svc.ledger.charge_scan("t1", float(window) + 1.0)
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        assert handles["t1"].status == "quota", handles["t1"].reason
        assert handles["t1"].code == DQ_QUOTA
        for tenant in ("t2", "t3"):
            assert handles[tenant].status == "done", handles[tenant].reason
            assert suite_snapshot(handles[tenant].result) == solo[tenant]


# ---------------------------------------------------------------------------
# consistency under preemption: never a partial fan-out
# ---------------------------------------------------------------------------


def test_preempted_shared_scan_requeues_every_participant(monkeypatch, tmp_path):
    data_dir = _make_dataset(tmp_path, parts=4)
    factory = _factory(data_dir)
    checks = _tenant_checks()
    solo = _solo_snapshots(factory, checks)

    fired = {"n": 0}
    real_probe = DQService._shared_boundary_probe

    def preempting_probe(self, subs, overdrawn):
        inner = real_probe(self, subs, overdrawn)

        def probe(progress):
            if fired["n"] == 0 and int(progress.get("partitions_done", 0)) >= 1:
                fired["n"] += 1
                return "preempted"
            return inner(progress)

        return probe

    monkeypatch.setattr(DQService, "_shared_boundary_probe", preempting_probe)

    repo = FileSystemStateRepository(str(tmp_path / "cache"))
    with DQService(workers=1, state_repository=repo) as svc:
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        assert fired["n"] == 1, "shared scan was never preempted"
        shared = [t for t, h in handles.items() if h.sharing and h.sharing["shared"]]
        assert len(shared) >= 2
        # EVERY participant was re-queued (attempts > 1) and completed
        # with its solo bits: the committed partition states made the
        # retry incremental, never a partial fan-out
        for tenant, handle in handles.items():
            assert handle.status == "done", (tenant, handle.reason)
            assert handle.preemptions == 1, tenant
            assert handle.attempts >= 2, tenant
            assert suite_snapshot(handle.result) == solo[tenant], tenant


def test_declined_member_falls_back_to_solo_run(monkeypatch, tmp_path):
    data_dir = _make_dataset(tmp_path)
    factory = _factory(data_dir)
    checks = _tenant_checks()
    solo = _solo_snapshots(factory, checks)

    real = sharing.plan_share_group

    def declining(plans, table, device=None):
        union, proofs, declines = real(plans, table, device=device)
        if len(plans) > 1:
            declines = list(declines)
            declines[-1] = "forced decline (test)"
        return union, proofs, declines

    monkeypatch.setattr(sharing, "plan_share_group", declining)

    with DQService(workers=1) as svc:
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        assert svc.telemetry.value("sharing_declined") >= 1
        declined = [t for t, h in handles.items() if h.sharing and not h.sharing["shared"]]
        assert declined, "no member was declined"
        for tenant, handle in handles.items():
            assert handle.status == "done", (tenant, handle.reason)
            assert suite_snapshot(handle.result) == solo[tenant], tenant
        for tenant in declined:
            assert handles[tenant].sharing["reason"] == "forced decline (test)"


# ---------------------------------------------------------------------------
# state fan-out per tenant: the shared scan warms every solo cache
# ---------------------------------------------------------------------------


def test_shared_scan_warms_each_tenants_solo_cache(monkeypatch, tmp_path):
    monkeypatch.setenv("DEEQU_TPU_STATE_CACHE", "1")
    data_dir = _make_dataset(tmp_path)
    factory = _factory(data_dir)
    checks = _tenant_checks()
    solo = _solo_snapshots(factory, checks)
    repo = FileSystemStateRepository(str(tmp_path / "cache"))

    with DQService(workers=1, state_repository=repo) as svc:
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        shared = [t for t, h in handles.items() if h.sharing and h.sharing["shared"]]
        assert len(shared) >= 2

    table = factory()
    fingerprints = [p.fingerprint for p in table.partitions()]
    for tenant in shared:
        # signed as the tenant's solo run signs: its analyzers in the solo
        # run's order (the JAX case takes `submission_plan`'s constraint
        # order, which the solo run's signature need not share)
        plan = sharing._solo_order([checks[tenant]], [])
        tsp = sharing.TenantStatePlan(f"{tenant}/ds", plan, table)
        assert tsp.analyzers, tenant
        for fp in fingerprints:
            assert repo.has_states(f"{tenant}/ds", fp, tsp.signature), (tenant, fp)
        # an all-warm solo run loads every partition off the fanned-out
        # entries, scans none, and stays exact
        result = (
            VerificationSuite()
            .on_data(factory())
            .add_check(checks[tenant])
            .with_engine("single")
            .with_state_repository(repo, f"{tenant}/ds")
            .with_tracing(True)
            .run()
        )
        assert result.run_trace.counters.get("partitions_scanned", 0) == 0, tenant
        assert suite_snapshot(result) == solo[tenant], tenant


def _set_order_differs(build):
    """A check from `build(reverse)` whose `required_analyzers()` set
    iterates in another order than its constraints: the constraint order
    is flipped when this process's string hashes happen to keep it."""
    check = build(False)
    if list(check.required_analyzers()) == sharing.submission_plan([check], []):
        check = build(True)
    assert list(check.required_analyzers()) != sharing.submission_plan([check], [])
    return check


def test_fanout_signs_as_the_solo_run_whatever_the_set_order(tmp_path):
    """The fan-out signs each tenant's entries over the analyzers in its
    solo run's order, which follows the check's `required_analyzers()`
    set, not its constraint order (`submission_plan`): with the two
    orders made to differ, a solo rerun over the shared scan's repository
    still loads every partition and scans none."""

    def build(description, reverse):
        steps = [lambda c: c.is_complete("x"), lambda c: c.has_mean("x", lambda m: True),
                 lambda c: c.has_max("y", lambda m: True)]
        check = Check(CheckLevel.ERROR, description)
        for step in reversed(steps) if reverse else steps:
            check = step(check)
        return check

    checks = {
        "t1": _set_order_differs(lambda reverse: build("o1", reverse)),
        "t2": Check(CheckLevel.ERROR, "o2").has_size(lambda n: n > 0).has_mean("x", lambda m: True),
    }
    data_dir = _make_dataset(tmp_path)
    factory = _factory(data_dir)
    repo = FileSystemStateRepository(str(tmp_path / "cache"))
    with DQService(workers=1, state_repository=repo) as svc:
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        assert all(h.sharing and h.sharing["shared"] for h in handles.values())
    for tenant, check in checks.items():
        result = (
            VerificationSuite().on_data(factory()).add_check(check).with_engine("single")
            .with_state_repository(repo, f"{tenant}/ds").with_tracing(True).run()
        )
        counters = result.run_trace.counters
        assert (counters.get("partitions_cached", 0), counters.get("partitions_scanned", 0)) == (3, 0), tenant
        assert suite_snapshot(result) == suite_snapshot(handles[tenant].result), tenant


def test_fanout_repository_assembles_union_from_tenant_entries(tmp_path):
    """Loads fall back to the tenants' solo entries, so a group formed
    again resumes the partitions an earlier (other) group committed."""

    class DictRepo:
        def __init__(self):
            self.store = {}

        def has_states(self, dataset, fingerprint, signature):
            return (dataset, fingerprint, signature) in self.store

        def load_states(self, dataset, fingerprint, signature, analyzers):
            entry = self.store.get((dataset, fingerprint, signature))
            if entry is None:
                return None
            try:
                return [entry[a] for a in analyzers]
            except KeyError:
                return None

        def save_states(self, dataset, fingerprint, signature, pairs):
            self.store[(dataset, fingerprint, signature)] = dict(pairs)
            return True

        def disk_usage(self, dataset):
            return 0

    from deequ_tpu_torch.analyzers import Completeness, Mean

    table = Table.from_pydict({"x": [1.0, 2.0], "s": ["a", None]})
    a1, a2 = Completeness("x"), Mean("x")
    t1 = sharing.TenantStatePlan("t1/ds", [a1], table)
    t2 = sharing.TenantStatePlan("t2/ds", [a1, a2], table)
    inner = DictRepo()
    fan = sharing.FanoutStateRepository(inner, [t1, t2])

    saved = fan.save_states("shared/x", "fp0", "sig-union", [(a1, "s1"), (a2, "s2")])
    assert saved
    # every tenant's solo entry exists under its own dataset and signature
    assert inner.has_states("t1/ds", "fp0", t1.signature)
    assert inner.has_states("t2/ds", "fp0", t2.signature)
    assert inner.load_states("t1/ds", "fp0", t1.signature, [a1]) == ["s1"]

    # the shared entry gone, the union still assembles from the tenants
    del inner.store[("shared/x", "fp0", "sig-union")]
    assert fan.has_states("shared/x", "fp0", "sig-union")
    assert fan.load_states("shared/x", "fp0", "sig-union", [a1, a2]) == ["s1", "s2"]
    # a union member no tenant saved is a miss, not a partial load
    a3 = Completeness("s")
    assert fan.load_states("shared/x", "fp0", "sig-union", [a1, a3]) is None


# ---------------------------------------------------------------------------
# forensics isolation per tenant
# ---------------------------------------------------------------------------


def test_forensics_reservoirs_isolated_and_identical_to_solo(monkeypatch, tmp_path):
    monkeypatch.setenv("DEEQU_TPU_FORENSICS", "1")
    data_dir = _make_dataset(tmp_path)
    factory = _factory(data_dir)
    checks = {
        "t1": Check(CheckLevel.ERROR, "f1").is_complete("x"),
        "t2": Check(CheckLevel.ERROR, "f2").is_complete("s").is_complete("x"),
    }

    def solo_forensics(tenant):
        result = VerificationSuite().on_data(factory()).add_check(checks[tenant]).with_engine("single").run()
        assert result.forensics_report is not None
        return [c.to_dict() for c in result.forensics_report.constraints]

    solo = {t: solo_forensics(t) for t in checks}
    solo_snap = _solo_snapshots(factory, checks)

    with DQService(workers=1) as svc:
        blocker, handles = _submit_group(svc, factory, checks)
        _await_done({**handles, "blocker": blocker})
        shared = [t for t, h in handles.items() if h.sharing and h.sharing["shared"]]
        assert sorted(shared) == ["t1", "t2"]
        for tenant, handle in handles.items():
            assert suite_snapshot(handle.result) == solo_snap[tenant]
            report = handle.result.forensics_report
            assert report is not None, tenant
            # reservoirs are seeded from the violating rows' content, so
            # each tenant's shared samples equal its solo ones and hold
            # only its own constraints
            assert [c.to_dict() for c in report.constraints] == solo[tenant], tenant


# ---------------------------------------------------------------------------
# the grouping key
# ---------------------------------------------------------------------------


def test_dataset_fingerprint_rules(tmp_path):
    data_dir = _make_dataset(tmp_path)
    t1 = Table.scan_parquet_dataset(str(data_dir))
    t2 = Table.scan_parquet_dataset(str(data_dir))
    f1 = sharing.dataset_fingerprint(lambda: t1, t1)
    f2 = sharing.dataset_fingerprint(lambda: t2, t2)
    assert f1 is not None and f1 == f2, "identity by content must survive reopening"

    mem = Table.from_pydict({"x": [1.0]})
    direct = sharing.dataset_fingerprint(mem, mem)
    assert direct == f"obj:{id(mem)}"
    # an in-memory table a factory opened has no stable identity
    assert sharing.dataset_fingerprint(lambda: mem, mem) is None


# ---------------------------------------------------------------------------
# shared against solo over random suites (tests/test_suite_differential_fuzz.py)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_scan_sharing_shared_vs_solo_bit_identical(seed, monkeypatch, tmp_path):
    """Random overlapping suites submitted over one table land on their
    solo runs' bits, sketches included, whether the scheduler shared
    their scan or not, on BOTH placements; every shared participant
    carries a CONTAINED proof pinned with zero drift."""
    rng = np.random.default_rng(41_000 + seed)
    data_dir = tmp_path / "dataset"
    data_dir.mkdir()
    for i in range(3):
        fuzz._write_partition(fuzz.random_table(rng), str(data_dir / f"part-{i}.parquet"))

    def factory():
        return Table.scan_parquet_dataset(str(data_dir))

    n_tenants = int(rng.integers(2, 5))
    random_check = port_random_check(fuzz)
    checks = {f"tenant{i}": random_check(rng) for i in range(n_tenants)}

    for placement in ("host", "device"):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
        solo = {}
        for tenant, check in checks.items():
            builder = VerificationSuite().on_data(factory()).add_check(check)
            solo[tenant] = suite_snapshot(builder.with_engine("single").run())

        blocker_table = Table.from_pydict({"k": ["a"]})
        blocker_check = Check(CheckLevel.ERROR, "blocker").has_size(
            lambda v: (time.sleep(0.8) or v >= 0)
        )
        with DQService(workers=1) as svc:
            blocker = svc.submit("blocker", "other", lambda: blocker_table, checks=[blocker_check])
            time.sleep(0.25)
            handles = {
                tenant: svc.submit(tenant, "ds", factory, checks=[check])
                for tenant, check in checks.items()
            }
            assert blocker.wait(120)
            for tenant, handle in handles.items():
                assert handle.wait(120), (placement, tenant)
                assert handle.status == "done", (placement, tenant, handle.reason, handle.error)
                assert suite_snapshot(handle.result) == solo[tenant], (placement, tenant)
                if handle.sharing is not None and handle.sharing["shared"]:
                    assert handle.sharing["proof"]["verdict"] == "CONTAINED"
                    assert all(v == 0 for v in handle.sharing["drift"].values()), (
                        placement, tenant, handle.sharing["drift"],
                    )
            shared_n = sum(1 for h in handles.values() if h.sharing is not None and h.sharing["shared"])
            assert shared_n >= 2, f"group never formed on {placement}"


# ---------------------------------------------------------------------------
# held against the JAX package
# ---------------------------------------------------------------------------


def _analyzer_pool(module):
    """The same analyzers built from either package's classes."""
    return [
        module.Size(), module.Completeness("x"), module.Completeness("s"), module.Mean("x"),
        module.Mean("x", where="y > 0"), module.Mean("x", where="y>0"), module.Minimum("y"),
        module.Maximum("x"), module.Sum("r"), module.StandardDeviation("x"),
        module.ApproxCountDistinct("s"), module.Correlation("x", "y"),
        module.ApproxQuantile("x", 0.5), module.Compliance("pos", "x > 0"),
    ]


@pytest.mark.parametrize("seed", range(5))
def test_union_plan_equals_jax(seed):
    import deequ_tpu.analyzers as jax_analyzers
    from deequ_tpu.ops.fused import build_union_plan as jax_build_union_plan

    import deequ_tpu_torch.analyzers as port_analyzers
    from deequ_tpu_torch.ops.fused import build_union_plan

    jpool, ppool = _analyzer_pool(jax_analyzers), _analyzer_pool(port_analyzers)
    assert [repr(a) for a in jpool] == [repr(a) for a in ppool]
    rng = np.random.default_rng(seed)
    picks = [
        list(rng.integers(0, len(jpool), int(rng.integers(0, 9))))
        for _ in range(int(rng.integers(1, 6)))
    ]
    junion, jmembers = jax_build_union_plan([[jpool[i] for i in p] for p in picks])
    punion, pmembers = build_union_plan([[ppool[i] for i in p] for p in picks])
    assert [repr(a) for a in punion] == [repr(a) for a in junion]
    assert pmembers == jmembers


def _jax_tenant_checks():
    from deequ_tpu import Check as JCheck, CheckLevel as JLevel

    return _diff_checks(JCheck, JLevel)


def _diff_checks(check_cls, level):
    """Three tenants whose suites reach the moments, the HLL registers,
    a quantile and a predicate, overlapping on Mean("x")."""
    return {
        "billing": check_cls(level.ERROR, "billing").has_size(lambda n: n > 0)
        .is_complete("x").has_mean("x", lambda m: m > 0).has_standard_deviation("x", lambda s: s > 0),
        "growth": check_cls(level.ERROR, "growth").has_approx_count_distinct("s", lambda v: v > 1)
        .has_mean("x", lambda m: m > 0),
        "latency": check_cls(level.ERROR, "latency").has_approx_quantile("x", 0.5, lambda q: q > 0)
        .has_min("y", lambda v: v < 0).has_max("x", lambda v: v > 0)
        .satisfies("x > 0 OR x IS NULL", "x positive", lambda r: r > 0.5),
    }


def _shared_round(service_cls, factory, checks, blocker_table, blocker_check):
    with service_cls(workers=1) as svc:
        blocker = svc.submit("blocker", "other", lambda: blocker_table, checks=[blocker_check])
        time.sleep(0.25)
        handles = {t: svc.submit(t, "ds", factory, checks=[c]) for t, c in checks.items()}
        assert blocker.wait(120)
        for tenant, handle in handles.items():
            assert handle.wait(120) and handle.status == "done", (tenant, handle.reason, handle.error)
            assert handle.sharing and handle.sharing["shared"], (tenant, handle.sharing)
        charges = {t: svc.ledger.bytes_total(t) for t in checks}
        return handles, charges, svc.telemetry.value("shared_scans")


def test_shared_round_equals_jax(monkeypatch, tmp_path):
    """The same three Parquet partitions and tenant suites through the
    JAX DQService and the port's: every tenant's metrics (counts,
    extremes, registers, quantiles and statuses exactly, float sums
    within 1e-12), its proof's verdict and its pro-rata charge agree."""
    from deequ_tpu import Check as JCheck, CheckLevel as JLevel
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.service import DQService as JService

    plain_route(monkeypatch)
    data_dir = _make_dataset(tmp_path, seed=1_717)

    def blocker(table_cls, check_cls, level):
        return table_cls.from_pydict({"k": ["a"]}), check_cls(level.ERROR, "blocker").has_size(
            lambda v: (time.sleep(0.8) or v >= 0)
        )

    jhandles, jcharges, jscans = _shared_round(
        JService, lambda: JTable.scan_parquet_dataset(str(data_dir)), _jax_tenant_checks(),
        *blocker(JTable, JCheck, JLevel),
    )
    phandles, pcharges, pscans = _shared_round(
        DQService, _factory(data_dir), _diff_checks(Check, CheckLevel),
        *blocker(Table, Check, CheckLevel),
    )
    assert pscans == jscans == 1
    assert pcharges == jcharges
    for tenant, jh in jhandles.items():
        ph = phandles[tenant]
        assert ph.sharing["proof"]["verdict"] == jh.sharing["proof"]["verdict"] == "CONTAINED"
        assert ph.sharing["participants"] == jh.sharing["participants"] == 3
        assert ph.sharing["drift"] == jh.sharing["drift"]
        jsnap, psnap = suite_snapshot(jh.result), suite_snapshot(ph.result)
        assert psnap[:2] == jsnap[:2], tenant  # overall and per-constraint statuses
        jmetrics = {repr(a): m for a, m in jh.result.metrics.items()}
        pmetrics = {repr(a): m for a, m in ph.result.metrics.items()}
        assert sorted(pmetrics) == sorted(jmetrics), tenant
        for key, jm in jmetrics.items():
            assert_metric_equal(jm, pmetrics[key], key)
