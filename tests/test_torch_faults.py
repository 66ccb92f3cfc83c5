"""Chaos harness + run control: fault spec parsing, schedule
determinism, retry/backoff, RunController cancel/deadline semantics,
StallWatchdog dump-then-cancel, suite-level cancel-then-resume through
the state repository, and the DQ318/EXPLAIN resilience surface.

Port-mapped from tests/test_faults.py: the same cases against
deequ_tpu_torch, every run on the CPU (tests/torch_cpu.py). The cases at
the end hold the port's harness to the JAX package's: the same registry,
the same schedule for the same spec, the same backoff bits, and every
`fault_point` literal in the port registered (the FAULTS rule of the
JAX package's repo lint, tools/lint.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import io
import struct
import time

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import Completeness, Mean, Size, StandardDeviation
from deequ_tpu_torch.core.controller import (
    DQ_CANCELLED,
    DQ_DEADLINE,
    DQ_STALLED,
    RunCancelled,
    RunController,
    StallWatchdog,
    backoff_s,
    retry_call,
)
from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.repository.states import InMemoryStateRepository
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from deequ_tpu_torch.testing import faults
from deequ_tpu_torch.testing.faults import (
    FaultPlan,
    FaultSpecError,
    InjectedFaultError,
    parse_spec,
)


pytestmark = pytest.mark.usefixtures("cpu_default")


def _bits(x: float) -> bytes:
    return struct.pack(">d", float(x))


def _random_table(rng: np.random.Generator, n: int = 400) -> Table:
    x = rng.normal(0.0, 10.0, n)
    x[rng.random(n) < 0.1] = np.nan
    return Table.from_pydict(
        {"x": list(x), "g": [int(v) for v in rng.integers(0, 20, n)]},
        types={"x": ColumnType.DOUBLE, "g": ColumnType.LONG},
    )


# ---------------------------------------------------------------------------
# spec parsing
# ---------------------------------------------------------------------------


class TestSpecParsing:
    def test_full_grammar(self):
        plan = parse_spec("seed=7,stall=0.5,read.pread:0.25:3,decode.chunk:1.0")
        assert plan.seed == 7
        assert plan.stall_s == 0.5
        assert plan.specs["read.pread"] == (0.25, 3)
        assert plan.specs["decode.chunk"] == (1.0, None)

    def test_empty_tokens_and_whitespace(self):
        plan = parse_spec(" seed=1 , , read.short:0.5:2 ")
        assert plan.seed == 1
        assert plan.specs == {"read.short": (0.5, 2)}

    @pytest.mark.parametrize(
        "spec",
        [
            "read.pread",            # no rate
            "read.pread:x",          # non-numeric rate
            "read.pread:0.5:1:9",    # too many fields
            "read.pread:1.5",        # rate out of [0,1]
            "no.such.point:0.5",     # unregistered point
        ],
    )
    def test_bad_specs_raise(self, spec):
        with pytest.raises(FaultSpecError):
            parse_spec(spec)

    def test_every_registered_point_parses(self):
        for point in sorted(faults.FAULT_POINTS):
            plan = parse_spec(f"{point}:1.0:1")
            assert point in plan.specs


# ---------------------------------------------------------------------------
# schedule determinism + budgets
# ---------------------------------------------------------------------------


class TestSchedule:
    def _schedule(self, plan: FaultPlan, point: str, n: int):
        out = []
        for _ in range(n):
            try:
                out.append(plan.decide(point))
            except InjectedFaultError:
                out.append("RAISE")
        return out

    def test_same_seed_same_schedule(self):
        a = parse_spec("seed=11,read.short:0.3")
        b = parse_spec("seed=11,read.short:0.3")
        assert self._schedule(a, "read.short", 200) == self._schedule(
            b, "read.short", 200
        )

    def test_different_seed_different_schedule(self):
        a = parse_spec("seed=11,read.short:0.3")
        b = parse_spec("seed=12,read.short:0.3")
        assert self._schedule(a, "read.short", 200) != self._schedule(
            b, "read.short", 200
        )

    def test_budget_caps_injections(self):
        plan = parse_spec("seed=3,read.pread:1.0:4")
        sched = self._schedule(plan, "read.pread", 50)
        assert sched.count("RAISE") == 4
        assert plan.injected["read.pread"] == 4
        # the first 4 occurrences fire (rate 1.0), later ones pass
        assert sched[:4] == ["RAISE"] * 4

    def test_unarmed_point_passes_through(self):
        plan = parse_spec("seed=3,read.pread:1.0")
        assert plan.decide("state.save") is None

    def test_raise_kind_carries_point_and_occurrence(self):
        plan = parse_spec("seed=0,decode.worker:1.0:1")
        with pytest.raises(InjectedFaultError) as exc_info:
            plan.decide("decode.worker")
        assert exc_info.value.point == "decode.worker"
        assert exc_info.value.occurrence == 0
        assert isinstance(exc_info.value, OSError)

    def test_data_directives(self):
        for point, directive in [
            ("read.short", "short"),
            ("read.corrupt", "corrupt"),
            ("decode.chunk", "fail"),
        ]:
            plan = parse_spec(f"{point}:1.0:1")
            assert plan.decide(point) == directive

    def test_install_arms_and_restores(self):
        assert faults.active_plan() is None
        with faults.install("seed=5,read.short:1.0:1") as plan:
            assert faults.active_plan() is plan
            assert faults.fault_point("read.short") == "short"
            assert faults.fault_point("read.short") is None  # budget spent
        assert faults.active_plan() is None
        assert faults.fault_point("read.short") is None

    def test_install_from_env(self, monkeypatch):
        monkeypatch.setenv(faults.ENV_KNOB, "seed=2,state.save:1.0:1")
        plan = faults.install_from_env()
        try:
            assert plan is not None
            assert faults.active_plan() is plan
        finally:
            monkeypatch.setenv(faults.ENV_KNOB, "")
            assert faults.install_from_env() is None
            # env-armed plans have no context manager: disarm by hand
            faults._PLAN = None
        assert faults.active_plan() is None


# ---------------------------------------------------------------------------
# retry + backoff
# ---------------------------------------------------------------------------


class TestRetry:
    def test_backoff_deterministic_and_bounded(self):
        for attempt in range(5):
            a = backoff_s(0.01, attempt, key="unit-3")
            b = backoff_s(0.01, attempt, key="unit-3")
            assert a == b
            lo = 0.01 * (2.0 ** attempt) * 0.5
            hi = 0.01 * (2.0 ** attempt) * 1.5
            assert lo <= a < hi

    def test_backoff_key_decorrelates(self):
        assert backoff_s(0.01, 2, key="a") != backoff_s(0.01, 2, key="b")

    def test_recovers_after_transient_failures(self):
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise OSError("transient")
            return b"data"

        result, retries, recovered = retry_call(
            flaky, attempts=3, base_s=0.0001, key="t"
        )
        assert result == b"data"
        assert retries == 2
        assert recovered is True

    def test_none_result_counts_as_transient(self):
        calls = {"n": 0}

        def short_read():
            calls["n"] += 1
            return None if calls["n"] == 1 else b"full"

        result, retries, recovered = retry_call(
            short_read, attempts=3, base_s=0.0001
        )
        assert result == b"full"
        assert (retries, recovered) == (1, True)

    def test_exhaustion_degrades_never_raises(self):
        def always_fails():
            raise OSError("persistent")

        result, retries, recovered = retry_call(
            always_fails, attempts=2, base_s=0.0001
        )
        assert result is None
        assert retries == 2
        assert recovered is False

    def test_non_retryable_propagates(self):
        def typo():
            raise KeyError("not io")

        with pytest.raises(KeyError):
            retry_call(typo, attempts=3, base_s=0.0001)

    def test_first_try_success_is_zero_retries(self):
        result, retries, recovered = retry_call(
            lambda: 42, attempts=3, base_s=0.0001
        )
        assert (result, retries, recovered) == (42, 0, False)


# ---------------------------------------------------------------------------
# RunController + RunCancelled
# ---------------------------------------------------------------------------


class TestController:
    def test_cancel_raises_dq401_with_progress(self):
        ctl = RunController()
        ctl.check(where="warm")  # no-op before cancel
        ctl.cancel()
        with pytest.raises(RunCancelled) as exc_info:
            ctl.check(where="fold batch", progress={"batches": 7, "rows": 900})
        err = exc_info.value
        assert err.code == DQ_CANCELLED
        assert err.where == "fold batch"
        assert err.progress == {"batches": 7, "rows": 900}
        assert "[DQ401]" in str(err)
        assert "batches=7" in str(err)

    def test_first_cancel_wins_reason(self):
        ctl = RunController()
        ctl.cancel("stalled")
        ctl.cancel("cancelled")
        with pytest.raises(RunCancelled) as exc_info:
            ctl.check()
        assert exc_info.value.code == DQ_STALLED

    def test_deadline_trips_dq402(self):
        ctl = RunController(deadline_s=0.0)
        time.sleep(0.002)
        with pytest.raises(RunCancelled) as exc_info:
            ctl.check(where="partition p1")
        assert exc_info.value.code == DQ_DEADLINE
        assert ctl.cancelled

    def test_remaining_s(self):
        assert RunController().remaining_s() is None
        ctl = RunController(deadline_s=60.0)
        r = ctl.remaining_s()
        assert r is not None and 0 < r <= 60.0

    def test_beat_counts(self):
        ctl = RunController()
        for _ in range(3):
            ctl.beat()
        assert ctl.beats == 3


class TestWatchdog:
    def test_dump_then_cancel_on_silence(self):
        ctl = RunController()
        out = io.StringIO()
        wd = StallWatchdog(ctl, 0.03, out=out).start()
        try:
            deadline = time.monotonic() + 5.0
            while not ctl.cancelled and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            wd.stop()
        assert ctl.cancelled
        with pytest.raises(RunCancelled) as exc_info:
            ctl.check()
        assert exc_info.value.code == DQ_STALLED
        assert wd.dumps >= 2  # one diagnostic dump BEFORE the cancel
        assert "no batch progress" in out.getvalue()

    def test_beats_keep_watchdog_quiet(self):
        ctl = RunController()
        out = io.StringIO()
        wd = StallWatchdog(ctl, 0.05, out=out).start()
        try:
            for _ in range(8):
                ctl.beat()
                time.sleep(0.02)
        finally:
            wd.stop()
        assert not ctl.cancelled

    def test_snapshot_fn_feeds_dump(self):
        ctl = RunController()
        out = io.StringIO()
        wd = StallWatchdog(
            ctl, 0.03, out=out, snapshot_fn=lambda: {"stage": "decode", "q": 4}
        ).start()
        try:
            deadline = time.monotonic() + 5.0
            while not ctl.cancelled and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            wd.stop()
        assert "decode" in out.getvalue()


# ---------------------------------------------------------------------------
# suite-level: cancel mid-run, resume from committed partitions
# ---------------------------------------------------------------------------


class _CancelAfterFirstCommit(InMemoryStateRepository):
    """Trips the controller the moment the first partition state
    commits — the sharpest possible mid-run cancel."""

    def __init__(self, controller: RunController) -> None:
        super().__init__()
        self._controller = controller

    def _put(self, dataset, signature, fingerprint, blob):
        super()._put(dataset, signature, fingerprint, blob)
        self._controller.cancel()


class TestCancelThenResume:
    def test_rerun_scans_only_remaining_partitions(self, tmp_path, monkeypatch):
        monkeypatch.delenv("DEEQU_TPU_STATE_CACHE", raising=False)
        rng = np.random.default_rng(99)
        data_dir = tmp_path / "data"
        data_dir.mkdir()
        for i in range(3):
            _random_table(rng, 300 + 17 * i).to_parquet(
                str(data_dir / f"p{i}.parquet"), row_group_size=128
            )
        analyzers = [Size(), Mean("x"), StandardDeviation("x"), Completeness("x")]

        clean = AnalysisRunner.do_analysis_run(
            Table.scan_parquet_dataset(str(data_dir)), analyzers
        )

        ctl = RunController()
        repo = _CancelAfterFirstCommit(ctl)
        with pytest.raises(RunCancelled) as exc_info:
            AnalysisRunner.do_analysis_run(
                Table.scan_parquet_dataset(str(data_dir)), analyzers,
                state_repository=repo, dataset_name="resume",
                controller=ctl,
            )
        err = exc_info.value
        assert err.code == DQ_CANCELLED
        assert err.progress.get("partitions_done") == 1
        assert err.progress.get("partitions_total") == 3

        # the rerun loads the committed partition and scans ONLY the rest
        resumed = AnalysisRunner.do_analysis_run(
            Table.scan_parquet_dataset(str(data_dir)), analyzers,
            state_repository=repo, dataset_name="resume", tracing=True,
        )
        counters = resumed.run_trace.counters
        assert counters["partitions_cached"] == 1
        assert counters["partitions_scanned"] == 2
        for a in analyzers:
            assert _bits(clean.metric_map[a].value.get()) == _bits(
                resumed.metric_map[a].value.get()
            ), repr(a)

    def test_cancelled_run_leaks_no_engine_threads(self, tmp_path):
        import threading

        rng = np.random.default_rng(5)
        data_dir = tmp_path / "data"
        data_dir.mkdir()
        _random_table(rng, 2000).to_parquet(
            str(data_dir / "p0.parquet"), row_group_size=128
        )
        ctl = RunController()
        ctl.cancel()
        with pytest.raises(RunCancelled):
            AnalysisRunner.do_analysis_run(
                Table.scan_parquet_dataset(str(data_dir)),
                [Size(), Mean("x")],
                controller=ctl,
            )
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            alive = [
                t.name
                for t in threading.enumerate()
                if t.name.startswith("deequ-") and t.name != "deequ-watchdog"
            ]
            if not alive:
                break
            time.sleep(0.01)
        assert not alive, f"engine threads leaked past cancel: {alive}"


# ---------------------------------------------------------------------------
# EXPLAIN + DQ318: the resilience surface
# ---------------------------------------------------------------------------


class TestExplainResilience:
    def test_deadline_without_partitions_warns_dq318(self):
        from deequ_tpu_torch.verification.suite import VerificationSuite

        rng = np.random.default_rng(1)
        explained = (
            VerificationSuite.on_data(_random_table(rng, 100))
            .add_required_analyzer(Mean("x"))
            .with_deadline(30.0)
            .explain()
        )
        rendered = str(explained)
        assert "resilience: retries=" in rendered
        assert "deadline=30s" in rendered
        assert any(
            d.code == "DQ318" for d in explained.diagnostics
        ), [d.code for d in explained.diagnostics]

    def test_no_deadline_no_dq318_no_resilience_deadline(self):
        from deequ_tpu_torch.verification.suite import VerificationSuite

        rng = np.random.default_rng(1)
        explained = (
            VerificationSuite.on_data(_random_table(rng, 100))
            .add_required_analyzer(Mean("x"))
            .explain()
        )
        assert not any(d.code == "DQ318" for d in explained.diagnostics)
        assert "deadline=" not in str(explained)


# ---------------------------------------------------------------------------
# the port's harness against the JAX package's
# ---------------------------------------------------------------------------


def test_fault_kinds_equal_jax():
    from deequ_tpu.testing import faults as jfaults

    assert faults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert list(faults.FAULT_KINDS) == list(jfaults.FAULT_KINDS)
    assert faults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert faults.DEFAULT_STALL_S == jfaults.DEFAULT_STALL_S
    assert faults.ENV_KNOB == jfaults.ENV_KNOB


def _outcomes(plan, point, n):
    out = []
    for _ in range(n):
        try:
            out.append(plan.decide(point))
        except Exception as e:  # noqa: BLE001 - each package's own error class
            out.append(("RAISE", e.point, e.occurrence))
    return out


@pytest.mark.parametrize("seed", [0, 7, 2024])
@pytest.mark.parametrize("point", sorted(faults.FAULT_POINTS))
def test_schedule_equals_jax(point, seed):
    """Over 1,000 occurrences the port's plan fires where the JAX plan
    fires, with the same directive, for every point. Sleep-kind points
    run with a zero stall so the schedule shows in `injected` alone."""
    from deequ_tpu.testing import faults as jfaults

    spec = f"seed={seed},stall=0,{point}:0.3"
    plan, jplan = parse_spec(spec), jfaults.parse_spec(spec)
    assert _outcomes(plan, point, 1000) == _outcomes(jplan, point, 1000)
    assert plan.injected == jplan.injected
    assert plan.injected.get(point, 0) > 0


def test_budgeted_schedule_equals_jax():
    from deequ_tpu.testing import faults as jfaults

    spec = "seed=13,read.pread:0.5:7,read.short:0.9:2"
    plan, jplan = parse_spec(spec), jfaults.parse_spec(spec)
    for point in ("read.pread", "read.short"):
        assert _outcomes(plan, point, 300) == _outcomes(jplan, point, 300)
    assert plan.injected == jplan.injected == {"read.pread": 7, "read.short": 2}


def test_backoff_equals_jax_bit_for_bit():
    from deequ_tpu.core.controller import backoff_s as jbackoff_s

    for key in ("", "unit-3", "/data/p.parquet:4:x"):
        for attempt in range(8):
            for base in (0.0001, 0.01, 0.25):
                assert _bits(backoff_s(base, attempt, key)) == _bits(jbackoff_s(base, attempt, key))


def test_dq_codes_equal_jax():
    from deequ_tpu.core import controller as jcontroller
    from deequ_tpu_torch.core import controller

    assert controller.__all__ == jcontroller.__all__
    for name in controller.__all__:
        if name.startswith("DQ_"):
            assert getattr(controller, name) == getattr(jcontroller, name), name
    assert controller._REASON_CODES == jcontroller._REASON_CODES


def test_every_fault_point_literal_in_the_port_is_registered():
    """The FAULTS rule: a `fault_point("...")` literal naming a point
    that is not in FAULT_KINDS could never fire, so the containment code
    behind it would go untested. Every call site passes a literal."""
    import ast
    import os

    import deequ_tpu_torch

    root = os.path.dirname(deequ_tpu_torch.__file__)
    seen = set()
    for dirpath, _dirs, files in os.walk(root):
        for fname in files:
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            with open(path, encoding="utf-8") as f:
                tree = ast.parse(f.read(), filename=path)
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                fn = node.func
                name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", None)
                if name != "fault_point" or path.endswith(os.path.join("testing", "faults.py")):
                    continue
                assert node.args and isinstance(node.args[0], ast.Constant), (path, node.lineno)
                point = node.args[0].value
                assert point in faults.FAULT_POINTS, (path, node.lineno, point)
                seen.add(point)
    # every registered point has a call site in the port
    assert seen == faults.FAULT_POINTS


@pytest.mark.parametrize("value", [None, "", "0", "5", "-2", "2.5", "x", "0.25"])
def test_resilience_knobs_equal_jax(value, monkeypatch):
    from deequ_tpu.ops import runtime as jruntime
    from deequ_tpu_torch.ops import runtime

    for knob in ("DEEQU_TPU_RETRIES", "DEEQU_TPU_RETRY_BASE_MS", "DEEQU_TPU_STALL_WATCHDOG_S"):
        if value is None:
            monkeypatch.delenv(knob, raising=False)
        else:
            monkeypatch.setenv(knob, value)
    for name in ("retry_budget", "retry_base_s", "stall_watchdog_s"):
        got, want = getattr(runtime, name)(), getattr(jruntime, name)()
        assert (type(got), got) == (type(want), want), (name, value)
