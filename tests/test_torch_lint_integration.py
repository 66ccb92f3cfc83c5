"""Fail-fast integration tests: strict mode raises
ONE aggregated PlanValidationError before any kernel dispatch; lenient
attaches warnings to the result/context; off skips the pass; the mode
resolves from builder > parameter > DEEQU_TPU_VALIDATE env > lenient.

Port-mapped from tests/test_lint_integration.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import pytest

from deequ_tpu_torch import Check, CheckLevel
from deequ_tpu_torch.analyzers import Completeness, Mean
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.lint import PlanValidationError
from deequ_tpu_torch.lint.planlint import resolve_validation_mode
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from deequ_tpu_torch.verification.suite import VerificationSuite

pytestmark = pytest.mark.usefixtures("cpu_default")


def small_table() -> Table:
    return Table.from_pydict(
        {
            "price": [1.0, 2.0, 3.0, None],
            "item": ["a", "b", "c", "d"],
        }
    )


BAD_CHECK = Check(CheckLevel.ERROR, "bad").is_complete("prce")
GOOD_CHECK = Check(CheckLevel.ERROR, "good").is_complete("item")


def _no_scan(monkeypatch):
    """Make ANY kernel dispatch explode — proves fail-fast ordering."""
    from deequ_tpu_torch.ops.fused import FusedScanPass

    def boom(self, *args, **kwargs):
        raise AssertionError("kernel dispatched before plan validation")

    monkeypatch.setattr(FusedScanPass, "run", boom)


class TestStrictMode:
    def test_strict_raises_before_any_kernel_dispatch(self, monkeypatch):
        _no_scan(monkeypatch)
        with pytest.raises(PlanValidationError) as excinfo:
            VerificationSuite.do_verification_run(
                small_table(), [BAD_CHECK], validation="strict"
            )
        assert any(d.code == "DQ101" for d in excinfo.value.diagnostics)

    def test_strict_aggregates_all_errors_in_one_raise(self):
        check = (
            Check(CheckLevel.ERROR, "bad")
            .is_complete("prce")
            .has_mean("item", lambda v: True)  # wrong type
            .satisfies("price < 1 AND price > 2", "impossible")
        )
        with pytest.raises(PlanValidationError) as excinfo:
            VerificationSuite.do_verification_run(
                small_table(), [check], validation="strict"
            )
        found = {d.code for d in excinfo.value.diagnostics}
        assert {"DQ101", "DQ102", "DQ204"} <= found
        assert "Plan validation failed" in str(excinfo.value)

    def test_strict_passes_clean_plan(self):
        result = VerificationSuite.do_verification_run(
            small_table(), [GOOD_CHECK], validation="strict"
        )
        assert result.validation_warnings == []

    def test_strict_runner_raises_before_dispatch(self, monkeypatch):
        _no_scan(monkeypatch)
        with pytest.raises(PlanValidationError):
            AnalysisRunner.do_analysis_run(
                small_table(), [Mean("nope")], validation="strict"
            )

    def test_warnings_do_not_fail_strict(self):
        # duplicate analyzers are warning-severity: strict still runs
        result = VerificationSuite.do_verification_run(
            small_table(),
            [GOOD_CHECK],
            required_analyzers=[Mean("price"), Mean("price")],
            validation="strict",
        )
        assert any(d.code == "DQ202" for d in result.validation_warnings)


class TestLenientMode:
    def test_lenient_runs_and_attaches_diagnostics(self):
        result = VerificationSuite.do_verification_run(
            small_table(), [BAD_CHECK]  # lenient is the default
        )
        assert any(d.code == "DQ101" for d in result.validation_warnings)
        # the run itself proceeded: the bad constraint failed at runtime
        assert result.status.name != "SUCCESS"

    def test_lenient_runner_attaches_to_context(self):
        context = AnalysisRunner.do_analysis_run(
            small_table(), [Mean("nope")], validation="lenient"
        )
        assert any(d.code == "DQ101" for d in context.validation_warnings)

    def test_clean_plan_attaches_nothing(self):
        context = AnalysisRunner.do_analysis_run(
            small_table(), [Mean("price")], validation="lenient"
        )
        assert context.validation_warnings == []
        assert context.metric_map[Mean("price")].value.get() == 2.0


class TestOffMode:
    def test_off_skips_validation(self):
        result = VerificationSuite.do_verification_run(
            small_table(), [BAD_CHECK], validation="off"
        )
        assert result.validation_warnings == []


class TestModeResolution:
    def test_explicit_mode_wins(self, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_VALIDATE", "off")
        assert resolve_validation_mode("strict") == "strict"

    def test_env_knob(self, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_VALIDATE", "strict")
        assert resolve_validation_mode(None) == "strict"
        with pytest.raises(PlanValidationError):
            VerificationSuite.do_verification_run(small_table(), [BAD_CHECK])

    def test_default_is_lenient(self, monkeypatch):
        monkeypatch.delenv("DEEQU_TPU_VALIDATE", raising=False)
        assert resolve_validation_mode(None) == "lenient"

    def test_unknown_mode_degrades_to_lenient(self):
        assert resolve_validation_mode("bogus") == "lenient"
        assert resolve_validation_mode(" STRICT ") == "strict"


class TestBuilders:
    def test_verification_builder_strict(self):
        with pytest.raises(PlanValidationError):
            (
                VerificationSuite()
                .on_data(small_table())
                .add_check(BAD_CHECK)
                .with_plan_validation("strict")
                .run()
            )

    def test_analysis_builder_strict(self):
        with pytest.raises(PlanValidationError):
            (
                AnalysisRunner.on_data(small_table())
                .add_analyzer(Mean("nope"))
                .with_plan_validation("strict")
                .run()
            )

    def test_analysis_builder_lenient_default(self):
        context = (
            AnalysisRunner.on_data(small_table())
            .add_analyzer(Completeness("prce"))
            .run()
        )
        assert any(d.code == "DQ101" for d in context.validation_warnings)
        assert any(
            d.suggestion == "price" for d in context.validation_warnings
        )


class TestSchemaInference:
    def test_nullability_inferred_from_table_validity(self):
        # price has a NULL -> nullable; item has none -> non-nullable,
        # so `item IS NULL` is statically unsatisfiable on THIS table
        table = small_table()
        context = AnalysisRunner.do_analysis_run(
            table,
            [Mean("price", where="item IS NULL")],
            validation="lenient",
        )
        assert any(d.code == "DQ204" for d in context.validation_warnings)

    def test_suite_passes_off_to_inner_runner(self, monkeypatch):
        # the suite validates the full plan once; the inner analysis run
        # must not re-lint (it would double every diagnostic)
        calls = []
        import deequ_tpu_torch.runners.analysis_runner as runner_mod

        original = runner_mod.AnalysisRunner._validate_plan

        # the port's runner passes its resolved device as well
        def counting(data, analyzers, validation, state_cache=None, device=None):
            calls.append(validation)
            return original(data, analyzers, validation, state_cache, device)

        monkeypatch.setattr(
            runner_mod.AnalysisRunner, "_validate_plan", staticmethod(counting)
        )
        VerificationSuite.do_verification_run(small_table(), [GOOD_CHECK])
        assert calls == ["off"]
