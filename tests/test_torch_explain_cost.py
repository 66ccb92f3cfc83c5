"""Static cost analyzer + EXPLAIN tests.

Covers the golden report shape, each DQ300-DQ304 diagnostic with a
firing AND a non-firing plan, strict-mode aggregation of DQ3xx warnings
next to DQ1xx/DQ2xx errors, and the zero-scan guarantee: the analyzer
must never pack a batch, run a fused pass, or launch a kernel.

Port-mapped from tests/test_explain_cost.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Histogram,
    Maximum,
    Mean,
    Minimum,
    StandardDeviation,
    Uniqueness,
)
from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.lint import (
    FieldInfo,
    PlanValidationError,
    SchemaInfo,
    analyze_plan,
    explain,
    explain_plan,
    validate_plan,
)
from deequ_tpu_torch.lint.explain import (
    DQ302_CAP_LIMIT,
    DQ304_MAX_BATCHES,
    DQ304_MIN_BATCH,
)

pytestmark = pytest.mark.usefixtures("cpu_default")

SCHEMA = SchemaInfo(
    [
        FieldInfo("item", ColumnType.STRING, nullable=False),
        FieldInfo("qty", ColumnType.LONG, nullable=False),
        FieldInfo("price", ColumnType.DOUBLE, nullable=True),
        FieldInfo("cost", ColumnType.DOUBLE, nullable=True),
    ]
)


def codes(diags):
    return [d.code for d in diags]


def explain_diags(analyzers, schema=SCHEMA, **kwargs):
    return explain_plan(schema, analyzers=analyzers, **kwargs).diagnostics


# -- golden report ------------------------------------------------------------


class TestExplainReport:
    def test_golden_report_structure(self):
        report = explain(
            [
                Mean("price"),
                Minimum("price"),
                Completeness("qty"),
                ApproxCountDistinct("item"),
            ],
            SCHEMA,
            num_rows=1_000_000,
            placement="device",
        )
        # header
        assert "== Plan explain (static — no data scanned) ==" in report
        assert "analyzers: 4" in report
        assert "placement: device" in report
        assert "rows: 1000000" in report
        # the fused scan pass with its members and batch count
        assert "fused scan" in report and "[scan]" in report
        assert "batches: 1" in report
        # prediction lines are machine-checked elsewhere; here only shape
        assert "predicted counters: device_passes=" in report
        assert "predicted spans: " in report
        assert "-- no performance diagnostics --" in report

    def test_report_renders_diagnostics_tail(self):
        result = explain_plan(
            SCHEMA,
            analyzers=[ApproxQuantile("price", 0.5, relative_error=1e-6)],
        )
        text = result.render()
        assert "diagnostic(s) --" in text
        assert "DQ302" in text

    def test_explain_accepts_table_and_infers_rows(self):
        table = Table.from_pydict(
            {"price": np.arange(100, dtype=np.float64)}
        )
        result = explain_plan(table, analyzers=[Mean("price")])
        assert result.cost.num_rows == 100
        assert result.cost.scan_pass is not None

    def test_precondition_failures_reported_without_scanning(self):
        result = explain_plan(SCHEMA, analyzers=[Mean("item")])
        assert result.cost.precondition_failures
        assert "precondition failures" in result.render()


# -- DQ300: redundant extra pass ----------------------------------------------


class TestDQ300:
    def test_fires_when_aux_pass_rereads_scan_columns(self):
        diags = explain_diags([Mean("price"), Histogram("price")])
        assert "DQ300" in codes(diags)

    def test_silent_when_aux_pass_reads_other_columns(self):
        diags = explain_diags([Mean("price"), Histogram("item")])
        assert "DQ300" not in codes(diags)


# -- DQ301: equivalent-but-differently-normalized wheres ----------------------


class TestDQ301:
    def test_fires_on_provably_equivalent_spellings(self):
        diags = explain_diags(
            [
                Mean("price", where="qty > 1"),
                Minimum("price", where="not (qty <= 1)"),
            ]
        )
        assert "DQ301" in codes(diags)

    def test_silent_on_genuinely_different_predicates(self):
        diags = explain_diags(
            [
                Mean("price", where="qty > 1"),
                Minimum("price", where="qty > 2"),
            ]
        )
        assert "DQ301" not in codes(diags)

    def test_silent_on_identical_normalization(self):
        # same normalize key is DQ206's territory, not DQ301's
        diags = explain_diags(
            [
                Mean("price", where="qty > 1"),
                Minimum("price", where="qty  >  1"),
            ]
        )
        assert "DQ301" not in codes(diags)


# -- DQ302: sketch/grouping blowup --------------------------------------------


class TestDQ302:
    def test_fires_on_extreme_quantile_cap(self):
        analyzer = ApproxQuantile("price", 0.5, relative_error=1e-6)
        assert analyzer._sample_size() >= DQ302_CAP_LIMIT
        diags = explain_diags([analyzer])
        assert "DQ302" in codes(diags)

    def test_silent_on_default_quantile_cap(self):
        diags = explain_diags([ApproxQuantile("price", 0.5)])
        assert "DQ302" not in codes(diags)

    def test_fires_on_estimated_group_blowup(self):
        schema = SchemaInfo(
            [
                FieldInfo("a", ColumnType.STRING, approx_distinct=3000),
                FieldInfo("b", ColumnType.STRING, approx_distinct=3000),
            ]
        )
        diags = explain_diags([Uniqueness(["a", "b"])], schema=schema)
        assert "DQ302" in codes(diags)
        cost = explain_plan(schema, analyzers=[Uniqueness(["a", "b"])]).cost
        grouping = [p for p in cost.passes if p.kind == "grouping"]
        assert grouping and grouping[0].spill_risk
        assert grouping[0].estimated_groups == 3000 * 3000

    def test_silent_on_small_estimated_groups(self):
        schema = SchemaInfo(
            [
                FieldInfo("a", ColumnType.STRING, approx_distinct=10),
                FieldInfo("b", ColumnType.STRING, approx_distinct=10),
            ]
        )
        diags = explain_diags([Uniqueness(["a", "b"])], schema=schema)
        assert "DQ302" not in codes(diags)

    def test_silent_without_cardinality_hints(self):
        diags = explain_diags([Uniqueness(["item", "qty"])])
        assert "DQ302" not in codes(diags)


# -- DQ303: family-group cache tile over budget -------------------------------


class TestDQ303:
    @staticmethod
    def _wide_schema(n):
        return SchemaInfo(
            [FieldInfo(f"c{i}", ColumnType.DOUBLE) for i in range(n)]
        )

    def test_fires_when_one_family_group_batches_too_many_columns(self):
        n = 30
        diags = explain_diags(
            [ApproxQuantile(f"c{i}", 0.5) for i in range(n)],
            schema=self._wide_schema(n),
            placement="host-all",
        )
        assert "DQ303" in codes(diags)

    def test_silent_on_modest_family_groups(self):
        n = 4
        diags = explain_diags(
            [ApproxQuantile(f"c{i}", 0.5) for i in range(n)],
            schema=self._wide_schema(n),
            placement="host-all",
        )
        assert "DQ303" not in codes(diags)


# -- DQ304: tiny explicit batch size ------------------------------------------


class TestDQ304:
    def test_fires_on_tiny_batches_with_device_members(self):
        diags = explain_diags(
            [Mean("price"), Maximum("price")],
            num_rows=100_000,
            batch_size=4096,
            placement="device",
        )
        assert "DQ304" in codes(diags)
        cost = analyze_plan(
            [Mean("price")],
            SCHEMA,
            num_rows=100_000,
            batch_size=4096,
            placement="device",
        )
        assert cost.scan_pass.n_batches > DQ304_MAX_BATCHES
        assert cost.batch_size < DQ304_MIN_BATCH

    def test_silent_on_default_batch_size(self):
        diags = explain_diags(
            [Mean("price")], num_rows=100_000, placement="device"
        )
        assert "DQ304" not in codes(diags)

    def test_silent_without_device_members(self):
        # host-only members never dispatch: batch size is irrelevant
        diags = explain_diags(
            [ApproxQuantile("price", 0.5)],
            num_rows=100_000,
            batch_size=4096,
            placement="host-all",
        )
        assert "DQ304" not in codes(diags)


# -- strict-mode aggregation --------------------------------------------------


class TestStrictAggregation:
    def test_dq3xx_warnings_ride_in_plan_validation_error(self):
        with pytest.raises(PlanValidationError) as excinfo:
            validate_plan(
                SCHEMA,
                required_analyzers=[
                    Mean("item"),  # DQ102: numeric analyzer on STRING
                    ApproxQuantile("price", 0.5, relative_error=1e-6),
                ],
                mode="strict",
            )
        seen = codes(excinfo.value.diagnostics)
        assert "DQ102" in seen
        assert "DQ302" in seen

    def test_lenient_report_attaches_plan_cost(self):
        report = validate_plan(
            SCHEMA,
            required_analyzers=[Mean("price")],
            mode="lenient",
            num_rows=50_000,
        )
        assert report.plan_cost is not None
        assert report.plan_cost.num_rows == 50_000
        assert report.plan_cost.scan_pass is not None


# -- the zero-scan guarantee --------------------------------------------------


class TestZeroScan:
    def test_explain_never_packs_dispatches_or_scans(self, monkeypatch):
        """EXPLAIN is static: trap every execution entry point and prove
        none is reached even when a real data table is explained."""
        import deequ_tpu_torch.ops.fused as fused
        import deequ_tpu_torch.runners.grouping_runner as grouping_runner

        def trap(name):
            def _boom(*args, **kwargs):
                raise AssertionError(f"explain executed {name}")

            return _boom

        monkeypatch.setattr(
            fused, "pack_batch_inputs", trap("pack_batch_inputs")
        )
        monkeypatch.setattr(
            fused.FusedScanPass, "run", trap("FusedScanPass.run")
        )
        monkeypatch.setattr(
            fused.FusedScanPass, "_run_pass", trap("FusedScanPass._run_pass")
        )
        monkeypatch.setattr(
            grouping_runner,
            "run_grouping_analyzers",
            trap("run_grouping_analyzers"),
        )

        table = Table.from_pydict(
            {
                "price": np.arange(10_000, dtype=np.float64),
                "qty": np.arange(10_000, dtype=np.int64),
            }
        )
        result = explain_plan(
            table,
            analyzers=[
                Mean("price"),
                StandardDeviation("price"),
                ApproxQuantile("price", 0.5),
                Uniqueness(["qty"]),
                Histogram("qty"),
            ],
        )
        assert result.cost.scan_pass is not None
        assert result.cost.num_rows == 10_000
        assert result.render()

    def test_validate_plan_is_static_too(self, monkeypatch):
        import deequ_tpu_torch.ops.fused as fused

        def boom(*args, **kwargs):
            raise AssertionError("validate_plan packed a batch")

        monkeypatch.setattr(fused, "pack_batch_inputs", boom)
        report = validate_plan(
            SCHEMA,
            required_analyzers=[Mean("price"), Uniqueness(["item"])],
            mode="lenient",
            num_rows=123_456,
        )
        assert report.plan_cost is not None
