"""Exact output shapes of VerificationResult exporters — the mirror of
the reference's VerificationResultTest.scala (219 LoC): same fixture
(getDfFull), same analyzers, same checks, byte-level row expectations
including the load-bearing 'Mutlicolumn' typo.

Port-mapped from tests/test_verification_result_shapes.py: the same
cases against deequ_tpu_torch, with every run on device="cpu" and the
toy tables of tests/fixtures.py as the port's tables
(tests/torch_fixtures.py).
"""

from __future__ import annotations

import json

import pytest

from deequ_tpu_torch import Check, CheckLevel, CheckStatus, VerificationSuite
from deequ_tpu_torch.analyzers import Completeness, Distinctness, Size, Uniqueness
from torch_fixtures import get_df_full


@pytest.fixture(scope="module")
def results():
    """reference: VerificationResultTest.scala:173-196 (evaluate)."""
    checks = [
        Check(CheckLevel.ERROR, "group-1").is_complete("att1"),
        Check(CheckLevel.ERROR, "group-2-E")
        .has_size(lambda n: n > 5, hint="Should be greater than 5!")
        .is_complete("att1"),
        Check(CheckLevel.WARNING, "group-2-W").has_distinctness(
            ["item"], lambda v: v < 0.8, hint="Should be smaller than 0.8!"
        ),
    ]
    suite = VerificationSuite.on_data(get_df_full(), device="cpu")
    for check in checks:
        suite = suite.add_check(check)
    return (
        suite.add_required_analyzer(Size())
        .add_required_analyzer(Distinctness(["item"]))
        .add_required_analyzer(Uniqueness(["att1", "att2"]))
        .run()
    )


class TestSuccessMetricsShapes:
    """reference: VerificationResultTest.scala:38-110."""

    def test_rows_exact(self, results):
        rows = results.success_metrics_as_rows()
        as_tuples = {
            (r["entity"], r["instance"], r["name"], r["value"]) for r in rows
        }
        assert ("Dataset", "*", "Size", 4.0) in as_tuples
        assert ("Column", "item", "Distinctness", 1.0) in as_tuples
        assert ("Column", "att1", "Completeness", 1.0) in as_tuples
        # the reference serializes Entity.Multicolumn with its historical
        # typo — byte-compatible output keeps it
        assert ("Mutlicolumn", "att1,att2", "Uniqueness", 0.25) in as_tuples

    def test_rows_filtered_to_requested_analyzers(self, results):
        rows = results.success_metrics_as_rows(
            for_analyzers=[Completeness("att1"), Uniqueness(["att1", "att2"])]
        )
        as_tuples = {
            (r["entity"], r["instance"], r["name"], r["value"]) for r in rows
        }
        assert as_tuples == {
            ("Column", "att1", "Completeness", 1.0),
            ("Mutlicolumn", "att1,att2", "Uniqueness", 0.25),
        }

    def test_json_format(self, results):
        payload = json.loads(results.success_metrics_as_json())
        assert all(
            set(entry.keys()) == {"entity", "instance", "name", "value"}
            for entry in payload
        )
        size_entry = next(e for e in payload if e["name"] == "Size")
        assert size_entry == {
            "entity": "Dataset",
            "instance": "*",
            "name": "Size",
            "value": 4.0,
        }

    def test_table_export_columns(self, results):
        table = results.success_metrics_as_table()
        assert table.column_names == ["entity", "instance", "name", "value"]
        assert table.num_rows >= 4


class TestCheckResultsShapes:
    """reference: VerificationResultTest.scala:115-171."""

    def test_rows_exact(self, results):
        rows = results.check_results_as_rows()
        as_tuples = [
            (
                r["check"],
                r["check_level"],
                r["check_status"],
                r["constraint"],
                r["constraint_status"],
                r["constraint_message"],
            )
            for r in rows
        ]
        assert (
            "group-1",
            "Error",
            "Success",
            "CompletenessConstraint(Completeness(att1,None))",
            "Success",
            "",
        ) in as_tuples
        assert (
            "group-2-E",
            "Error",
            "Error",
            "SizeConstraint(Size(None))",
            "Failure",
            "Value: 4 does not meet the constraint requirement! "
            "Should be greater than 5!",
        ) in as_tuples
        assert (
            "group-2-E",
            "Error",
            "Error",
            "CompletenessConstraint(Completeness(att1,None))",
            "Success",
            "",
        ) in as_tuples
        assert (
            "group-2-W",
            "Warning",
            "Warning",
            "DistinctnessConstraint(Distinctness(List(item)))",
            "Failure",
            "Value: 1.0 does not meet the constraint requirement! "
            "Should be smaller than 0.8!",
        ) in as_tuples

    def test_constraint_order_within_check_preserved(self, results):
        rows = [
            r for r in results.check_results_as_rows() if r["check"] == "group-2-E"
        ]
        assert [r["constraint"] for r in rows] == [
            "SizeConstraint(Size(None))",
            "CompletenessConstraint(Completeness(att1,None))",
        ]

    def test_json_round_trip_equals_rows(self, results):
        assert json.loads(results.check_results_as_json()) == \
            results.check_results_as_rows()

    def test_filter_to_single_check(self, results):
        check = next(iter(results.check_results))
        rows = results.check_results_as_rows(for_checks=[check])
        assert {r["check"] for r in rows} == {check.description}

    def test_table_export_columns(self, results):
        table = results.check_results_as_table()
        assert table.column_names == [
            "check",
            "check_level",
            "check_status",
            "constraint",
            "constraint_status",
            "constraint_message",
        ]

    def test_overall_status(self, results):
        assert results.status == CheckStatus.ERROR
