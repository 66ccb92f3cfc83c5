"""JSON-file output options on the verification and suggestion builders
(reference: VerificationRunBuilder.scala:213-256 —
saveCheckResultsJsonToPath / saveSuccessMetricsJsonToPath /
overwritePreviousFiles — and ConstraintSuggestionRunBuilder.scala:229-289's
three save paths).

Port-mapped from tests/test_json_outputs.py: the same cases against
deequ_tpu_torch, with every run on device="cpu" and the toy tables of
tests/fixtures.py as the port's tables (tests/torch_fixtures.py).
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from deequ_tpu_torch.checks import Check, CheckLevel
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.suggestions.rules import DEFAULT_RULES
from deequ_tpu_torch.suggestions.runner import ConstraintSuggestionRunner
from deequ_tpu_torch.verification import VerificationSuite


def make_table(n: int = 200) -> Table:
    rng = np.random.default_rng(0)
    x = rng.normal(10.0, 1.0, n)
    cat = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)]
    return Table.from_numpy({"x": x, "cat": cat})


class TestVerificationJsonOutputs:
    def _run(self, tmp_path, overwrite=False, **paths):
        builder = VerificationSuite.on_data(make_table(), device="cpu").add_check(
            Check(CheckLevel.ERROR, "basic").is_complete("x").has_size(lambda n: n == 200)
        )
        if "checks" in paths:
            builder = builder.save_check_results_json_to_path(str(paths["checks"]))
        if "metrics" in paths:
            builder = builder.save_success_metrics_json_to_path(str(paths["metrics"]))
        builder = builder.overwrite_output_files(overwrite)
        return builder.run()

    def test_check_results_json_written(self, tmp_path):
        out = tmp_path / "checks.json"
        result = self._run(tmp_path, checks=out)
        payload = json.loads(out.read_text())
        # same rows as the in-memory exporter
        assert payload == json.loads(result.check_results_as_json())
        assert any(row["constraint_status"] == "Success" for row in payload)

    def test_success_metrics_json_written(self, tmp_path):
        out = tmp_path / "metrics.json"
        result = self._run(tmp_path, metrics=out)
        payload = json.loads(out.read_text())
        assert payload == json.loads(result.success_metrics_as_json())
        names = {row["name"] for row in payload}
        assert {"Completeness", "Size"} <= names

    def test_overwrite_guard(self, tmp_path):
        out = tmp_path / "checks.json"
        out.write_text("old")
        with pytest.raises(FileExistsError):
            self._run(tmp_path, checks=out)
        assert out.read_text() == "old"  # guarded write left it untouched
        self._run(tmp_path, checks=out, overwrite=True)
        assert out.read_text() != "old"


class TestSuggestionJsonOutputs:
    def test_three_save_paths(self, tmp_path):
        profiles_out = tmp_path / "profiles.json"
        suggestions_out = tmp_path / "suggestions.json"
        evaluation_out = tmp_path / "evaluation.json"
        result = (
            ConstraintSuggestionRunner.on_data(make_table(), device="cpu")
            .add_constraint_rules(DEFAULT_RULES)
            .use_train_test_split_with_test_set_ratio(0.3, seed=7)
            .save_column_profiles_json_to_path(str(profiles_out))
            .save_constraint_suggestions_json_to_path(str(suggestions_out))
            .save_evaluation_results_json_to_path(str(evaluation_out))
            .run()
        )
        profiles = json.loads(profiles_out.read_text())
        assert {p["column"] for p in profiles["columns"]} == {"x", "cat"}

        suggestions = json.loads(suggestions_out.read_text())
        assert suggestions == json.loads(result.suggestions_as_json())
        assert suggestions["constraint_suggestions"], "rules should fire"

        evaluation = json.loads(evaluation_out.read_text())
        entries = evaluation["constraint_suggestions"]
        assert len(entries) == len(result.all_suggestions())
        statuses = {e["constraint_result_on_test_set"] for e in entries}
        assert statuses <= {"Success", "Failure", "Unknown"}
        assert "Success" in statuses  # complete column evaluates cleanly

    def test_evaluation_without_split_is_unknown(self, tmp_path):
        evaluation_out = tmp_path / "evaluation.json"
        (
            ConstraintSuggestionRunner.on_data(make_table(), device="cpu")
            .add_constraint_rules(DEFAULT_RULES)
            .save_evaluation_results_json_to_path(str(evaluation_out))
            .run()
        )
        entries = json.loads(evaluation_out.read_text())["constraint_suggestions"]
        assert entries and all(
            e["constraint_result_on_test_set"] == "Unknown" for e in entries
        )

    def test_suggestion_overwrite_guard(self, tmp_path):
        out = tmp_path / "suggestions.json"
        out.write_text("old")
        builder = (
            ConstraintSuggestionRunner.on_data(make_table(), device="cpu")
            .add_constraint_rules(DEFAULT_RULES)
            .save_constraint_suggestions_json_to_path(str(out))
        )
        with pytest.raises(FileExistsError):
            builder.run()
        builder.overwrite_output_files(True).run()
        assert out.read_text() != "old"
