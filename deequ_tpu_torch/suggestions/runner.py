"""ConstraintSuggestionRunner: profile data, apply rules per column,
optionally evaluate suggestions on a held-out split.

reference: suggestions/ConstraintSuggestionRunner.scala:58-322 +
ConstraintSuggestionRunBuilder.scala:78-289. The profile and the
held-out evaluation run on CUDA unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from deequ_tpu_torch.checks.check import Check, CheckLevel
from deequ_tpu_torch.core.fileio import write_text_output
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.profiles.column_profile import ColumnProfile
from deequ_tpu_torch.profiles.column_profiler import (
    DEFAULT_CARDINALITY_THRESHOLD,
    ColumnProfiler,
)
from deequ_tpu_torch.suggestions.rules import ConstraintRule
from deequ_tpu_torch.suggestions.suggestion import (
    ConstraintSuggestion,
    evaluation_results_to_json,
    suggestions_to_json,
)
from deequ_tpu_torch.verification.suite import VerificationSuite


@dataclass
class ConstraintSuggestionResult:
    """reference: suggestions/ConstraintSuggestionResult.scala:30."""

    column_profiles: Dict[str, ColumnProfile]
    num_records: int
    constraint_suggestions: Dict[str, List[ConstraintSuggestion]]
    verification_result: Optional[object] = None

    def all_suggestions(self) -> List[ConstraintSuggestion]:
        return [s for group in self.constraint_suggestions.values() for s in group]

    def suggestions_as_json(self) -> str:
        return suggestions_to_json(self.all_suggestions())


class ConstraintSuggestionRunner:
    @staticmethod
    def on_data(
        data: Table, device: runtime.DeviceLike = None
    ) -> "ConstraintSuggestionRunBuilder":
        """Suggestions for `data`, profiled and evaluated on `device` (CUDA
        unless the caller asks for the CPU with ``device="cpu"``)."""
        return ConstraintSuggestionRunBuilder(data, device)


class ConstraintSuggestionRunBuilder:
    def __init__(self, data: Table, device: runtime.DeviceLike = None):
        self._data = data
        self._device = device
        self._rules: List[ConstraintRule] = []
        self._print_status_updates = False
        self._test_set_ratio: Optional[float] = None
        self._test_set_split_seed: Optional[int] = None
        self._low_cardinality_histogram_threshold = DEFAULT_CARDINALITY_THRESHOLD
        self._restrict_to_columns: Optional[Sequence[str]] = None
        self._metrics_repository = None
        self._reuse_key = None
        self._fail_if_results_missing = False
        self._save_key = None
        self._save_column_profiles_json_path: Optional[str] = None
        self._save_constraint_suggestions_json_path: Optional[str] = None
        self._save_evaluation_results_json_path: Optional[str] = None
        self._overwrite_output_files = False

    def add_constraint_rule(self, rule: ConstraintRule) -> "ConstraintSuggestionRunBuilder":
        self._rules.append(rule)
        return self

    def add_constraint_rules(self, rules) -> "ConstraintSuggestionRunBuilder":
        if callable(rules):
            rules = rules()
        self._rules.extend(rules)
        return self

    def print_status_updates(self, value: bool) -> "ConstraintSuggestionRunBuilder":
        self._print_status_updates = value
        return self

    def use_train_test_split_with_test_set_ratio(
        self, ratio: float, seed: Optional[int] = None
    ) -> "ConstraintSuggestionRunBuilder":
        """reference: ConstraintSuggestionRunner.scala:127-148."""
        if not (0.0 < ratio < 1.0):
            raise ValueError("Test set ratio must be in (0, 1)")
        self._test_set_ratio = ratio
        self._test_set_split_seed = seed
        return self

    def with_low_cardinality_histogram_threshold(
        self, threshold: int
    ) -> "ConstraintSuggestionRunBuilder":
        self._low_cardinality_histogram_threshold = threshold
        return self

    def restrict_to_columns(self, columns) -> "ConstraintSuggestionRunBuilder":
        self._restrict_to_columns = columns
        return self

    def use_repository(self, repository) -> "ConstraintSuggestionRunBuilder":
        self._metrics_repository = repository
        return self

    def reuse_existing_results_for_key(
        self, key, fail_if_results_missing: bool = False
    ) -> "ConstraintSuggestionRunBuilder":
        self._reuse_key = key
        self._fail_if_results_missing = fail_if_results_missing
        return self

    def save_or_append_result(self, key) -> "ConstraintSuggestionRunBuilder":
        self._save_key = key
        return self

    def save_column_profiles_json_to_path(
        self, path: str
    ) -> "ConstraintSuggestionRunBuilder":
        """reference: ConstraintSuggestionRunBuilder.scala:243-249."""
        self._save_column_profiles_json_path = path
        return self

    def save_constraint_suggestions_json_to_path(
        self, path: str
    ) -> "ConstraintSuggestionRunBuilder":
        """reference: ConstraintSuggestionRunBuilder.scala:256-262."""
        self._save_constraint_suggestions_json_path = path
        return self

    def save_evaluation_results_json_to_path(
        self, path: str
    ) -> "ConstraintSuggestionRunBuilder":
        """reference: ConstraintSuggestionRunBuilder.scala:269-275."""
        self._save_evaluation_results_json_path = path
        return self

    def overwrite_output_files(self, value: bool) -> "ConstraintSuggestionRunBuilder":
        """reference: ConstraintSuggestionRunBuilder.scala:283-286."""
        self._overwrite_output_files = value
        return self

    def run(self) -> ConstraintSuggestionResult:
        """reference: ConstraintSuggestionRunner.scala:62-125."""
        # optional train/test split
        if self._test_set_ratio is not None:
            train_ratio = 1.0 - self._test_set_ratio
            train, test = self._data.random_split(
                [train_ratio, self._test_set_ratio], seed=self._test_set_split_seed
            )
        else:
            train, test = self._data, None

        if self._print_status_updates:
            print("### SUGGESTIONS: Profiling the data...")
        profiles = ColumnProfiler.profile(
            train,
            restrict_to_columns=self._restrict_to_columns,
            print_status_updates=self._print_status_updates,
            low_cardinality_histogram_threshold=self._low_cardinality_histogram_threshold,
            metrics_repository=self._metrics_repository,
            reuse_existing_results_for_key=self._reuse_key,
            fail_if_results_missing=self._fail_if_results_missing,
            save_in_metrics_repository_using_key=self._save_key,
            device=self._device,
        )

        # apply rules per column (reference: :193-208)
        suggestions: Dict[str, List[ConstraintSuggestion]] = {}
        for name, profile in profiles.profiles.items():
            for rule in self._rules:
                if rule.should_be_applied(profile, profiles.num_records):
                    suggestions.setdefault(name, []).append(
                        rule.candidate(profile, profiles.num_records)
                    )

        # optionally evaluate on the test split (reference: :283-313)
        verification_result = None
        if test is not None and suggestions:
            check = Check(CheckLevel.WARNING, "generated constraints")
            for group in suggestions.values():
                for suggestion in group:
                    check = check.add_constraint(suggestion.constraint)
            verification_result = VerificationSuite.do_verification_run(
                test, [check], device=self._device
            )

        result = ConstraintSuggestionResult(
            profiles.profiles, profiles.num_records, suggestions, verification_result
        )

        # JSON file outputs (reference: ConstraintSuggestionRunner.scala:220-281)
        if self._save_column_profiles_json_path is not None:
            write_text_output(
                self._save_column_profiles_json_path,
                profiles.to_json(),
                self._overwrite_output_files,
            )
        if self._save_constraint_suggestions_json_path is not None:
            write_text_output(
                self._save_constraint_suggestions_json_path,
                result.suggestions_as_json(),
                self._overwrite_output_files,
            )
        if self._save_evaluation_results_json_path is not None:
            write_text_output(
                self._save_evaluation_results_json_path,
                evaluation_results_to_json(
                    result.all_suggestions(), verification_result
                ),
                self._overwrite_output_files,
            )
        return result
