"""Constraint-suggestion rules: profile -> candidate constraint.

reference: suggestions/rules/*.scala (8 rules; DEFAULT = 6,
ConstraintSuggestionRunner.scala:29-35). Trigger conditions, CI formulas
(z=1.96, rounded DOWN to 2 decimals) and descriptions mirror the
reference; generated code snippets use this framework's Python DSL.
"""

from __future__ import annotations

import math
from typing import List

from deequ_tpu_torch.analyzers.scan import DataTypeInstances
from deequ_tpu_torch.checks.check import is_one
from deequ_tpu_torch.constraints.constrainable_data_types import ConstrainableDataTypes
from deequ_tpu_torch.constraints import constraint as C
from deequ_tpu_torch.profiles.column_profile import ColumnProfile, NumericColumnProfile
from deequ_tpu_torch.suggestions.suggestion import ConstraintSuggestion

NULL_FIELD_REPLACEMENT = "NullValue"


def _floor_2dp(value: float) -> float:
    """BigDecimal.setScale(2, DOWN) (reference: RetainCompletenessRule.scala:41)."""
    return math.floor(value * 100) / 100


class ConstraintRule:
    rule_description: str = ""

    def should_be_applied(self, profile: ColumnProfile, num_records: int) -> bool:
        raise NotImplementedError

    def candidate(self, profile: ColumnProfile, num_records: int) -> ConstraintSuggestion:
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"{type(self).__name__}()"


class CompleteIfCompleteRule(ConstraintRule):
    rule_description = (
        "If a column is complete in the sample, we suggest a NOT NULL constraint"
    )

    def should_be_applied(self, profile, num_records) -> bool:
        return profile.completeness == 1.0

    def candidate(self, profile, num_records) -> ConstraintSuggestion:
        constraint = C.completeness_constraint(profile.column, is_one)
        return ConstraintSuggestion(
            constraint,
            profile.column,
            f"Completeness: {profile.completeness}",
            f"'{profile.column}' is not null",
            self,
            f'.is_complete("{profile.column}")',
        )


class RetainCompletenessRule(ConstraintRule):
    rule_description = (
        "If a column is incomplete in the sample, we model its completeness "
        "as a binomial variable, estimate a confidence interval and use this "
        "to define a lower bound for the completeness"
    )

    def should_be_applied(self, profile, num_records) -> bool:
        return 0.2 < profile.completeness < 1.0

    def candidate(self, profile, num_records) -> ConstraintSuggestion:
        p = profile.completeness
        n = max(num_records, 1)
        z = 1.96
        target = _floor_2dp(p - z * math.sqrt(p * (1 - p) / n))
        constraint = C.completeness_constraint(
            profile.column, lambda v, t=target: v >= t
        )
        bound_pct = int((1.0 - target) * 100)
        return ConstraintSuggestion(
            constraint,
            profile.column,
            f"Completeness: {profile.completeness}",
            f"'{profile.column}' has less than {bound_pct}% missing values",
            self,
            f'.has_completeness("{profile.column}", lambda v: v >= {target}, '
            f'hint="It should be above {target}!")',
        )


class RetainTypeRule(ConstraintRule):
    rule_description = "If we detect a non-string type, we suggest a type constraint"

    def should_be_applied(self, profile, num_records) -> bool:
        testable = profile.data_type in (
            DataTypeInstances.INTEGRAL,
            DataTypeInstances.FRACTIONAL,
            DataTypeInstances.BOOLEAN,
        )
        return profile.is_data_type_inferred and testable

    def candidate(self, profile, num_records) -> ConstraintSuggestion:
        type_to_check = {
            DataTypeInstances.FRACTIONAL: ConstrainableDataTypes.FRACTIONAL,
            DataTypeInstances.INTEGRAL: ConstrainableDataTypes.INTEGRAL,
            DataTypeInstances.BOOLEAN: ConstrainableDataTypes.BOOLEAN,
        }[profile.data_type]
        constraint = C.data_type_constraint(profile.column, type_to_check, is_one)
        return ConstraintSuggestion(
            constraint,
            profile.column,
            f"DataType: {profile.data_type}",
            f"'{profile.column}' has type {profile.data_type}",
            self,
            f'.has_data_type("{profile.column}", ConstrainableDataTypes.'
            f"{type_to_check.name})",
        )


class CategoricalRangeRule(ConstraintRule):
    rule_description = (
        "If we see a categorical range for a column, we suggest an IS IN (...) constraint"
    )

    def should_be_applied(self, profile, num_records) -> bool:
        if profile.histogram is None or profile.data_type != DataTypeInstances.STRING:
            return False
        entries = profile.histogram.values
        if not entries:
            return False
        num_unique = sum(1 for v in entries.values() if v.absolute == 1)
        return num_unique / len(entries) <= 0.1

    def candidate(self, profile, num_records) -> ConstraintSuggestion:
        by_popularity = sorted(
            (
                (key, value)
                for key, value in profile.histogram.values.items()
                if key != NULL_FIELD_REPLACEMENT
            ),
            key=lambda kv: kv[1].absolute,
            reverse=True,
        )
        categories_sql = ", ".join(
            "'" + key.replace("'", "''") + "'" for key, _ in by_popularity
        )
        categories_code = ", ".join(
            '"' + key.replace("\\", "\\\\").replace('"', '\\"') + '"'
            for key, _ in by_popularity
        )
        description = f"'{profile.column}' has value range {categories_sql}"
        column_condition = f"`{profile.column}` IN ({categories_sql})"
        constraint = C.compliance_constraint(description, column_condition, is_one)
        return ConstraintSuggestion(
            constraint,
            profile.column,
            "Compliance: 1",
            description,
            self,
            f'.is_contained_in("{profile.column}", [{categories_code}])',
        )


class FractionalCategoricalRangeRule(ConstraintRule):
    def __init__(self, target_data_coverage_fraction: float = 0.9):
        self.target_data_coverage_fraction = target_data_coverage_fraction

    rule_description = (
        "If we see a categorical range for most values in a column, we "
        "suggest an IS IN (...) constraint that should hold for most values"
    )

    def _top_categories(self, profile):
        sorted_values = sorted(
            profile.histogram.values.items(), key=lambda kv: kv[1].ratio, reverse=True
        )
        coverage = 0.0
        out = {}
        for key, value in sorted_values:
            if coverage < self.target_data_coverage_fraction:
                coverage += value.ratio
                out[key] = value
        return out

    def should_be_applied(self, profile, num_records) -> bool:
        if profile.histogram is None or profile.data_type != DataTypeInstances.STRING:
            return False
        entries = profile.histogram.values
        if not entries:
            return False
        num_unique = sum(1 for v in entries.values() if v.absolute == 1)
        unique_ratio = num_unique / len(entries)
        top = self._top_categories(profile)
        ratio_sums = sum(v.ratio for v in top.values())
        return unique_ratio <= 0.4 and ratio_sums < 1

    def candidate(self, profile, num_records) -> ConstraintSuggestion:
        top = self._top_categories(profile)
        ratio_sums = sum(v.ratio for v in top.values())
        by_popularity = sorted(
            ((k, v) for k, v in top.items() if k != NULL_FIELD_REPLACEMENT),
            key=lambda kv: kv[1].absolute,
            reverse=True,
        )
        categories_sql = ", ".join(
            "'" + key.replace("'", "''") + "'" for key, _ in by_popularity
        )
        categories_code = ", ".join(
            '"' + key.replace("\\", "\\\\").replace('"', '\\"') + '"'
            for key, _ in by_popularity
        )
        p = ratio_sums
        n = max(num_records, 1)
        z = 1.96
        target = _floor_2dp(p - z * math.sqrt(p * (1 - p) / n))
        description = (
            f"'{profile.column}' has value range {categories_sql} for at "
            f"least {target * 100}% of values"
        )
        column_condition = f"`{profile.column}` IN ({categories_sql})"
        hint = f"It should be above {target}!"
        constraint = C.compliance_constraint(
            description, column_condition, lambda v, t=target: v >= t, hint=hint
        )
        return ConstraintSuggestion(
            constraint,
            profile.column,
            f"Compliance: {ratio_sums}",
            description,
            self,
            f'.is_contained_in("{profile.column}", [{categories_code}], '
            f'lambda v: v >= {target}, hint="{hint}")',
        )

    def __repr__(self) -> str:
        return f"FractionalCategoricalRangeRule({self.target_data_coverage_fraction})"


class NonNegativeNumbersRule(ConstraintRule):
    rule_description = (
        "If we see only non-negative numbers in a column, we suggest a "
        "corresponding constraint"
    )

    def should_be_applied(self, profile, num_records) -> bool:
        return (
            isinstance(profile, NumericColumnProfile)
            and profile.minimum is not None
            and profile.minimum >= 0.0
        )

    def candidate(self, profile, num_records) -> ConstraintSuggestion:
        description = f"'{profile.column}' has no negative values"
        constraint = C.compliance_constraint(
            description, f"{profile.column} >= 0", is_one
        )
        minimum = (
            str(profile.minimum)
            if isinstance(profile, NumericColumnProfile) and profile.minimum is not None
            else "Error while calculating minimum!"
        )
        return ConstraintSuggestion(
            constraint,
            profile.column,
            f"Minimum: {minimum}",
            description,
            self,
            f'.is_non_negative("{profile.column}")',
        )


class UniqueIfApproximatelyUniqueRule(ConstraintRule):
    rule_description = (
        "If the ratio of approximate num distinct values in a column is "
        "close to the number of records (within the error of the HLL "
        "sketch), we suggest a UNIQUE constraint"
    )

    def should_be_applied(self, profile, num_records) -> bool:
        if num_records == 0:
            return False
        approx_distinctness = profile.approximate_num_distinct_values / num_records
        return profile.completeness == 1.0 and abs(1.0 - approx_distinctness) <= 0.08

    def candidate(self, profile, num_records) -> ConstraintSuggestion:
        constraint = C.uniqueness_constraint([profile.column], is_one)
        approx_distinctness = profile.approximate_num_distinct_values / max(num_records, 1)
        return ConstraintSuggestion(
            constraint,
            profile.column,
            f"ApproxDistinctness: {approx_distinctness}",
            f"'{profile.column}' is unique",
            self,
            f'.is_unique("{profile.column}")',
        )


def DEFAULT_RULES() -> List[ConstraintRule]:
    """reference: ConstraintSuggestionRunner.scala:29-35 — 6 of the 8 rules
    (UniqueIfApproximatelyUnique and the non-default variant excluded)."""
    return [
        CompleteIfCompleteRule(),
        RetainCompletenessRule(),
        RetainTypeRule(),
        CategoricalRangeRule(),
        FractionalCategoricalRangeRule(),
        NonNegativeNumbersRule(),
    ]


class Rules:
    """Reference-shaped access: `Rules.DEFAULT`
    (reference: suggestions/ConstraintSuggestionRunner.scala:29-35).
    Rules are stateless, so sharing the instances is safe; the tuple
    keeps the default set immutable."""

    DEFAULT = tuple(DEFAULT_RULES())
