from deequ_tpu_torch.suggestions.rules import (
    DEFAULT_RULES,
    CategoricalRangeRule,
    CompleteIfCompleteRule,
    ConstraintRule,
    FractionalCategoricalRangeRule,
    NonNegativeNumbersRule,
    RetainCompletenessRule,
    RetainTypeRule,
    Rules,
    UniqueIfApproximatelyUniqueRule,
)
from deequ_tpu_torch.suggestions.suggestion import ConstraintSuggestion
from deequ_tpu_torch.suggestions.runner import (
    ConstraintSuggestionResult,
    ConstraintSuggestionRunner,
)


__all__ = [
    "Rules",
    "DEFAULT_RULES",
    "ConstraintRule",
    "CompleteIfCompleteRule",
    "RetainCompletenessRule",
    "RetainTypeRule",
    "CategoricalRangeRule",
    "FractionalCategoricalRangeRule",
    "NonNegativeNumbersRule",
    "UniqueIfApproximatelyUniqueRule",
    "ConstraintSuggestion",
    "ConstraintSuggestionResult",
    "ConstraintSuggestionRunner",
]
