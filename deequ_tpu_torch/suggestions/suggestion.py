"""ConstraintSuggestion model + JSON export.

reference: suggestions/ConstraintSuggestion.scala:25-115. The
`code_for_constraint` strings are Python DSL snippets (the reference emits
Scala snippets — same role, native surface).
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import TYPE_CHECKING, List

if TYPE_CHECKING:
    from deequ_tpu_torch.constraints.constraint import Constraint
    from deequ_tpu_torch.suggestions.rules import ConstraintRule


@dataclass
class ConstraintSuggestion:
    constraint: "Constraint"
    column_name: str
    current_value: str
    description: str
    suggesting_rule: "ConstraintRule"
    code_for_constraint: str


def _shared_properties(suggestion: ConstraintSuggestion) -> dict:
    return {
        "constraint_name": repr(suggestion.constraint),
        "column_name": suggestion.column_name,
        "current_value": suggestion.current_value,
        "description": suggestion.description,
        "suggesting_rule": repr(suggestion.suggesting_rule),
        "rule_description": suggestion.suggesting_rule.rule_description,
        "code_for_constraint": suggestion.code_for_constraint,
    }


def suggestions_to_json(suggestions: List[ConstraintSuggestion]) -> str:
    """reference: ConstraintSuggestion.scala:42+."""
    return json.dumps(
        {"constraint_suggestions": [_shared_properties(s) for s in suggestions]},
        indent=2,
    )


def evaluation_results_to_json(
    suggestions: List[ConstraintSuggestion], verification_result
) -> str:
    """Per-suggestion evaluation status on the held-out split; "Unknown"
    where no constraint result lines up (no split was evaluated, or fewer
    results than suggestions) — reference:
    ConstraintSuggestion.scala:61-100."""
    statuses: List[str] = []
    if verification_result is not None and verification_result.check_results:
        first_check = next(iter(verification_result.check_results.values()))
        statuses = [
            cr.status.name.capitalize() for cr in first_check.constraint_results
        ]
    out = []
    for i, suggestion in enumerate(suggestions):
        entry = _shared_properties(suggestion)
        entry["constraint_result_on_test_set"] = (
            statuses[i] if i < len(statuses) else "Unknown"
        )
        out.append(entry)
    return json.dumps({"constraint_suggestions": out}, indent=2)
