"""Plan-time semantic analyzer: typed expression checking, constraint-plan
linting, and fail-fast diagnostics — all with zero data scans.

The Catalyst-analysis analogue (see README "Plan validation"): resolve
columns, infer dtypes/nullability with Kleene semantics, and reject
impossible plans before any kernel dispatch. The port's copy of
deequ_tpu/lint; its cost model (lint/cost.py) replays the port's own
planner and wire format.
"""

from deequ_tpu_torch.lint.cost import (
    FamilyGroupCost,
    PassCost,
    PlanCost,
    analyze_plan,
)
from deequ_tpu_torch.lint.diagnostics import (
    CODES,
    Diagnostic,
    LintReport,
    PlanValidationError,
    Severity,
)
from deequ_tpu_torch.lint.effects import AnalyzerEffect, scan_effects
from deequ_tpu_torch.lint.explain import (
    ExplainResult,
    cost_diagnostics,
    explain,
    explain_plan,
    render_explain,
)
from deequ_tpu_torch.lint.fold import const_fold, fold_to_constant, satisfiability
from deequ_tpu_torch.lint.interval import Interval
from deequ_tpu_torch.lint.pushdown import (
    ColumnStats,
    PredicatePrune,
    PrunePlan,
    RowGroupStats,
    build_prune_plan,
)
from deequ_tpu_torch.lint.planlint import (
    lint_analyzer,
    lint_expression_use,
    lint_plan,
    validate_plan,
)
from deequ_tpu_torch.lint.schema import FieldInfo, SchemaInfo
from deequ_tpu_torch.lint.subsume import (
    PlanEnv,
    SubsumptionProof,
    prove_subsumption,
    wheres_equivalent,
)
from deequ_tpu_torch.lint.typecheck import TypedExpr, analyze_ast, analyze_expression

__all__ = [
    "CODES",
    "Diagnostic",
    "LintReport",
    "PlanValidationError",
    "Severity",
    "FieldInfo",
    "SchemaInfo",
    "TypedExpr",
    "analyze_ast",
    "analyze_expression",
    "const_fold",
    "fold_to_constant",
    "satisfiability",
    "lint_analyzer",
    "lint_expression_use",
    "lint_plan",
    "validate_plan",
    "AnalyzerEffect",
    "ColumnStats",
    "ExplainResult",
    "FamilyGroupCost",
    "Interval",
    "PassCost",
    "PlanCost",
    "PlanEnv",
    "PredicatePrune",
    "PrunePlan",
    "RowGroupStats",
    "SubsumptionProof",
    "analyze_plan",
    "build_prune_plan",
    "cost_diagnostics",
    "explain",
    "explain_plan",
    "prove_subsumption",
    "render_explain",
    "scan_effects",
    "wheres_equivalent",
]
