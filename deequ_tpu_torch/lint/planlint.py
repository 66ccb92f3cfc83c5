"""Plan linting: static analysis over Check/Analysis plans.

Runs before any scan, against a `SchemaInfo` only:

* per-analyzer: unresolved columns (DQ101, with did-you-mean), static
  precondition failures — wrong column types, bad parameters — via the
  analyzers' own `preconditions()` run on a ZERO-ROW schema table
  (DQ102/DQ110), expression problems in `where`/Compliance predicates
  (DQ100..DQ105), invalid PatternMatch regexes (DQ103);
* per-predicate: constant-foldable filters (DQ205), unsatisfiable or
  NULL-escape-only predicates (DQ204);
* cross-plan: duplicate analyzers (DQ202), contradictory must-hold
  constraints like isComplete(c) + satisfies("c IS NULL") (DQ203), and
  where-clauses that are semantically identical but textually different,
  which silently split the fused-scan batching groups (DQ206).

The port's copy of deequ_tpu/lint/planlint.py.
"""

from __future__ import annotations

import re as _re
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

from deequ_tpu_torch.core.exceptions import (
    NoSuchColumnException,
    WrongColumnTypeException,
)
from deequ_tpu_torch.data.expr import (
    Bin,
    Col,
    ExpressionParseError,
    IsNull,
    Node,
    normalize_expression,
    parse,
)
from deequ_tpu_torch.lint.diagnostics import Diagnostic, LintReport, Severity
from deequ_tpu_torch.lint.fold import fold_to_constant, satisfiability
from deequ_tpu_torch.lint.schema import SchemaInfo
from deequ_tpu_torch.lint.typecheck import analyze_expression

_MAX_PAIRWISE_PREDICATES = 32


def _analyzer_columns(analyzer) -> List[str]:
    cols: List[str] = []
    col = getattr(analyzer, "column", None)
    if isinstance(col, str):
        cols.append(col)
    for attr in ("first_column", "second_column"):
        v = getattr(analyzer, attr, None)
        if isinstance(v, str):
            cols.append(v)
    multi = getattr(analyzer, "columns", None)
    if isinstance(multi, (list, tuple)):
        cols.extend(c for c in multi if isinstance(c, str))
    return cols


def lint_expression_use(
    expression: str,
    schema: SchemaInfo,
    subject: Optional[str] = None,
    role: str = "predicate",
) -> List[Diagnostic]:
    """Full static pass over one expression string: parse + typecheck +
    constant-fold + satisfiability."""
    typed, diags = analyze_expression(expression, schema)
    for d in diags:
        d.subject = subject
    if typed is None:
        return diags

    if typed.kind == "str":
        diags.append(
            Diagnostic(
                "DQ102",
                Severity.WARNING,
                f"{role} evaluates to a string, not a boolean",
                source=expression,
                subject=subject,
            )
        )

    # skip fold/sat when the expression has unresolved columns — verdicts
    # against a half-resolved tree would be noise on top of the DQ101s
    if any(d.code == "DQ101" for d in diags):
        return diags

    try:
        ast = parse(expression)
    except ExpressionParseError:
        return diags

    folded = fold_to_constant(ast)
    if folded is not None:
        _, value = folded
        truth = value is not None and bool(value)
        if truth:
            diags.append(
                Diagnostic(
                    "DQ205",
                    Severity.WARNING,
                    f"{role} is constant TRUE — it never filters or fails "
                    "anything",
                    source=expression,
                    subject=subject,
                )
            )
        else:
            diags.append(
                Diagnostic(
                    "DQ204",
                    Severity.ERROR,
                    f"{role} is constant "
                    f"{'NULL' if value is None else 'FALSE'} — no row can "
                    "ever satisfy it",
                    source=expression,
                    subject=subject,
                )
            )
        return diags

    verdict = satisfiability(ast, schema)
    if verdict == "unsat":
        diags.append(
            Diagnostic(
                "DQ204",
                Severity.ERROR,
                f"{role} is unsatisfiable — no row can ever satisfy it",
                source=expression,
                subject=subject,
            )
        )
    elif verdict == "null-only":
        diags.append(
            Diagnostic(
                "DQ204",
                Severity.ERROR,
                f"{role} is satisfiable only by NULL rows — its non-NULL "
                "range is empty (check the bounds)",
                source=expression,
                subject=subject,
            )
        )
    return diags


def lint_analyzer(analyzer, schema: SchemaInfo) -> List[Diagnostic]:
    diags: List[Diagnostic] = []
    subject = repr(analyzer)

    missing: List[str] = []
    for col in _analyzer_columns(analyzer):
        if not schema.has(col):
            missing.append(col)
            diags.append(
                Diagnostic(
                    "DQ101",
                    Severity.ERROR,
                    f"unresolved column {col!r}",
                    subject=subject,
                    suggestion=schema.suggest(col),
                )
            )

    # run the analyzer's own preconditions against a zero-row table with
    # this schema: wrong-type and bad-parameter failures surface with the
    # exact same exception text a real scan would produce, but statically
    try:
        empty = schema.empty_table()
        for check in analyzer.preconditions():
            try:
                check(empty)
            except NoSuchColumnException:
                continue  # already reported as DQ101 above
            except WrongColumnTypeException as e:
                diags.append(
                    Diagnostic(
                        "DQ102", Severity.ERROR, str(e), subject=subject
                    )
                )
            except Exception as e:  # noqa: BLE001 — any precondition failure
                diags.append(
                    Diagnostic(
                        "DQ110", Severity.ERROR, str(e), subject=subject
                    )
                )
    except Exception:  # noqa: BLE001 — lint must never crash the run
        pass

    pattern = getattr(analyzer, "pattern", None)
    if isinstance(pattern, str):
        try:
            _re.compile(pattern)
        except _re.error as e:
            diags.append(
                Diagnostic(
                    "DQ103",
                    Severity.ERROR,
                    f"invalid pattern regex {pattern!r}: {e}",
                    subject=subject,
                )
            )

    predicate = getattr(analyzer, "predicate", None)
    if isinstance(predicate, str):
        diags.extend(
            lint_expression_use(
                predicate, schema, subject=subject, role="compliance predicate"
            )
        )

    where = getattr(analyzer, "where", None)
    if isinstance(where, str):
        diags.extend(
            lint_expression_use(where, schema, subject=subject, role="where filter")
        )

    return diags


# -- cross-plan checks -------------------------------------------------------


def _constraint_analyzers(checks: Sequence) -> List[Tuple[object, object]]:
    """(constraint, analyzer) pairs in plan order, decorators unwrapped."""
    from deequ_tpu_torch.constraints.constraint import (
        AnalysisBasedConstraint,
        ConstraintDecorator,
    )

    out = []
    for check in checks:
        for constraint in getattr(check, "constraints", []):
            inner = (
                constraint.inner
                if isinstance(constraint, ConstraintDecorator)
                else constraint
            )
            if isinstance(inner, AnalysisBasedConstraint):
                out.append((constraint, inner))
    return out


def _must_hold_predicates(
    checks: Sequence,
) -> List[Tuple[object, Optional[str], Node]]:
    """(constraint, where, predicate-AST) for constraints that assert the
    predicate holds on EVERY row: Compliance/Completeness with the
    default is-one assertion. Completeness(c) is `c IS NOT NULL`."""
    from deequ_tpu_torch.checks.check import is_one

    out = []
    for constraint, inner in _constraint_analyzers(checks):
        if inner.assertion is not is_one:
            continue
        analyzer = inner.analyzer
        predicate = getattr(analyzer, "predicate", None)
        where = getattr(analyzer, "where", None)
        if isinstance(predicate, str):
            try:
                out.append((constraint, where, parse(predicate)))
            except ExpressionParseError:
                continue
        elif type(analyzer).__name__ == "Completeness":
            column = getattr(analyzer, "column", None)
            if isinstance(column, str):
                out.append((constraint, where, IsNull(Col(column), negated=True)))
    return out


def lint_plan(
    schema: SchemaInfo,
    checks: Sequence = (),
    required_analyzers: Sequence = (),
) -> LintReport:
    report = LintReport()

    # gather analyzers in plan order: explicit ones, then per-constraint
    occurrences: List[object] = list(required_analyzers)
    occurrences.extend(a for _, a in
                       ((c, inner.analyzer) for c, inner in
                        _constraint_analyzers(checks)))

    seen = set()
    unique = []
    for a in occurrences:
        if a not in seen:
            seen.add(a)
            unique.append(a)

    for analyzer in unique:
        report.extend(lint_analyzer(analyzer, schema))

    # DQ202 — the runner dedupes these, but a duplicate usually means two
    # constraints were meant to differ and don't
    counts = Counter(occurrences)
    for analyzer, n in counts.items():
        if n > 1:
            report.extend(
                [
                    Diagnostic(
                        "DQ202",
                        Severity.WARNING,
                        f"analyzer requested {n} times; the duplicates share "
                        "one computation",
                        subject=repr(analyzer),
                    )
                ]
            )

    # DQ203 — pairwise conjunction of must-hold predicates per where-group
    must_hold = _must_hold_predicates(checks)
    if len(must_hold) <= _MAX_PAIRWISE_PREDICATES:
        by_where: Dict[Optional[str], List] = {}
        for item in must_hold:
            by_where.setdefault(item[1], []).append(item)
        for group in by_where.values():
            for i in range(len(group)):
                for j in range(i + 1, len(group)):
                    ci, _, pi = group[i]
                    cj, _, pj = group[j]
                    verdict = satisfiability(Bin("and", pi, pj), schema)
                    if verdict in ("unsat", "null-only"):
                        report.extend(
                            [
                                Diagnostic(
                                    "DQ203",
                                    Severity.ERROR,
                                    "contradictory constraints: "
                                    f"{ci!r} and {cj!r} cannot both hold "
                                    "on any row",
                                )
                            ]
                        )

    # DQ206 — semantically identical wheres with different spelling split
    # the fused-scan (where, cap, dtype) batching groups
    where_texts: Dict[str, set] = {}
    for analyzer in unique:
        where = getattr(analyzer, "where", None)
        if not isinstance(where, str):
            continue
        try:
            key = normalize_expression(where)
        except ExpressionParseError:
            continue
        where_texts.setdefault(key, set()).add(where)
    for key, texts in where_texts.items():
        if len(texts) > 1:
            rendered = ", ".join(repr(t) for t in sorted(texts))
            report.extend(
                [
                    Diagnostic(
                        "DQ206",
                        Severity.WARNING,
                        "where-clauses differ only by formatting and will "
                        f"not share one fused scan group: {rendered}",
                    )
                ]
            )

    return report


def resolve_validation_mode(mode: Optional[str]) -> str:
    """Explicit argument wins, then env DEEQU_TPU_VALIDATE, then lenient.
    Unknown values degrade to lenient — validation must never break a
    run because of a typo'd knob."""
    import os

    resolved = mode or os.environ.get("DEEQU_TPU_VALIDATE") or "lenient"
    resolved = resolved.strip().lower()
    if resolved not in ("strict", "lenient", "off"):
        return "lenient"
    return resolved


def validate_plan(
    schema: SchemaInfo,
    checks: Sequence = (),
    required_analyzers: Sequence = (),
    mode: str = "lenient",
    num_rows: Optional[int] = None,
    batch_size: Optional[int] = None,
    streaming: bool = False,
    stream_batch_rows: Optional[int] = None,
    row_groups: Optional[Sequence] = None,
    partitions: Optional[Sequence] = None,
    deadline_s: Optional[float] = None,
    sharing_with: Optional[Sequence] = None,
    device=None,
) -> LintReport:
    """Run the full static pass: semantic lints (DQ1xx/DQ2xx) plus the
    cost analyzer's performance lints (DQ3xx, lint/explain.py). The
    computed `PlanCost` is attached as `report.plan_cost`. mode:
    'strict' raises one aggregated PlanValidationError when any
    error-severity diagnostic exists (warnings ride along in it);
    'lenient' returns the report for the caller to attach; 'off' skips.

    `sharing_with` — the analyzer list of a candidate superset scan:
    runs the plan-subsumption prover (lint/subsume.py) and attaches the
    DQ321/DQ322 sharing diagnostics, exactly like the DQ31x lints.
    `device` is the run's device, whose placement the cost model
    replays."""
    from deequ_tpu_torch.lint.diagnostics import PlanValidationError

    if mode == "off":
        return LintReport()
    report = lint_plan(schema, checks, required_analyzers)
    try:
        from deequ_tpu_torch.lint.cost import analyze_plan
        from deequ_tpu_torch.lint.explain import _plan_analyzers, cost_diagnostics

        plan = _plan_analyzers(required_analyzers, checks)
        report.plan_cost = analyze_plan(
            plan,
            schema,
            num_rows=num_rows,
            batch_size=batch_size,
            streaming=streaming,
            stream_batch_rows=stream_batch_rows,
            row_groups=row_groups,
            partitions=partitions,
            deadline_s=deadline_s,
            device=device,
        )
        report.extend(cost_diagnostics(report.plan_cost, plan, schema))
        if sharing_with is not None:
            from deequ_tpu_torch.lint.explain import sharing_diagnostics
            from deequ_tpu_torch.lint.subsume import prove_subsumption

            proof = prove_subsumption(plan, list(sharing_with), schema)
            report.extend(sharing_diagnostics(proof, plan))
    except Exception:  # noqa: BLE001 — cost lint must never break a run
        report.plan_cost = None
    if mode == "strict" and report.errors:
        raise PlanValidationError(report.diagnostics)
    return report
