"""Differential suite: the static typechecker's verdicts must agree with
real evaluation. For every predicate in the
test_expr_differential.py corpus (and an expression zoo on top):

* the statically inferred kind equals the evaluator's Series kind;
* static nullable=False implies the evaluated null mask is all-False
  (the conservative direction: static may over-report nullability,
  never under-report).

Port-mapped from tests/test_lint_static_vs_eval.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pytest

from deequ_tpu_torch.data.expr import _eval, parse
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.lint import SchemaInfo, analyze_ast

pytestmark = pytest.mark.usefixtures("cpu_default")

OPS = [">", ">=", "<", "<=", "=", "!="]


def _check(expression: str, table: Table) -> None:
    schema = SchemaInfo.from_table(table)
    ast = parse(expression)
    typed, _diags = analyze_ast(ast, schema, source=expression)
    _values, null, kind = _eval(ast, table, table.num_rows)
    assert typed.kind == kind, (
        f"{expression!r}: static kind {typed.kind} != eval kind {kind}"
    )
    if not typed.nullable:
        assert not null.any(), (
            f"{expression!r}: static says non-nullable but eval produced "
            f"{int(null.sum())} NULL row(s)"
        )


def _corpus_table(rng: np.random.Generator, n: int) -> Table:
    a = rng.integers(-5, 5, n).astype(float)
    a[rng.random(n) < 0.2] = np.nan
    b = rng.integers(-5, 5, n).astype(float)
    s = np.array(["x", "y", "zz", None], dtype=object)[rng.integers(0, 4, n)]
    return Table.from_pydict({"a": list(a), "b": list(b), "s": list(s)})


@pytest.mark.parametrize("seed", range(40))
def test_random_predicates_static_matches_eval(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    table = _corpus_table(rng, n)

    op = rng.choice(OPS)
    lit = int(rng.integers(-5, 5))
    conj = rng.choice(["AND", "OR"])
    op2 = rng.choice([">", "<"])
    _check(f"a {op} {lit} {conj} b {op2} 0", table)


@pytest.mark.parametrize("seed", range(0, 40, 5))
def test_in_list_and_is_null_static_matches_eval(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 150))
    table = _corpus_table(rng, n)
    _check("s IN ('x','zz') OR a IS NULL", table)
    _check("s IS NOT NULL AND a >= 0", table)


EXPRESSION_ZOO = [
    # arithmetic
    "a + b",
    "b * 2",
    "b - 1",
    "b / 2",
    "b / 0",
    "b % 3",
    "-b",
    # comparisons and logic
    "b > 0",
    "b > 0 AND b < 10",
    "b > 0 OR a > 0",
    "NOT (b > 0)",
    "a BETWEEN -2 AND 2",
    "b BETWEEN -2 AND 2",
    # null handling
    "a IS NULL",
    "a IS NOT NULL",
    "s IS NULL",
    "COALESCE(a, 0)",
    "COALESCE(a, b)",
    "COALESCE(s, 'none')",
    # strings
    "s",
    "s LIKE 'z%'",
    "s RLIKE '^z+$'",
    "LENGTH(s)",
    "LOWER(s)",
    "UPPER(s) = 'X'",
    "TRIM(s)",
    "s IN ('x', 'y')",
    "b IN (1, 2, 3)",
    # functions
    "ABS(b)",
    "ABS(a)",
    "ISNULL(a)",
    "ISNOTNULL(a)",
    # case
    "CASE WHEN b > 0 THEN 1 ELSE 0 END",
    "CASE WHEN b > 0 THEN 1 END",
    "CASE WHEN b > 0 THEN 'pos' ELSE 'neg' END",
    # literals
    "1 + 2",
    "TRUE",
    "NULL",
    "'abc'",
]


@pytest.mark.parametrize("expression", EXPRESSION_ZOO)
def test_expression_zoo_static_matches_eval(expression):
    rng = np.random.default_rng(7)
    table = _corpus_table(rng, 64)
    _check(expression, table)


@pytest.mark.parametrize("expression", EXPRESSION_ZOO)
def test_expression_zoo_on_null_free_table(expression):
    # no-null columns: static sees nullable=False fields, which makes the
    # "static non-nullable => eval has no NULLs" direction bite hardest
    rng = np.random.default_rng(11)
    n = 64
    table = Table.from_pydict(
        {
            "a": list(rng.integers(-5, 5, n).astype(float)),
            "b": list(rng.integers(-5, 5, n).astype(float)),
            "s": list(np.array(["x", "y", "zz"], dtype=object)[
                rng.integers(0, 3, n)
            ]),
        }
    )
    _check(expression, table)
