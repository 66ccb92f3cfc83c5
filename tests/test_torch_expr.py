"""The port's SQL predicate engine against the JAX package's, expression
by expression, over one seeded table with NULLs in every column: the
values, the NULL masks and the WHERE mask (NULL -> False) must be equal.
Both evaluate on the host in float64, so numbers compare exactly."""

from __future__ import annotations

import numpy as np
import pytest

from deequ_tpu.data.expr import Predicate as JPredicate
from deequ_tpu.data.table import Table as JTable
from deequ_tpu_torch.analyzers.base import where_spec
from deequ_tpu_torch.data.expr import ExpressionParseError, Predicate
from deequ_tpu_torch.data.table import Table as PTable

PREDICATES = [
    # NULL tests
    "x IS NULL",
    "x IS NOT NULL AND s IS NULL",
    "ISNULL(s) OR ISNOTNULL(b)",
    # comparisons and three-valued logic
    "x > 0",
    "x >= 0 AND n < 3",
    "x > 0 OR n = 2",
    "NOT (x > 0)",
    "NOT (x > 0 AND s = 'a')",
    "(x > 0 OR s = 'b') AND NOT n != 1",
    "x = NULL OR TRUE",
    "x = NULL AND FALSE",
    "b = TRUE",
    "s <> 'c'",
    "n == 1",
    # IN / BETWEEN / LIKE / RLIKE
    "s IN ('a', 'b')",
    "s NOT IN ('a', NULL)",
    "n IN (1, 2.0, 7)",
    "x BETWEEN -1 AND 1.5",
    "x NOT BETWEEN 0 AND 2",
    "s LIKE 'a%'",
    "s LIKE '_b%'",
    "s NOT LIKE '%c'",
    "s RLIKE '^[ab]+$'",
    "`s` IS NULL OR `s` IN ('a','b')",
    # arithmetic, coercion, division by zero
    "x * 2 + n - 1 > 3",
    "x / n > 1",
    "n % 2 = 1",
    "-x < 0",
    "num > 1.5",
    "num + 1 >= 2",
    "x / 0 IS NULL",
    # CASE and functions
    "CASE WHEN x > 0 THEN 'pos' WHEN x < 0 THEN 'neg' ELSE 'zero' END = 'pos'",
    "CASE WHEN s = 'a' THEN n END > 1",
    "COALESCE(x, 0.0) >= 0",
    "COALESCE(s, 'none') = 'none'",
    "ABS(x) < 1",
    "LENGTH(s) = 2",
    "UPPER(s) = 'AB'",
    "LOWER(TRIM(t)) = 'hi'",
]


@pytest.fixture(scope="module")
def tables():
    rng = np.random.default_rng(21)
    n = 400
    x = rng.normal(0.5, 1.5, n)
    x[::7] = np.nan
    strings = np.array(["a", "b", "ab", "ca", "c", None], dtype=object)
    numbers = np.array(["1", "2.5", "x", " 3 ", "1e1", None], dtype=object)
    texts = np.array([" Hi ", "hi", "HI", "ho", None], dtype=object)
    bools = np.array([True, False, None], dtype=object)
    data = {
        "x": x,
        "n": rng.integers(0, 4, n),
        "s": strings[rng.integers(0, len(strings), n)],
        "num": numbers[rng.integers(0, len(numbers), n)],
        "t": texts[rng.integers(0, len(texts), n)],
        "b": bools[rng.integers(0, len(bools), n)],
    }
    return JTable.from_numpy(data), PTable.from_numpy(data)


@pytest.mark.parametrize("expression", PREDICATES)
def test_predicate_equals_jax(tables, expression):
    jt, pt = tables
    jv, jn, jkind = JPredicate(expression).eval(jt)
    pv, pn, pkind = Predicate(expression).eval(pt)
    assert pkind == jkind
    np.testing.assert_array_equal(pn, jn)
    live = ~np.asarray(jn)
    np.testing.assert_array_equal(np.asarray(pv)[live], np.asarray(jv)[live])
    np.testing.assert_array_equal(
        Predicate(expression).eval_mask(pt), JPredicate(expression).eval_mask(jt)
    )


@pytest.mark.parametrize("expression", ["x >", "x IN (1", "s LIKE x", "FOO(x) > 1", "x ! 1"])
def test_bad_expressions_raise(tables, expression):
    _, pt = tables
    with pytest.raises(ExpressionParseError):
        Predicate(expression).eval(pt)


def test_where_spec_is_the_predicate_mask(tables):
    _, pt = tables
    spec = where_spec("x > 0 AND s IS NOT NULL")
    np.testing.assert_array_equal(
        spec.build(pt), Predicate("x > 0 AND s IS NOT NULL").eval_mask(pt)
    )
    assert where_spec(None).build(pt).all()


def test_referenced_columns(tables):
    assert Predicate("x > n AND COALESCE(s, t) = 'a'").referenced_columns() == ["x", "n", "s", "t"]
