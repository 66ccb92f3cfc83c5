"""SQL predicate-engine edge cases: Kleene NULL logic, LIKE escapes,
IN with NULLs, CASE, arithmetic null propagation — the spec is Spark SQL
semantics (reference: the reference feeds all predicates through Spark,
e.g. Compliance analyzers/Compliance.scala:37 and the NULL-coalescing
isNonNegative predicate checks/Check.scala:676).

Port-mapped from tests/test_expr_edge_cases.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pytest

from deequ_tpu_torch.data.expr import Predicate, eval_predicate
from deequ_tpu_torch.data.table import Table

pytestmark = pytest.mark.usefixtures("cpu_default")


def tbl(**cols) -> Table:
    return Table.from_numpy(
        {
            k: (np.array(v, dtype=object) if any(x is None or isinstance(x, str) for x in v) else np.array(v))
            for k, v in cols.items()
        }
    )


def mask(expr: str, table: Table):
    return eval_predicate(expr, table).tolist()


class TestKleeneLogic:
    """Three-valued logic: NULL propagates through comparisons; AND/OR
    short-circuit per Kleene; the final row mask treats NULL as False."""

    def test_true_or_null_is_true(self):
        t = tbl(a=[1.0, 1.0], b=[None, 2.0])
        # a = 1 is TRUE for both rows; b > 1 is NULL for row 0
        assert mask("a = 1 OR b > 1", t) == [True, True]

    def test_false_or_null_is_null(self):
        t = tbl(a=[0.0, 0.0], b=[None, 2.0])
        assert mask("a = 1 OR b > 1", t) == [False, True]

    def test_false_and_null_is_false_negated(self):
        t = tbl(a=[0.0], b=[None])
        # FALSE AND NULL = FALSE, so NOT(...) = TRUE
        assert mask("NOT (a = 1 AND b > 1)", t) == [True]

    def test_true_and_null_is_null(self):
        t = tbl(a=[1.0], b=[None])
        assert mask("a = 1 AND b > 1", t) == [False]  # NULL -> excluded

    def test_not_null_is_null(self):
        t = tbl(b=[None, 0.0])
        assert mask("NOT (b > 1)", t) == [False, True]

    def test_null_comparisons_propagate(self):
        t = tbl(a=[None, 1.0])
        for expr in ("a = 1", "a != 1", "a < 1", "a >= 1"):
            assert mask(expr, t)[0] is np.False_ or mask(expr, t)[0] is False

    def test_is_null_and_is_not_null(self):
        t = tbl(a=[None, 1.0])
        assert mask("a IS NULL", t) == [True, False]
        assert mask("a IS NOT NULL", t) == [False, True]

    def test_null_equality_is_not_true_for_two_nulls(self):
        t = tbl(a=[None], b=[None])
        assert mask("a = b", t) == [False]


class TestInAndBetween:
    def test_in_list_with_null_value(self):
        t = tbl(s=["a", None, "c"])
        assert mask("s IN ('a', 'b')", t) == [True, False, False]

    def test_not_in_with_null_is_null(self):
        t = tbl(s=["a", None, "c"])
        # NULL NOT IN (...) is NULL -> excluded
        assert mask("s NOT IN ('a', 'b')", t) == [False, False, True]

    def test_between_inclusive(self):
        t = tbl(x=[0.0, 1.0, 5.0, 7.0, 8.0, None])
        assert mask("x BETWEEN 1 AND 7", t) == [False, True, True, True, False, False]

    def test_not_between(self):
        t = tbl(x=[0.0, 5.0, None])
        assert mask("x NOT BETWEEN 1 AND 7", t) == [True, False, False]


class TestLike:
    def test_percent_wildcard(self):
        t = tbl(s=["hello", "help", "shell", None])
        assert mask("s LIKE 'hel%'", t) == [True, True, False, False]
        assert mask("s LIKE '%ell%'", t) == [True, False, True, False]

    def test_underscore_wildcard(self):
        t = tbl(s=["cat", "cut", "coat"])
        assert mask("s LIKE 'c_t'", t) == [True, True, False]

    def test_regex_metacharacters_are_literal_in_like(self):
        # '.' and '*' and '(' must NOT act as regex in LIKE patterns
        t = tbl(s=["a.b", "axb", "a*b", "a(b"])
        assert mask("s LIKE 'a.b'", t) == [True, False, False, False]
        assert mask("s LIKE 'a*b'", t) == [False, False, True, False]
        assert mask("s LIKE 'a(b'", t) == [False, False, False, True]

    def test_rlike_is_regex(self):
        t = tbl(s=["a.b", "axb"])
        assert mask("s RLIKE 'a.b'", t) == [True, True]

    def test_not_like(self):
        t = tbl(s=["hello", "world", None])
        assert mask("s NOT LIKE 'hel%'", t) == [False, True, False]


class TestCaseAndFunctions:
    def test_case_when(self):
        t = tbl(x=[1.0, 5.0, None])
        assert mask("CASE WHEN x > 2 THEN TRUE ELSE FALSE END", t) == [
            False, True, False,
        ]

    def test_coalesce_null_fill(self):
        t = tbl(x=[None, -1.0, 3.0])
        # the isNonNegative predicate shape (reference: Check.scala:676)
        assert mask("COALESCE(x, 0.0) >= 0", t) == [True, False, True]

    def test_arithmetic_null_propagation(self):
        t = tbl(a=[1.0, None], b=[2.0, 2.0])
        assert mask("a + b > 2", t) == [True, False]
        assert mask("a * b = 2", t) == [True, False]

    def test_division_and_comparison(self):
        t = tbl(a=[4.0, 9.0], b=[2.0, 3.0])
        assert mask("a / b = 2", t) == [True, False]


class TestStringAndQuoting:
    def test_escaped_single_quote_literal(self):
        t = tbl(s=["it's", "its"])
        assert mask("s = 'it''s'", t) == [True, False]

    def test_backtick_column_with_spaces_and_dots(self):
        t = Table.from_numpy(
            {"att.1 with space": np.array(["a", "b"], dtype=object)}
        )
        assert mask("`att.1 with space` = 'a'", t) == [True, False]

    def test_string_comparison_lexicographic(self):
        t = tbl(s=["apple", "banana"])
        assert mask("s < 'b'", t) == [True, False]


class TestErrors:
    def test_unknown_column_raises(self):
        t = tbl(a=[1.0])
        with pytest.raises(Exception):
            eval_predicate("nope > 1", t)

    def test_parse_error_raises(self):
        t = tbl(a=[1.0])
        with pytest.raises(Exception):
            Predicate("a >>> 1").eval_mask(t)


class TestMasksOwnTheirRows:
    """A row mask from `eval_mask` is right over columns with and without
    nulls, literals and their combinations, and is an array of its own:
    writable, and never a view of a literal or of the column's backing."""

    CASES = [
        ("true", [True, True, True]),
        ("false OR b", [True, False, True]),
        ("b", [True, False, True]),
        ("x < 2", [True, False, False]),
        ("x >= 2 AND x < 3", [False, True, False]),
        ("x < 2 OR x > 2", [True, False, True]),
        ("y < 2", [True, False, False]),
        ("y >= 1 AND y < 3", [True, False, False]),
        ("NOT (y < 2)", [False, False, True]),
        ("x IN (1, 3)", [True, False, True]),
        ("s = 'a' AND x < 3", [True, False, False]),
    ]

    @pytest.mark.parametrize("expr,expected", CASES)
    def test_mask(self, expr, expected):
        t = Table.from_numpy(
            {
                "x": np.array([1, 2, 3], dtype=np.int64),
                "y": np.array([1.0, np.nan, 3.0]),
                "b": np.array([True, False, True]),
                "s": np.array(["a", "b", "a"], dtype=object),
            }
        )
        out = Predicate(expr).eval_mask(t)
        assert out.tolist() == expected
        assert out.flags.writeable and out.flags.owndata
        out[:] = False  # the table's own columns stay as they were
        assert t.column("b").values.tolist() == [True, False, True]
