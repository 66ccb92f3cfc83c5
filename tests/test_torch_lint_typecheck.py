"""Typed expression analysis tests: every expression-level diagnostic
code (DQ100-DQ105) plus kind/nullability inference and source spans.

Port-mapped from tests/test_lint_typecheck.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

import pytest
from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

from deequ_tpu_torch.data.table import ColumnType
from deequ_tpu_torch.lint import (
    FieldInfo,
    SchemaInfo,
    Severity,
    analyze_expression,
)

pytestmark = pytest.mark.usefixtures("cpu_default")

SCHEMA = SchemaInfo(
    [
        FieldInfo("item", ColumnType.STRING, nullable=False),
        FieldInfo("att1", ColumnType.STRING, nullable=True),
        FieldInfo("count", ColumnType.LONG, nullable=True),
        FieldInfo("price", ColumnType.DOUBLE, nullable=True),
        FieldInfo("flag", ColumnType.BOOLEAN, nullable=False),
        FieldInfo("ts", ColumnType.TIMESTAMP, nullable=False),
    ]
)


def codes(diags):
    return [d.code for d in diags]


class TestKinds:
    def test_comparison_is_bool(self):
        typed, diags = analyze_expression("price > 1", SCHEMA)
        assert typed.kind == "bool"
        assert diags == []

    def test_numeric_column_kinds(self):
        for expr in ("count + 1", "price * 2", "ts"):
            typed, diags = analyze_expression(expr, SCHEMA)
            assert typed.kind == "num", expr
            assert diags == []

    def test_string_column_kind(self):
        typed, _ = analyze_expression("item", SCHEMA)
        assert typed.kind == "str"

    def test_bool_column_kind(self):
        typed, _ = analyze_expression("flag", SCHEMA)
        assert typed.kind == "bool"

    def test_non_nullable_comparison_not_nullable(self):
        typed, _ = analyze_expression("flag = TRUE", SCHEMA)
        assert typed.nullable is False

    def test_nullable_column_propagates(self):
        typed, _ = analyze_expression("price > 1", SCHEMA)
        assert typed.nullable is True

    def test_is_null_never_nullable(self):
        typed, _ = analyze_expression("price IS NULL", SCHEMA)
        assert typed.kind == "bool" and typed.nullable is False

    def test_division_is_nullable_unless_literal_nonzero(self):
        typed, _ = analyze_expression("1 / 2", SCHEMA)
        assert typed.nullable is False
        typed, _ = analyze_expression("1 / 0", SCHEMA)
        assert typed.nullable is True
        typed, _ = analyze_expression("1 % (price + 1)", SCHEMA)
        assert typed.nullable is True


class TestDQ100Parse:
    def test_unparseable_expression(self):
        typed, diags = analyze_expression("count > > 3", SCHEMA)
        assert typed is None
        assert codes(diags) == ["DQ100"]
        assert diags[0].severity == Severity.ERROR


class TestDQ101UnresolvedColumn:
    def test_unknown_column_is_error(self):
        typed, diags = analyze_expression("prce > 1", SCHEMA)
        assert codes(diags) == ["DQ101"]
        assert diags[0].severity == Severity.ERROR
        assert typed is not None  # recovery: analysis continues

    def test_did_you_mean_suggestion(self):
        _, diags = analyze_expression("prce > 1", SCHEMA)
        assert diags[0].suggestion == "price"

    def test_span_points_at_the_column(self):
        source = "1 + prce > 1"
        _, diags = analyze_expression(source, SCHEMA)
        a, b = diags[0].span
        assert source[a:b] == "prce"

    def test_rendered_with_caret(self):
        _, diags = analyze_expression("prce > 1", SCHEMA)
        rendered = diags[0].render()
        assert "prce > 1" in rendered
        assert "^^^^" in rendered
        assert "did you mean 'price'" in rendered


class TestDQ102TypeMismatch:
    def test_bool_vs_num_comparison_warns(self):
        _, diags = analyze_expression("flag > 1", SCHEMA)
        assert "DQ102" in codes(diags)
        assert all(d.severity == Severity.WARNING for d in diags)

    def test_bool_vs_str_comparison_warns(self):
        _, diags = analyze_expression("flag = 'true'", SCHEMA)
        assert "DQ102" in codes(diags)

    def test_string_column_in_numeric_context_warns(self):
        _, diags = analyze_expression("att1 + 1", SCHEMA)
        assert "DQ102" in codes(diags)

    def test_like_on_numeric_warns(self):
        _, diags = analyze_expression("price LIKE '1%'", SCHEMA)
        assert "DQ102" in codes(diags)

    def test_clean_expression_has_no_diags(self):
        _, diags = analyze_expression(
            "item LIKE 'a%' AND price BETWEEN 0 AND 10", SCHEMA
        )
        assert diags == []


class TestDQ103InvalidLiteral:
    def test_non_numeric_string_vs_numeric_column(self):
        _, diags = analyze_expression("price > 'abc'", SCHEMA)
        assert "DQ103" in codes(diags)
        d = next(d for d in diags if d.code == "DQ103")
        assert d.severity == Severity.ERROR
        assert "always yields NULL" in d.message

    def test_numeric_string_literal_is_fine(self):
        _, diags = analyze_expression("price > '1.5'", SCHEMA)
        assert diags == []

    def test_invalid_rlike_regex(self):
        _, diags = analyze_expression("item RLIKE '(unclosed'", SCHEMA)
        assert "DQ103" in codes(diags)


class TestDQ104UnknownFunction:
    def test_unknown_function(self):
        _, diags = analyze_expression("FOO(price) > 1", SCHEMA)
        assert "DQ104" in codes(diags)
        assert diags[0].severity == Severity.ERROR

    def test_known_functions_clean(self):
        for expr in (
            "ABS(price) > 1",
            "LENGTH(item) > 3",
            "COALESCE(price, 0) >= 0",
            "LOWER(item) = 'x'",
        ):
            _, diags = analyze_expression(expr, SCHEMA)
            assert diags == [], expr


class TestDQ105Arity:
    def test_missing_argument(self):
        _, diags = analyze_expression("ABS() > 1", SCHEMA)
        assert "DQ105" in codes(diags)
        assert diags[0].severity == Severity.ERROR


class TestFuncAndCaseInference:
    def test_coalesce_with_non_nullable_fallback(self):
        typed, _ = analyze_expression("COALESCE(price, 0)", SCHEMA)
        assert typed.kind == "num" and typed.nullable is False

    def test_coalesce_all_nullable(self):
        typed, _ = analyze_expression("COALESCE(price, count)", SCHEMA)
        assert typed.nullable is True

    def test_case_without_else_is_nullable(self):
        typed, _ = analyze_expression(
            "CASE WHEN flag THEN 1 END", SCHEMA
        )
        assert typed.kind == "num" and typed.nullable is True

    def test_case_with_else_of_literals_not_nullable(self):
        typed, _ = analyze_expression(
            "CASE WHEN flag THEN 1 ELSE 2 END", SCHEMA
        )
        assert typed.nullable is False

    def test_length_of_non_nullable_string(self):
        typed, _ = analyze_expression("LENGTH(item)", SCHEMA)
        assert typed.kind == "num" and typed.nullable is False
