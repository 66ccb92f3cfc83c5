"""Dedicated row-level schema-validator tests — the mirror of the
reference's RowLevelSchemaValidatorTest.scala (265 LoC): null/string/
regex/int/decimal/timestamp constraints and valid-vs-invalid row splits
with casts.

Port-mapped from tests/test_schema_validator.py: the same cases against
deequ_tpu_torch, with every run on device="cpu" and the toy tables of
tests/fixtures.py as the port's tables (tests/torch_fixtures.py).
"""

from __future__ import annotations

import numpy as np
import pytest

from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.schema.row_level_schema_validator import (
    RowLevelSchema,
    RowLevelSchemaValidator,
)


def validate(table, schema):
    return RowLevelSchemaValidator.validate(table, schema)


class TestNullConstraints:
    """reference: RowLevelSchemaValidatorTest.scala:27-56."""

    def test_non_nullable_rejects_nulls(self):
        t = Table.from_pydict({"id": ["1", None, "3", None]})
        schema = RowLevelSchema().with_string_column("id", is_nullable=False)
        result = validate(t, schema)
        assert result.num_valid_rows == 2
        assert result.num_invalid_rows == 2
        assert list(result.valid_rows.column("id").values) == ["1", "3"]

    def test_nullable_keeps_nulls(self):
        t = Table.from_pydict({"id": ["1", None, "3"]})
        schema = RowLevelSchema().with_string_column("id", is_nullable=True)
        result = validate(t, schema)
        assert result.num_valid_rows == 3
        assert result.num_invalid_rows == 0


class TestStringConstraints:
    """reference: RowLevelSchemaValidatorTest.scala:58-117."""

    def test_length_bounds(self):
        t = Table.from_pydict({"name": ["a", "abc", "abcdef", ""]})
        schema = RowLevelSchema().with_string_column(
            "name", is_nullable=False, min_length=1, max_length=3
        )
        result = validate(t, schema)
        assert result.num_valid_rows == 2
        assert list(result.valid_rows.column("name").values) == ["a", "abc"]

    def test_regex_filter(self):
        t = Table.from_pydict({"code": ["AB-1", "XY-2", "nope", "CD-9"]})
        schema = RowLevelSchema().with_string_column(
            "code", is_nullable=False, matches=r"^[A-Z]{2}-\d$"
        )
        result = validate(t, schema)
        assert result.num_valid_rows == 3
        assert "nope" in list(result.invalid_rows.column("code").values)

    def test_null_passes_string_constraints_when_nullable(self):
        # constraints only apply to present values (reference semantics)
        t = Table.from_pydict({"name": [None, "ab"]})
        schema = RowLevelSchema().with_string_column(
            "name", is_nullable=True, min_length=2
        )
        result = validate(t, schema)
        assert result.num_valid_rows == 2


class TestIntConstraints:
    """reference: RowLevelSchemaValidatorTest.scala:119-147."""

    def test_range_and_parse(self):
        t = Table.from_pydict({"v": ["1", "17", "99", "x", "3.5"]})
        schema = RowLevelSchema().with_int_column(
            "v", is_nullable=False, min_value=1, max_value=50
        )
        result = validate(t, schema)
        # '99' out of range, 'x' unparseable, '3.5' not a strict int
        assert result.num_valid_rows == 2
        assert result.num_invalid_rows == 3
        # valid rows are CAST to the target type
        col = result.valid_rows.column("v")
        assert col.ctype == ColumnType.LONG
        assert list(col.values) == [1, 17]

    def test_min_only(self):
        t = Table.from_pydict({"v": ["-5", "0", "5"]})
        schema = RowLevelSchema().with_int_column("v", is_nullable=False, min_value=0)
        result = validate(t, schema)
        assert result.num_valid_rows == 2

    def test_strict_integer_parse_rejects_whitespace_garbage(self):
        t = Table.from_pydict({"v": ["12", "1 2", "+3", "-4", "4x"]})
        schema = RowLevelSchema().with_int_column("v", is_nullable=False)
        result = validate(t, schema)
        assert result.num_valid_rows == 3  # 12, +3, -4


class TestDecimalConstraints:
    """reference: RowLevelSchemaValidatorTest.scala:149-177."""

    def test_precision_and_scale(self):
        t = Table.from_pydict({"d": ["1.23", "12.345", "123456789.12", "abc"]})
        schema = RowLevelSchema().with_decimal_column(
            "d", precision=6, scale=2, is_nullable=False
        )
        result = validate(t, schema)
        # 12.345 rounds to scale 2 (half-up) and fits; 123456789.12
        # exceeds precision; abc unparseable
        assert result.num_valid_rows == 2
        col = result.valid_rows.column("d")
        assert col.ctype == ColumnType.DECIMAL
        assert list(col.values) == pytest.approx([1.23, 12.35])

    def test_scale_zero(self):
        t = Table.from_pydict({"d": ["5", "5.4", "5.6"]})
        schema = RowLevelSchema().with_decimal_column(
            "d", precision=3, scale=0, is_nullable=False
        )
        result = validate(t, schema)
        assert result.num_valid_rows == 3
        assert list(result.valid_rows.column("d").values) == pytest.approx(
            [5.0, 5.0, 6.0]  # half-up rounding at scale 0
        )


class TestTimestampConstraints:
    """reference: RowLevelSchemaValidatorTest.scala:179-205."""

    def test_mask_parse(self):
        t = Table.from_pydict(
            {
                "ts": [
                    "2024-03-01 10:00:00",
                    "01/03/2024",
                    "2024-03-02 23:59:59",
                ]
            }
        )
        schema = RowLevelSchema().with_timestamp_column(
            "ts", mask="yyyy-MM-dd HH:mm:ss", is_nullable=False
        )
        result = validate(t, schema)
        assert result.num_valid_rows == 2
        col = result.valid_rows.column("ts")
        assert col.ctype == ColumnType.TIMESTAMP
        assert np.datetime64("2024-03-01T10:00:00") in list(col.values)

    def test_alternative_mask(self):
        t = Table.from_pydict({"ts": ["01/03/2024", "2024-03-01"]})
        schema = RowLevelSchema().with_timestamp_column(
            "ts", mask="dd/MM/yyyy", is_nullable=False
        )
        result = validate(t, schema)
        assert result.num_valid_rows == 1


class TestIntegration:
    """reference: RowLevelSchemaValidatorTest.scala:207-264 — multiple
    constrained columns, valid and invalid split preserved row-wise."""

    def test_multi_column_split(self):
        t = Table.from_pydict(
            {
                "id": ["1", "2", "x", "4", "5"],
                "name": ["ann", "bob", "cat", None, "eve"],
                "age": ["30", "17", "45", "22", "200"],
            }
        )
        schema = (
            RowLevelSchema()
            .with_int_column("id", is_nullable=False)
            .with_string_column("name", is_nullable=False, min_length=3)
            .with_int_column("age", is_nullable=False, min_value=18, max_value=120)
        )
        result = validate(t, schema)
        # row1: ok; row2: age 17; row3: id x; row4: name null; row5: age 200
        assert result.num_valid_rows == 1
        assert result.num_invalid_rows == 4
        assert list(result.valid_rows.column("name").values) == ["ann"]
        assert list(result.valid_rows.column("id").values) == [1]
        # invalid rows keep their ORIGINAL (uncast) values
        assert "x" in list(result.invalid_rows.column("id").values)

    def test_counts_sum_to_total(self):
        t = Table.from_pydict({"v": [str(i) for i in range(50)]})
        schema = RowLevelSchema().with_int_column(
            "v", is_nullable=False, max_value=24
        )
        result = validate(t, schema)
        assert result.num_valid_rows + result.num_invalid_rows == 50
        assert result.num_valid_rows == 25
