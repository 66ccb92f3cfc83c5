"""Row-level schema validation: split a table into valid (cast) and
invalid rows against typed per-column definitions.

reference: schema/RowLevelSchemaValidator.scala:25-282 — one conjunctive
boolean mask of all per-column predicates, valid rows cast to target
types, both sides counted. Here the CNF is a vectorized numpy mask.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from deequ_tpu_torch.data.table import Column, ColumnType, Table


@dataclass
class ColumnDefinition:
    name: str
    is_nullable: bool = True


@dataclass
class StringColumnDefinition(ColumnDefinition):
    min_length: Optional[int] = None
    max_length: Optional[int] = None
    matches: Optional[str] = None


@dataclass
class IntColumnDefinition(ColumnDefinition):
    min_value: Optional[int] = None
    max_value: Optional[int] = None


@dataclass
class DecimalColumnDefinition(ColumnDefinition):
    precision: int = 10
    scale: int = 0


@dataclass
class TimestampColumnDefinition(ColumnDefinition):
    mask: str = "yyyy-MM-dd HH:mm:ss"


class RowLevelSchema:
    """Fluent schema builder (reference: RowLevelSchemaValidator.scala:73-149)."""

    def __init__(self, column_definitions: Optional[List[ColumnDefinition]] = None):
        self.column_definitions = list(column_definitions or [])

    def with_string_column(
        self,
        name: str,
        is_nullable: bool = True,
        min_length: Optional[int] = None,
        max_length: Optional[int] = None,
        matches: Optional[str] = None,
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions
            + [StringColumnDefinition(name, is_nullable, min_length, max_length, matches)]
        )

    def with_int_column(
        self,
        name: str,
        is_nullable: bool = True,
        min_value: Optional[int] = None,
        max_value: Optional[int] = None,
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions
            + [IntColumnDefinition(name, is_nullable, min_value, max_value)]
        )

    def with_decimal_column(
        self, name: str, precision: int, scale: int, is_nullable: bool = True
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions
            + [DecimalColumnDefinition(name, is_nullable, precision, scale)]
        )

    def with_timestamp_column(
        self, name: str, mask: str, is_nullable: bool = True
    ) -> "RowLevelSchema":
        return RowLevelSchema(
            self.column_definitions + [TimestampColumnDefinition(name, is_nullable, mask)]
        )


@dataclass
class RowLevelSchemaValidationResult:
    valid_rows: Table
    num_valid_rows: int
    invalid_rows: Table
    num_invalid_rows: int


def _java_mask_to_strptime(mask: str) -> str:
    """SimpleDateFormat mask -> strptime format (common subset)."""
    out = mask
    for java, py in [
        ("yyyy", "%Y"),
        ("MM", "%m"),
        ("dd", "%d"),
        ("HH", "%H"),
        ("mm", "%M"),
        ("ss", "%S"),
    ]:
        out = out.replace(java, py)
    return out


class RowLevelSchemaValidator:
    @staticmethod
    def validate(data: Table, schema: RowLevelSchema) -> RowLevelSchemaValidationResult:
        """reference: RowLevelSchemaValidator.scala:183-230."""
        n = data.num_rows
        cnf = np.ones(n, dtype=bool)
        casts: List[Column] = []

        for definition in schema.column_definitions:
            col = data.column(definition.name)
            is_null = ~col.valid
            ok = np.ones(n, dtype=bool)

            if isinstance(definition, StringColumnDefinition):
                values = np.array(
                    [str(v) if col.valid[i] else "" for i, v in enumerate(col.values)],
                    dtype=object,
                )
                if definition.min_length is not None:
                    lengths = np.array([len(v) for v in values])
                    ok &= is_null | (lengths >= definition.min_length)
                if definition.max_length is not None:
                    lengths = np.array([len(v) for v in values])
                    ok &= is_null | (lengths <= definition.max_length)
                if definition.matches is not None:
                    rx = re.compile(definition.matches)
                    match = np.array(
                        [bool(rx.search(v)) for v in values], dtype=bool
                    )
                    ok &= is_null | match
                cast_values, cast_valid = values, col.valid.copy()
                cast_col = Column(definition.name, ColumnType.STRING, cast_values, cast_valid)
            elif isinstance(definition, IntColumnDefinition):
                parsed, parse_ok = _parse_ints(col)
                ok &= is_null | parse_ok
                if definition.min_value is not None:
                    ok &= is_null | (parse_ok & (parsed >= definition.min_value))
                if definition.max_value is not None:
                    ok &= is_null | (parse_ok & (parsed <= definition.max_value))
                cast_col = Column(
                    definition.name, ColumnType.LONG, parsed, col.valid & parse_ok
                )
            elif isinstance(definition, DecimalColumnDefinition):
                values, valid = col.numeric_values()
                # Spark's cast to Decimal(precision, scale) rounds HALF_UP
                # to `scale`, then marks rows whose integral part exceeds
                # precision-scale digits as invalid
                # (reference: schema/RowLevelSchemaValidator.scala:209-214)
                rounded = _round_half_up(col, values, valid, definition.scale)
                int_digits = definition.precision - definition.scale
                fits = valid & (np.abs(rounded) < 10.0 ** int_digits)
                ok &= is_null | fits
                cast_col = Column(definition.name, ColumnType.DECIMAL,
                                  np.where(fits, rounded, 0.0), fits)
            elif isinstance(definition, TimestampColumnDefinition):
                parsed, parse_ok = _parse_timestamps(col, definition.mask)
                ok &= is_null | parse_ok
                cast_col = Column(
                    definition.name, ColumnType.TIMESTAMP, parsed, col.valid & parse_ok
                )
            else:
                cast_col = col

            if not definition.is_nullable:
                ok &= ~is_null
            cnf &= ok
            casts.append(cast_col)

        extra_columns = [
            data.column(name)
            for name in data.column_names
            if name not in {d.name for d in schema.column_definitions}
        ]
        cast_table = Table(casts + extra_columns)

        valid_rows = cast_table.filter(cnf)
        invalid_rows = data.filter(~cnf)
        return RowLevelSchemaValidationResult(
            valid_rows, valid_rows.num_rows, invalid_rows, invalid_rows.num_rows
        )


def _round_half_up(col: Column, values: np.ndarray, valid: np.ndarray,
                   scale: int) -> np.ndarray:
    """HALF_UP rounding to `scale`, matching java.math.BigDecimal: the
    vectorized float path decides all rows except those whose scaled
    fraction sits within float error of an exact half — those few are
    re-rounded exactly with decimal.Decimal over the source text (e.g.
    "9.995" is 9.994999…8 as a double, but BigDecimal("9.995") at scale 2
    rounds HALF_UP to 10.00)."""
    from decimal import ROUND_HALF_UP, Decimal, InvalidOperation

    factor = 10.0 ** scale
    scaled = np.abs(values) * factor
    rounded = np.sign(values) * np.floor(scaled + 0.5) / factor
    near_half = valid & (np.abs(np.abs(scaled - np.floor(scaled)) - 0.5) < 1e-6)
    if near_half.any():
        quantum = Decimal(1).scaleb(-scale)
        for i in np.nonzero(near_half)[0]:
            try:
                exact = Decimal(str(col.values[i]).strip())
            except InvalidOperation:
                continue  # unparseable as decimal text: float verdict stands
            rounded[i] = float(exact.quantize(quantum, rounding=ROUND_HALF_UP))
    return rounded


# Spark's integer cast accepts only an optional sign + decimal digits;
# Python's int() is looser (underscore separators, unicode digits), so
# pre-validate with the strict form.
_STRICT_INT_RE = re.compile(r"^[+-]?[0-9]+$")


def _parse_ints(col: Column):
    n = len(col)
    parsed = np.zeros(n, dtype=np.int64)
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        if not col.valid[i]:
            continue
        s = str(col.values[i]).strip()
        if not _STRICT_INT_RE.match(s):
            continue
        try:
            parsed[i] = int(s)
            ok[i] = True
        except (TypeError, ValueError, OverflowError):
            pass
    return parsed, ok


def _parse_timestamps(col: Column, mask: str):
    from datetime import datetime

    fmt = _java_mask_to_strptime(mask)
    n = len(col)
    parsed = np.zeros(n, dtype="datetime64[us]")
    ok = np.zeros(n, dtype=bool)
    for i in range(n):
        if not col.valid[i]:
            continue
        try:
            parsed[i] = np.datetime64(datetime.strptime(str(col.values[i]), fmt), "us")
            ok[i] = True
        except (TypeError, ValueError):
            pass
    return parsed, ok
