"""Applicability checker: dry-run constraints/analyzers on generated random
data matching a schema.

reference: analyzers/applicability/Applicability.scala:40-273 — 1000 rows,
~1% nulls for nullable fields, typed random generators. This doubles as the
framework's schema-level fake backend.
"""

from __future__ import annotations

import string
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from deequ_tpu_torch.checks.check import Check
from deequ_tpu_torch.constraints.constraint import (
    AnalysisBasedConstraint,
    Constraint,
    ConstraintDecorator,
)
from deequ_tpu_torch.data.table import Column, ColumnType, Table


@dataclass
class SchemaField:
    name: str
    ctype: ColumnType
    nullable: bool = True
    precision: int = 10
    scale: int = 2


@dataclass
class CheckApplicability:
    is_applicable: bool
    failures: List[Tuple[str, BaseException]]
    constraint_applicabilities: Dict[Constraint, bool]


@dataclass
class AnalyzersApplicability:
    is_applicable: bool
    failures: List[Tuple[str, BaseException]]


def generate_random_data(
    schema: Sequence[SchemaField], num_records: int = 1000, seed: Optional[int] = None
) -> Table:
    """reference: Applicability.scala:46-155 — ~1% nulls when nullable."""
    rng = np.random.default_rng(seed)
    columns = []
    for fld in schema:
        null_mask = (
            rng.random(num_records) < 0.01
            if fld.nullable
            else np.zeros(num_records, dtype=bool)
        )
        valid = ~null_mask
        if fld.ctype == ColumnType.BOOLEAN:
            values = rng.random(num_records) > 0.5
        elif fld.ctype == ColumnType.LONG:
            values = rng.integers(-(2**31), 2**31, num_records, dtype=np.int64)
        elif fld.ctype == ColumnType.DOUBLE:
            values = rng.random(num_records)
        elif fld.ctype == ColumnType.DECIMAL:
            digits = fld.precision - fld.scale
            # precision == scale means no whole digits: whole part is 0
            # (10**(digits-1) would be the float 0.1 and rng.integers
            # rejects it)
            lo = 10 ** (digits - 1) if digits > 0 else 0
            hi = 10**digits if digits > 0 else 1
            whole = rng.integers(lo, hi, num_records)
            frac = rng.integers(0, 10**fld.scale, num_records) if fld.scale > 0 else 0
            values = whole + (frac / (10**fld.scale) if fld.scale > 0 else 0.0)
            values = values.astype(np.float64)
        elif fld.ctype == ColumnType.TIMESTAMP:
            values = rng.integers(0, 2**41, num_records).astype("datetime64[ms]").astype(
                "datetime64[us]"
            )
        else:  # STRING: alphanumeric, length 1..20
            alphabet = np.array(list(string.ascii_letters + string.digits))
            values = np.empty(num_records, dtype=object)
            lengths = rng.integers(1, 21, num_records)
            for i in range(num_records):
                values[i] = "".join(rng.choice(alphabet, lengths[i]))
        if fld.ctype != ColumnType.STRING:
            values = np.asarray(values)
        columns.append(Column(fld.name, fld.ctype, values, valid))
    return Table(columns)


def _statically_decidable(analyzer) -> bool:
    """True when the static pass alone decides this analyzer's
    applicability: its failure modes are all plan-time facts
    (preconditions, expression parsing, column resolution, regex
    validity). User-supplied callables (Histogram binning UDFs) can fail
    in ways no static pass sees, so they keep the dynamic dry-run."""
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct,
        ApproxQuantile,
        ApproxQuantiles,
        Completeness,
        Compliance,
        Correlation,
        CountDistinct,
        DataType,
        Distinctness,
        Entropy,
        Histogram,
        Maximum,
        Mean,
        Minimum,
        MutualInformation,
        PatternMatch,
        Size,
        StandardDeviation,
        Sum,
        UniqueValueRatio,
        Uniqueness,
    )

    if isinstance(analyzer, Histogram):
        return analyzer.binning_udf is None
    return isinstance(
        analyzer,
        (
            ApproxCountDistinct,
            ApproxQuantile,
            ApproxQuantiles,
            Completeness,
            Compliance,
            Correlation,
            CountDistinct,
            DataType,
            Distinctness,
            Entropy,
            Maximum,
            Mean,
            Minimum,
            MutualInformation,
            PatternMatch,
            Size,
            StandardDeviation,
            Sum,
            UniqueValueRatio,
            Uniqueness,
        ),
    )


def _static_failure(analyzer, schema_info) -> Optional[BaseException]:
    """The exception a dry-run would surface for this analyzer, determined
    with zero data scans; None when the static pass finds no problem.
    Conservative: only failure modes that a real run would DEFINITELY hit
    (missing columns, wrong types, bad parameters, unparseable
    expressions, invalid regexes) are reported — a typecheck warning like
    a numeric comparison against a string literal does not fail a scan
    and must not fail applicability."""
    import re

    from deequ_tpu_torch.analyzers.base import Preconditions
    from deequ_tpu_torch.core.exceptions import NoSuchColumnException
    from deequ_tpu_torch.data.expr import ExpressionParseError, Predicate

    err = Preconditions.find_first_failing(
        schema_info.empty_table(), analyzer.preconditions()
    )
    if err is not None:
        return err

    for attr in ("predicate", "where"):
        expression = getattr(analyzer, attr, None)
        if not isinstance(expression, str):
            continue
        try:
            predicate = Predicate(expression)
        except ExpressionParseError as e:
            return e
        for col in predicate.referenced_columns():
            if not schema_info.has(col):
                return NoSuchColumnException(
                    f"Input data does not include column {col}!"
                )

    pattern = getattr(analyzer, "pattern", None)
    if isinstance(pattern, str):
        try:
            re.compile(pattern)
        except re.error as e:
            return e

    return None


class Applicability:
    """reference: Applicability.scala:172-237 — but STATIC-FIRST: the
    schema model (lint/schema.py) decides whatever it can with zero
    scans; random data is generated and dry-run, on `device` (CUDA
    unless the caller asks for ``"cpu"``), only for analyzers whose
    failure modes statics cannot rule out."""

    def __init__(self, device=None):
        self.device = device

    def is_applicable(
        self, check: Check, schema: Sequence[SchemaField], num_records: int = 1000
    ) -> CheckApplicability:
        from deequ_tpu_torch.core.exceptions import wrap_if_necessary
        from deequ_tpu_torch.lint import SchemaInfo

        schema_info = SchemaInfo.from_schema_fields(schema)
        constraint_applicabilities: Dict[Constraint, bool] = {}
        failures: List[Tuple[str, BaseException]] = []

        # static pass first; collect the constraints statics can't decide
        dynamic: List[Tuple[Constraint, AnalysisBasedConstraint]] = []
        for constraint in check.constraints:
            inner = (
                constraint.inner
                if isinstance(constraint, ConstraintDecorator)
                else constraint
            )
            if not isinstance(inner, AnalysisBasedConstraint):
                constraint_applicabilities[constraint] = True
                continue
            exc = _static_failure(inner.analyzer, schema_info)
            if exc is not None:
                constraint_applicabilities[constraint] = False
                failures.append((repr(constraint), wrap_if_necessary(exc)))
            elif _statically_decidable(inner.analyzer):
                constraint_applicabilities[constraint] = True
            else:
                dynamic.append((constraint, inner))

        # dynamic fallback only for what statics couldn't decide
        if dynamic:
            data = generate_random_data(schema, num_records)
            for constraint, inner in dynamic:
                metric = inner.analyzer.calculate(data, device=self.device)
                ok = metric.value.is_success
                constraint_applicabilities[constraint] = ok
                if not ok:
                    failures.append((repr(constraint), metric.value.exception))

        return CheckApplicability(
            not failures, failures, constraint_applicabilities
        )

    def are_applicable(
        self,
        analyzers: Sequence,
        schema: Sequence[SchemaField],
        num_records: int = 1000,
    ) -> AnalyzersApplicability:
        from deequ_tpu_torch.core.exceptions import wrap_if_necessary
        from deequ_tpu_torch.lint import SchemaInfo

        schema_info = SchemaInfo.from_schema_fields(schema)
        failures: List[Tuple[str, BaseException]] = []
        dynamic = []
        for analyzer in analyzers:
            exc = _static_failure(analyzer, schema_info)
            if exc is not None:
                failures.append((analyzer.instance, wrap_if_necessary(exc)))
            elif not _statically_decidable(analyzer):
                dynamic.append(analyzer)

        if dynamic:
            data = generate_random_data(schema, num_records)
            for analyzer in dynamic:
                metric = analyzer.calculate(data, device=self.device)
                if metric.value.is_failure:
                    failures.append((metric.instance, metric.value.exception))
        return AnalyzersApplicability(not failures, failures)
