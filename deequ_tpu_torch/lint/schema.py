"""Schema model the static analyzer resolves names and types against.

Built from a live `Table`, from `applicability.SchemaField`s, or from
explicit (name, ctype, nullable) triples. Also manufactures a ZERO-ROW
Table with the right dtypes so existing `Preconditions` closures can run
statically — same exception texts as a real scan, no data touched.
"""

from __future__ import annotations

import difflib
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from deequ_tpu_torch.data.table import Column, ColumnType, NUMPY_BACKING, Table


@dataclass(frozen=True)
class FieldInfo:
    name: str
    ctype: ColumnType
    # True = the column MAY contain nulls. The analyzer is conservative:
    # over-reporting nullability is safe, under-reporting is not.
    nullable: bool = True
    # Optional cardinality hint (e.g. from profiling) the cost analyzer
    # uses to estimate grouping-pass group counts / spill risk (DQ302).
    # None = unknown: no cardinality-based diagnostics fire.
    approx_distinct: Optional[int] = None


class SchemaInfo:
    def __init__(self, fields: Sequence[FieldInfo]):
        self.fields: List[FieldInfo] = list(fields)
        self._by_name: Dict[str, FieldInfo] = {f.name: f for f in self.fields}
        self._empty_table: Optional[Table] = None

    # -- constructors --------------------------------------------------------

    @classmethod
    def from_table(cls, table: Table) -> "SchemaInfo":
        fields = []
        for name, ctype in table.schema:
            col = table.column(name)
            fields.append(FieldInfo(name, ctype, bool((~col.valid).any())))
        return cls(fields)

    @classmethod
    def from_schema_fields(cls, schema_fields: Sequence) -> "SchemaInfo":
        """From applicability.SchemaField (name/ctype/nullable attrs)."""
        return cls(
            [FieldInfo(f.name, f.ctype, bool(f.nullable)) for f in schema_fields]
        )

    # -- lookup --------------------------------------------------------------

    def has(self, name: str) -> bool:
        return name in self._by_name

    def field(self, name: str) -> Optional[FieldInfo]:
        return self._by_name.get(name)

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def suggest(self, name: str) -> Optional[str]:
        matches = difflib.get_close_matches(name, self.names(), n=1, cutoff=0.6)
        return matches[0] if matches else None

    # -- static precondition support ----------------------------------------

    def empty_table(self) -> Table:
        """Zero-row Table with this schema's dtypes: lets analyzer
        `preconditions()` (has_column / is_numeric / is_string / param
        checks) run unchanged with zero data scanned. Cached — lint runs
        it once per analyzer."""
        if self._empty_table is not None:
            return self._empty_table
        columns = []
        for f in self.fields:
            backing = NUMPY_BACKING[f.ctype]
            values = np.empty(0, dtype=backing)
            columns.append(
                Column(f.name, f.ctype, values, np.zeros(0, dtype=bool))
            )
        self._empty_table = Table(columns)
        return self._empty_table
