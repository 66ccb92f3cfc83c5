"""Columnar in-memory table: the engine's DataFrame equivalent.

Numeric and bool columns are dense numpy arrays plus a validity mask;
strings stay on the host (object arrays + dictionary encoding). Batches
are row slices that the fused pass packs and ships to the device.
NaN in a float column counts as NULL (the pandas/Arrow convention).
"""

from __future__ import annotations

import enum
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


class ColumnType(enum.Enum):
    STRING = "StringType"
    LONG = "LongType"
    DOUBLE = "DoubleType"
    BOOLEAN = "BooleanType"
    TIMESTAMP = "TimestampType"
    DECIMAL = "DecimalType"

    @property
    def is_numeric(self) -> bool:
        return self in (ColumnType.LONG, ColumnType.DOUBLE, ColumnType.DECIMAL)


NUMPY_BACKING = {
    ColumnType.STRING: object,
    ColumnType.LONG: np.int64,
    ColumnType.DOUBLE: np.float64,
    ColumnType.BOOLEAN: np.bool_,
    ColumnType.TIMESTAMP: "datetime64[us]",
    ColumnType.DECIMAL: np.float64,
}


class Column:
    """One column: dense values + validity mask (True = present).

    CONTRACT: null slots in ``values`` hold the neutral fill (0 / "" /
    epoch) — never NaN — so masked reductions can consume the backing
    array directly. Build Columns through `Table.from_numpy`, which
    enforces this.
    """

    def __init__(self, name: str, ctype: ColumnType, values: np.ndarray, valid: np.ndarray):
        if len(values) != len(valid):
            raise ValueError(
                f"column {name!r}: {len(values)} values but {len(valid)} mask entries"
            )
        self.name = name
        self.ctype = ctype
        self.values = values
        self.valid = valid
        # per-instance memo for derived encodings (dict codes, numeric
        # views, packed hashes) shared by every analyzer reading it
        self._cache: Dict[str, object] = {}

    def __repr__(self) -> str:
        return f"Column({self.name!r}, {self.ctype})"

    def __len__(self) -> int:
        return len(self.valid)

    def slice(self, start: int, stop: int) -> "Column":
        child = Column(
            self.name, self.ctype, self.values[start:stop], self.valid[start:stop]
        )
        # derived encodings are row-wise, so a slice reuses the parent's:
        # a column is encoded once per table, not once per batch
        child._parent = (self, start, stop)
        return child

    def take(self, indices: np.ndarray) -> "Column":
        return Column(self.name, self.ctype, self.values[indices], self.valid[indices])

    def numeric_values(self) -> Tuple[np.ndarray, np.ndarray]:
        """(float64 values, valid). A string that does not parse as a
        number is invalid (null), as in the predicate engine. Returned
        arrays may be the column's own backing store: callers treat them
        as immutable."""
        if self.ctype == ColumnType.DOUBLE or self.ctype == ColumnType.DECIMAL:
            # null slots hold 0.0, so the backing array is usable as is
            return self.values, self.valid

        def compute(col: "Column"):
            if col.ctype == ColumnType.STRING:
                # parse the dictionary once, gather to rows
                codes, _uniques = col.dict_encode()
                u_vals, u_ok = parsed_dictionary(col)
                return (
                    gather_with_null(u_vals, codes, 0.0),
                    gather_with_null(u_ok, codes, False),
                )
            if col.ctype == ColumnType.BOOLEAN:
                return col.values.astype(np.float64), col.valid
            if col.ctype == ColumnType.TIMESTAMP:
                return (
                    col.values.astype("datetime64[us]")
                    .astype(np.int64)
                    .astype(np.float64),
                    col.valid,
                )
            # LONG
            return (
                np.where(col.valid, col.values.astype(np.float64), 0.0),
                col.valid,
            )

        return cached_column_encode(
            self,
            "numeric_values",
            compute,
            slicer=lambda v, s, e: (v[0][s:e], v[1][s:e]),
        )

    def dict_encode(self) -> Tuple[np.ndarray, np.ndarray]:
        """Dictionary-encode: (codes, uniques). Null rows get code -1.
        Memoized per table: every string consumer shares one encode."""
        return cached_column_encode(
            self,
            "dict_encode",
            _compute_dict_encode,
            # codes slice row-wise; the dictionary is shared whole
            slicer=lambda v, s, e: (v[0][s:e], v[1]),
        )


def _compute_dict_encode(col: "Column") -> Tuple[np.ndarray, np.ndarray]:
    if not col.valid.any():
        return (
            np.full(len(col.values), -1, dtype=np.int64),
            np.array([], dtype=object),
        )
    arr = None
    if col.ctype == ColumnType.STRING:
        # arrow's hash-based dictionary encode is far faster than numpy's
        # sort-based unique over object arrays; without pyarrow, numpy below
        try:
            import pyarrow as pa
        except ImportError:
            pa = None
        if pa is not None:
            try:
                arr = pa.array(
                    col.values,
                    type=pa.string(),
                    mask=None if col.valid.all() else ~col.valid,
                )
            except pa.lib.ArrowException:
                pass  # backing values that are not str: numpy below
        if arr is not None:
            encoded = arr.dictionary_encode()
            codes = (
                encoded.indices.fill_null(-1)
                .to_numpy(zero_copy_only=False)
                .astype(np.int64)
            )
            uniques = encoded.dictionary.to_numpy(zero_copy_only=False)
            return codes, uniques.astype(object, copy=False)
    vals = col.values[col.valid]
    if col.ctype == ColumnType.STRING:
        vals = vals.astype(str)
    uniques, inv = np.unique(vals, return_inverse=True)
    codes = np.full(len(col.values), -1, dtype=np.int64)
    codes[col.valid] = inv
    return codes, uniques


def cached_column_encode(col: "Column", key: str, compute, slicer=None):
    """Column-deterministic derived encoding, memoized on the Column with
    parent-slice delegation: one materialization per TABLE, batches slice
    it. `compute(column)` builds the full-column value on the root
    column; `slicer(value, start, stop)` produces a batch view of it
    (default: plain array slicing)."""
    cached = col._cache.get(key)
    if cached is None:
        parent = getattr(col, "_parent", None)
        if parent is not None:
            p, start, stop = parent
            whole = cached_column_encode(p, key, compute, slicer)
            cached = (
                slicer(whole, start, stop)
                if slicer is not None
                else whole[start:stop]
            )
        else:
            cached = compute(col)
        col._cache[key] = cached
    return cached


def cached_dictionary_encode(col: "Column", key: str, compute):
    """A value derived from a STRING column's dictionary (its parse, its
    classes), memoized on the root column: every batch slice shares the
    root's dictionary, so it is derived once per table."""
    root = col
    while getattr(root, "_parent", None) is not None:
        root = root._parent[0]
    cached = root._cache.get(key)
    if cached is None:
        cached = compute(root)
        root._cache[key] = cached
    return cached


def parsed_dictionary(col: "Column") -> Tuple[np.ndarray, np.ndarray]:
    """(parsed float64 values, parse-ok mask) per dictionary entry of a
    STRING column: shared by `numeric_values`' per-row gather and the
    profiler's counts-based numeric statistics."""
    from deequ_tpu_torch.ops.strings import parse_floats

    return cached_dictionary_encode(
        col,
        "dictparse",
        lambda c: parse_floats(np.asarray(c.dict_encode()[1], dtype=object)),
    )


def gather_with_null(lut: np.ndarray, codes: np.ndarray, null_value) -> np.ndarray:
    """Per-row gather of a per-unique LUT through dict_encode codes: the
    null code (-1) indexes a slot holding `null_value` appended at the end."""
    lut = np.asarray(lut)
    ext = np.append(lut, np.asarray([null_value], dtype=lut.dtype))
    return ext[codes]


def _infer_type(values: Sequence) -> ColumnType:
    non_null = [v for v in values if v is not None]
    if not non_null:
        return ColumnType.STRING
    if all(isinstance(v, bool) for v in non_null):
        return ColumnType.BOOLEAN
    if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in non_null):
        return ColumnType.LONG
    if all(
        isinstance(v, (int, float, np.integer, np.floating)) and not isinstance(v, bool)
        for v in non_null
    ):
        return ColumnType.DOUBLE
    return ColumnType.STRING


def _column_from_list(name: str, values: Sequence, ctype: Optional[ColumnType]) -> Column:
    if ctype is None:
        ctype = _infer_type(values)
    n = len(values)
    floating = ctype in (ColumnType.DOUBLE, ColumnType.DECIMAL)
    valid = np.array(
        [v is not None and (not floating or v == v) for v in values], dtype=np.bool_
    )
    if ctype == ColumnType.STRING:
        arr = np.empty(n, dtype=object)
        for i, v in enumerate(values):
            arr[i] = str(v) if v is not None else ""
    else:
        fill = {
            ColumnType.LONG: 0,
            ColumnType.DOUBLE: 0.0,
            ColumnType.DECIMAL: 0.0,
            ColumnType.BOOLEAN: False,
            ColumnType.TIMESTAMP: np.datetime64(0, "us"),
        }[ctype]
        arr = np.array(
            [v if ok else fill for v, ok in zip(values, valid)],
            dtype=NUMPY_BACKING[ctype],
        )
    return Column(name, ctype, arr, valid)


class Table:
    """Immutable columnar table."""

    def __init__(self, columns: Sequence[Column]):
        self._columns: Dict[str, Column] = {c.name: c for c in columns}
        lengths = {len(c) for c in columns}
        if len(lengths) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        self._num_rows = lengths.pop() if lengths else 0

    @staticmethod
    def from_pydict(
        data: Dict[str, Sequence], types: Optional[Dict[str, ColumnType]] = None
    ) -> "Table":
        """Columns from Python lists; None is NULL, and a column's type is
        inferred from its values unless `types` names it."""
        types = types or {}
        return Table([_column_from_list(k, v, types.get(k)) for k, v in data.items()])

    @staticmethod
    def from_numpy(
        data: Dict[str, np.ndarray],
        valid: Optional[Dict[str, np.ndarray]] = None,
        types: Optional[Dict[str, ColumnType]] = None,
    ) -> "Table":
        """Columns from numpy arrays. Float NaN counts as NULL; object
        arrays infer their type like Python lists do ({bool, None} is
        BOOLEAN, object ints are LONG, anything else STRING). `valid`
        masks AND with the nulls the values imply."""
        valid = valid or {}
        types = types or {}
        cols = []
        for name, arr in data.items():
            arr = np.asarray(arr)
            if name in types:
                ctype = types[name]
            elif arr.dtype == np.bool_:
                ctype = ColumnType.BOOLEAN
            elif np.issubdtype(arr.dtype, np.integer):
                ctype = ColumnType.LONG
            elif np.issubdtype(arr.dtype, np.floating):
                ctype = ColumnType.DOUBLE
            elif np.issubdtype(arr.dtype, np.datetime64):
                ctype = ColumnType.TIMESTAMP
            else:
                inferred = _column_from_list(name, list(arr), None)
                extra_mask = valid.get(name)
                if extra_mask is not None:
                    inferred = Column(
                        name,
                        inferred.ctype,
                        inferred.values,
                        inferred.valid & np.asarray(extra_mask, dtype=np.bool_),
                    )
                cols.append(inferred)
                continue
            v = valid.get(name)
            if v is None:
                if ctype in (ColumnType.DOUBLE, ColumnType.DECIMAL):
                    v = ~np.isnan(np.asarray(arr, dtype=np.float64))
                    arr = np.where(v, arr, 0.0)
                elif ctype == ColumnType.STRING:
                    v = np.array([x is not None for x in arr], dtype=np.bool_)
                    if not v.all():
                        arr = arr.copy()
                        arr[~v] = ""
                else:
                    v = np.ones(len(arr), dtype=np.bool_)
            elif ctype in (ColumnType.DOUBLE, ColumnType.DECIMAL):
                # NaN == NULL under this engine; enforce the neutral fill
                # even when the caller supplies the mask
                v = np.asarray(v, dtype=np.bool_) & ~np.isnan(
                    np.asarray(arr, dtype=np.float64)
                )
                arr = np.where(v, arr, 0.0)
            cols.append(Column(name, ctype, arr, np.asarray(v, dtype=np.bool_)))
        return Table(cols)

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def __len__(self) -> int:
        return self._num_rows

    @property
    def column_names(self) -> List[str]:
        return list(self._columns.keys())

    def has_column(self, name: str) -> bool:
        return name in self._columns

    def column(self, name: str) -> Column:
        if name not in self._columns:
            from deequ_tpu_torch.core.exceptions import NoSuchColumnException

            raise NoSuchColumnException(f"Input data does not include column {name}!")
        return self._columns[name]

    def __getitem__(self, name: str) -> Column:
        return self.column(name)

    @property
    def schema(self) -> List[Tuple[str, ColumnType]]:
        return [(c.name, c.ctype) for c in self._columns.values()]

    def slice(self, start: int, stop: int) -> "Table":
        return Table([c.slice(start, stop) for c in self._columns.values()])

    def filter(self, row_mask: np.ndarray) -> "Table":
        idx = np.nonzero(np.asarray(row_mask, dtype=bool))[0]
        return Table([c.take(idx) for c in self._columns.values()])

    def select(self, names: Sequence[str]) -> "Table":
        return Table([self.column(n) for n in names])

    def with_column(self, col: Column) -> "Table":
        cols = [c for c in self._columns.values() if c.name != col.name]
        return Table(cols + [col])

    def random_split(
        self, weights: Sequence[float], seed: Optional[int] = None
    ) -> List["Table"]:
        """Split the rows by normalized `weights`, each row by one uniform
        draw from `np.random.default_rng(seed)`, as the JAX package does,
        so both packages split a table alike (reference:
        suggestions/ConstraintSuggestionRunner.scala:127-148)."""
        rng = np.random.default_rng(seed)
        total = float(sum(weights))
        u = rng.random(self._num_rows)
        bounds = np.cumsum([w / total for w in weights])
        out = []
        lo = 0.0
        for hi in bounds:
            out.append(self.filter((u >= lo) & (u < hi)))
            lo = hi
        return out

    def to_pydict(self) -> Dict[str, List]:
        """Python lists per column, None for NULL."""
        out: Dict[str, List] = {}
        for c in self._columns.values():
            if c.ctype == ColumnType.STRING or c.ctype == ColumnType.TIMESTAMP:
                vals = list(c.values)
            else:
                vals = c.values.tolist()
            out[c.name] = [v if ok else None for v, ok in zip(vals, c.valid.tolist())]
        return out

    def batches(self, batch_size: int) -> Iterator["Table"]:
        """Fixed-size row slices (the unit shipped to the device)."""
        if self._num_rows <= batch_size:
            # single batch: yield self so per-Column caches are shared
            # across every pass over this table
            yield self
            return
        for start in range(0, self._num_rows, batch_size):
            yield self.slice(start, min(start + batch_size, self._num_rows))

    def __repr__(self):
        cols = ", ".join(f"{n}:{t.value}" for n, t in self.schema)
        return f"Table({self._num_rows} rows; {cols})"
