"""Columnar in-memory table: the engine's DataFrame equivalent.

Numeric and bool columns are dense numpy arrays plus a validity mask;
strings stay on the host (object arrays + dictionary encoding). Batches
are row slices that the fused pass packs and ships to the device.
NaN in a float column counts as NULL (the pandas/Arrow convention).

The Arrow, pandas and Parquet surface (`from_arrow`, `to_arrow`,
`from_pandas`, `to_pandas`, `from_parquet`, `to_parquet`) converts whole
tables; `scan_parquet` and `scan_parquet_dataset` stream a file or a
dataset through every pass (data/source.py). A streamed string column
keeps its Arrow dictionary: its codes serve the analyzers, and per-row
Python strings are built only if something reads `values`.
"""

from __future__ import annotations

import enum
import threading
from collections import OrderedDict
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

    `values` may be a zero-argument callable: the column then builds its
    values on first read (a streamed string column, whose dictionary
    codes serve the analyzers).
    """

    # content digest of the Arrow dictionary a streamed string column was
    # decoded from: values derived from the dictionary itself (its parse,
    # classes, hashes) are shared by the batches whose dictionaries are equal
    _dict_content_key = None

    def __init__(self, name: str, ctype: ColumnType, values, valid: np.ndarray):
        if callable(values):
            self._values = None
            self._values_fn = values
        else:
            if len(values) != len(valid):
                raise ValueError(
                    f"column {name!r}: {len(values)} values but {len(valid)} mask entries"
                )
            self._values = values
            self._values_fn = None
        self.name = name
        self.ctype = ctype
        self.valid = valid
        # per-instance memo for derived encodings (dict codes, numeric
        # views, packed hashes) shared by every analyzer reading it
        self._cache: Dict[str, object] = {}

    @property
    def values(self) -> np.ndarray:
        if self._values is None:
            values = self._values_fn()
            if len(values) != len(self.valid):
                raise ValueError(
                    f"column {self.name!r}: {len(values)} values but "
                    f"{len(self.valid)} mask entries"
                )
            self._values = values
        return self._values

    def __repr__(self) -> str:
        return f"Column({self.name!r}, {self.ctype})"

    def __len__(self) -> int:
        return len(self.valid)

    @property
    def null_count(self) -> int:
        return int(len(self.valid) - np.count_nonzero(self.valid))

    def non_null_values(self) -> np.ndarray:
        return self.values[self.valid]

    def slice(self, start: int, stop: int) -> "Column":
        child = Column(
            self.name,
            self.ctype,
            # lazy through the slice: a lazy parent builds its values only
            # if the child's are read
            lambda: self.values[start:stop],
            self.valid[start:stop],
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

    def as_float(self) -> np.ndarray:
        """Values as float64; null and unparseable slots are 0.0 (the mask
        comes from `numeric_values`)."""
        return self.numeric_values()[0]

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
            np.full(len(col), -1, dtype=np.int64),
            np.array([], dtype=object),
        )
    arrow_arr = col._cache.get("arrow")
    if arrow_arr is not None:
        # an Arrow-backed string column: Arrow's hash encode, no objects
        return _arrow_dict_encode(arrow_arr)
    if col.ctype == ColumnType.STRING:
        # arrow's hash-based dictionary encode is far faster than numpy's
        # sort-based unique over object arrays; without pyarrow, numpy below
        try:
            import pyarrow as pa
        except ImportError:
            pa = None
        if pa is not None:
            try:
                return _arrow_dict_encode(
                    pa.array(
                        col.values,
                        type=pa.string(),
                        mask=None if col.valid.all() else ~col.valid,
                    )
                )
            except pa.lib.ArrowException:
                pass  # backing values that are not str: numpy below
    vals = col.values[col.valid]
    if col.ctype == ColumnType.STRING:
        vals = vals.astype(str)
    uniques, inv = np.unique(vals, return_inverse=True)
    codes = np.full(len(col.values), -1, dtype=np.int64)
    codes[col.valid] = inv
    return codes, uniques


def _arrow_dict_encode(arrow_arr) -> Tuple[np.ndarray, np.ndarray]:
    """(int64 codes with -1 for null, object uniques) from Arrow's hash
    dictionary encode of one array."""
    encoded = arrow_arr.dictionary_encode()
    codes = encoded.indices.fill_null(-1).to_numpy(zero_copy_only=False).astype(np.int64)
    uniques = encoded.dictionary.to_numpy(zero_copy_only=False)
    return codes, uniques.astype(object, copy=False)


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


# The cross-batch tier of `cached_dictionary_encode`: values derived from
# equal dictionaries, keyed by the dictionary's content digest, LRU-bounded
# by entries and by bytes so a stream of distinct dictionaries cannot pin
# memory for the process's lifetime.
_DICT_DERIVED_CACHE: "OrderedDict" = OrderedDict()
_DICT_DERIVED_MAX = 256
_DICT_DERIVED_MAX_BYTES = 32 << 20
_DICT_DERIVED_BYTES = 0
_DICT_DERIVED_LOCK = threading.Lock()


def _derived_nbytes(value) -> int:
    if isinstance(value, np.ndarray):
        return int(value.nbytes)
    if isinstance(value, (tuple, list)):
        return sum(_derived_nbytes(v) for v in value)
    return 64


def cached_dictionary_encode(col: "Column", key: str, compute):
    """A value derived from a STRING column's dictionary (its parse, its
    classes, its hashes), memoized on the root column: every batch slice
    shares the root's dictionary, so it is derived once per table. A
    streamed column also shares it across batches whose Arrow dictionaries
    have equal content (`_dict_content_key`)."""
    global _DICT_DERIVED_BYTES
    root = col
    while getattr(root, "_parent", None) is not None:
        root = root._parent[0]
    cached = root._cache.get(key)
    if cached is not None:
        return cached
    content_key = root._dict_content_key
    if content_key is not None:
        with _DICT_DERIVED_LOCK:
            hit = _DICT_DERIVED_CACHE.get((content_key, key))
            if hit is not None:
                _DICT_DERIVED_CACHE.move_to_end((content_key, key))
                root._cache[key] = hit[0]
                return hit[0]
    value = compute(root)
    root._cache[key] = value
    if content_key is not None:
        nbytes = _derived_nbytes(value)
        with _DICT_DERIVED_LOCK:
            _DICT_DERIVED_CACHE[(content_key, key)] = (value, nbytes)
            _DICT_DERIVED_BYTES += nbytes
            while _DICT_DERIVED_CACHE and (
                len(_DICT_DERIVED_CACHE) > _DICT_DERIVED_MAX
                or _DICT_DERIVED_BYTES > _DICT_DERIVED_MAX_BYTES
            ):
                _evicted, (_value, evicted_bytes) = _DICT_DERIVED_CACHE.popitem(last=False)
                _DICT_DERIVED_BYTES -= evicted_bytes
    return value


def _arrow_dictionary_digest(dictionary):
    """The cross-batch memo key of an Arrow string dictionary: its length
    and a sha1 over its buffers. None (no sharing) for a sliced or an
    oversized dictionary, whose buffer bytes need not equal its content."""
    if dictionary.offset != 0 or len(dictionary) > (1 << 16):
        return None
    import hashlib

    h = hashlib.sha1()
    for buf in dictionary.buffers():
        if buf is not None:
            h.update(buf)
    return (len(dictionary), h.digest())


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


def hashed_dictionary(col: "Column") -> np.ndarray:
    """uint64 hash per dictionary entry of a STRING column (the HLL
    input), shared like `parsed_dictionary`."""
    from deequ_tpu_torch.ops.strings import hash_strings

    return cached_dictionary_encode(
        col,
        "dicthash",
        lambda c: hash_strings(np.asarray(c.dict_encode()[1], dtype=object)),
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


class LazyColumn(Column):
    """The Column of a column the decode never built at row width (it went
    straight to the wire, or to run streams): its planned readers do not
    touch it, and another reader still gets the exact data, lazily.
    `_rebuild()` builds the Column the ordinary decode would have built;
    `_quick_valid()` may give the mask without it (None: rebuild)."""

    def __init__(self, name: str, ctype: ColumnType, n: int):
        self._lazy_n = int(n)
        self._valid_arr = None
        super().__init__(name, ctype, self._rebuild_values, None)

    def __len__(self) -> int:
        return self._lazy_n

    def _rebuild(self) -> Column:
        raise NotImplementedError

    def _quick_valid(self) -> Optional[np.ndarray]:
        return None

    def _rebuild_values(self):
        col = self._rebuild()
        if self._valid_arr is None:
            self._valid_arr = np.asarray(col.valid)
        return col.values

    @property
    def valid(self):
        if self._valid_arr is None:
            mask = self._quick_valid()
            self._valid_arr = mask if mask is not None else np.asarray(self._rebuild().valid)
        return self._valid_arr

    @valid.setter
    def valid(self, value):
        self._valid_arr = value


def shared_all_true(shared: Dict[str, np.ndarray], n: int) -> np.ndarray:
    """One read-only all-true mask shared by every null-free column of a
    decoded batch. `shared` is the scratch dict of one `from_arrow`."""
    mask = shared.get("all_true")
    if mask is None or len(mask) != n:
        mask = np.ones(n, dtype=bool)
        mask.setflags(write=False)
        shared["all_true"] = mask
    return mask


def pool_empty(n: int, dtype) -> np.ndarray:
    """An uninitialized, writable array in Arrow's memory pool, which
    recycles the pages of earlier batches (a fresh `np.empty` of batch
    size faults on every page at first touch); `np.empty` without
    pyarrow."""
    try:
        import pyarrow as pa
    except ImportError:
        return np.empty(n, dtype=dtype)
    dt = np.dtype(dtype)
    out = np.frombuffer(pa.allocate_buffer(int(n) * dt.itemsize), dtype=dt)
    if not out.flags.writeable:
        raise RuntimeError("pyarrow handed out a read-only buffer")
    return out


def _arrow_logical_decimal(arrow_table, name: str) -> bool:
    """True when a float64 field of an Arrow table (or schema) carries the
    DECIMAL logical-type annotation that `Table.to_arrow` writes."""
    field_ = getattr(arrow_table, "schema", arrow_table).field(name)
    md = field_.metadata or {}
    return md.get(b"deequ_tpu.logical_type") == ColumnType.DECIMAL.value.encode()


def dictionary_uniques_fallback(dictionary) -> np.ndarray:
    """A dictionary's entries as a host object array: the only string
    materialization of a dictionary decode (per-row strings stay lazy)."""
    uniques = dictionary.to_numpy(zero_copy_only=False)
    return uniques.astype(object, copy=False)


def _column_from_arrow_fallback(name, arr, arrow_table, shared) -> Column:
    """One (single-chunk) Arrow array as a Column, on the host. A string
    dictionary array keeps its codes as the column's `dict_encode` and
    builds per-row strings only when `values` is read."""
    import pyarrow as pa

    t = arr.type
    string_dict = pa.types.is_dictionary(t) and (
        pa.types.is_string(t.value_type) or pa.types.is_large_string(t.value_type)
    )
    if pa.types.is_dictionary(t) and not string_dict:
        # only string dictionaries have a code path of their own; others
        # decode to their value type, as the schema reports them
        arr = arr.dictionary_decode()
        t = arr.type
    no_nulls = arr.null_count == 0
    valid = shared_all_true(shared, len(arr)) if no_nulls else np.asarray(arr.is_valid())
    if pa.types.is_boolean(t):
        vals = np.asarray(arr if no_nulls else arr.fill_null(False))
        return Column(name, ColumnType.BOOLEAN, vals, valid)
    if pa.types.is_integer(t):
        vals = np.asarray(arr if no_nulls else arr.fill_null(0)).astype(np.int64, copy=False)
        return Column(name, ColumnType.LONG, vals, valid)
    if pa.types.is_floating(t):
        vals = np.asarray(arr if no_nulls else arr.fill_null(0.0)).astype(np.float64, copy=False)
        nan = np.isnan(vals)
        if nan.any():
            valid = valid & ~nan
            vals = np.where(valid, vals, 0.0)
        # a float64 field that to_arrow annotated keeps its DECIMAL type
        ctype = (
            ColumnType.DECIMAL
            if _arrow_logical_decimal(arrow_table, name)
            else ColumnType.DOUBLE
        )
        return Column(name, ctype, vals, valid)
    if pa.types.is_decimal(t):
        vals = pool_empty(len(arr), np.float64)
        vals[:] = [float(v) if v is not None else 0.0 for v in arr.to_pylist()]
        return Column(name, ColumnType.DECIMAL, vals, valid)
    if pa.types.is_timestamp(t):
        vals = np.asarray(arr.cast(pa.timestamp("us")).fill_null(0))
        return Column(name, ColumnType.TIMESTAMP, vals.astype("datetime64[us]"), valid)
    if string_dict:
        # the codes ARE the dict_encode result (int32 stays int32)
        idx = arr.indices
        if idx.null_count == 0:
            codes = idx.to_numpy(zero_copy_only=True)
        else:
            codes = idx.fill_null(-1).to_numpy(zero_copy_only=False)
        uniques = dictionary_uniques_fallback(arr.dictionary)
        col = Column(
            name,
            ColumnType.STRING,
            lambda: gather_with_null(uniques, codes, ""),
            valid,
        )
        col._cache["dict_encode"] = (codes, uniques)
        col._dict_content_key = _arrow_dictionary_digest(arr.dictionary)
        return col
    if pa.types.is_string(t) or pa.types.is_large_string(t):
        vals = arr.to_numpy(zero_copy_only=False).astype(object, copy=False)
        if not no_nulls:
            vals[~valid] = ""
        col = Column(name, ColumnType.STRING, vals, valid)
        # dict_encode runs Arrow's hash encode on the array it came from
        col._cache["arrow"] = arr
        return col
    vals = np.array(
        [str(v) if v is not None else "" for v in arr.to_pylist()], dtype=object
    )
    return Column(name, ColumnType.STRING, vals, valid)


class Table:
    """Immutable columnar table.

    A batch decoded from Parquet may carry two attachments the fused pass
    reads: `wire_rows` (input key -> runtime.WireRow, the rows the decode
    wrote straight to the wire) and `encfold` (column ->
    data/encfold.py's EncFoldPayload, a column's value multiset folded
    from run streams)."""

    wire_rows = None
    encfold = None

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

    @staticmethod
    def from_pandas(df) -> "Table":
        """Columns from a pandas DataFrame, typed by dtype; object columns
        of bools only are BOOLEAN, other object columns STRING."""
        cols = []
        for name in df.columns:
            s = df[name]
            valid = (~s.isna()).to_numpy(dtype=np.bool_)
            if s.dtype == object or str(s.dtype) in ("string", "str"):
                raw = s.tolist()
                arr = np.array(
                    ["" if not ok else str(v) for v, ok in zip(raw, valid)], dtype=object
                )
                if valid.any() and all(
                    isinstance(v, bool) for v, ok in zip(raw, valid) if ok
                ):
                    barr = np.array(
                        [bool(v) if ok else False for v, ok in zip(raw, valid)], dtype=np.bool_
                    )
                    cols.append(Column(str(name), ColumnType.BOOLEAN, barr, valid))
                    continue
                cols.append(Column(str(name), ColumnType.STRING, arr, valid))
            elif str(s.dtype).startswith("datetime"):
                arr = s.to_numpy(dtype="datetime64[us]")
                arr = np.where(valid, arr, np.datetime64(0, "us"))
                cols.append(Column(str(name), ColumnType.TIMESTAMP, arr, valid))
            elif s.dtype == np.bool_ or str(s.dtype) == "boolean":
                arr = s.fillna(False).to_numpy(dtype=np.bool_)
                cols.append(Column(str(name), ColumnType.BOOLEAN, arr, valid))
            elif str(s.dtype).startswith(("Int", "UInt")) or (
                isinstance(s.dtype, np.dtype) and np.issubdtype(s.dtype, np.integer)
            ):
                arr = s.fillna(0).to_numpy(dtype=np.int64)
                cols.append(Column(str(name), ColumnType.LONG, arr, valid))
            else:
                # float64 and pandas' nullable Float32/Float64
                arr = s.to_numpy(dtype=np.float64, na_value=np.nan)
                valid = valid & ~np.isnan(np.where(valid, arr, 0.0))
                arr = np.where(valid, arr, 0.0)
                cols.append(Column(str(name), ColumnType.DOUBLE, arr, valid))
        return Table(cols)

    @staticmethod
    def from_arrow(arrow_table, fastpath_columns=None, wire=None) -> "Table":
        """An Arrow table as engine Columns. String dictionary columns keep
        their codes; per-row strings stay lazy.

        `fastpath_columns` (a set of names, normally the planner's
        `plan_decode_fastpath` verdict carried by
        `ParquetSource.with_decode_fastpath`) sends those columns through
        the C library's buffer-level decode (data/arrow_decode.py): one
        pass from the Arrow buffers to the Column backing. A column that
        route cannot take decodes on the host; the two give the same
        Columns bit for bit.

        `wire` (a runtime.WireFusionPlan) decodes its columns straight to
        the wire instead: each gets a lazy stub Column and its wire rows
        go on the table's `wire_rows`; a column the wire route cannot take
        this batch (a layout it does not expect, a value past its pinned
        int width) decodes as above."""
        import pyarrow as pa

        cols = []
        wire_rows: Dict[str, object] = {}
        shared: Dict[str, np.ndarray] = {}  # one mask for null-free columns
        fast = wire_fast = None
        if fastpath_columns or (wire is not None and wire.columns):
            from deequ_tpu_torch.data import arrow_decode

            fast, wire_fast = arrow_decode.decode_fast_column, arrow_decode.decode_wire_column
        for name in arrow_table.column_names:
            chunked = arrow_table.column(name)
            chunks = list(chunked.chunks) if isinstance(chunked, pa.ChunkedArray) else [chunked]
            if wire is not None and name in wire.columns:
                fused = wire_fast(name, chunks, arrow_table, wire.columns[name])
                if fused is not None:
                    stub, rows = fused
                    cols.append(stub)
                    wire_rows.update(rows)
                    continue
            if fastpath_columns and name in fastpath_columns:
                col = fast(name, chunks, arrow_table, shared)
                if col is not None:
                    cols.append(col)
                    continue
            # one chunk (every row group and slice) skips the combine copy
            if len(chunks) == 1:
                arr = chunks[0]
            elif not chunks:
                arr = pa.array([], chunked.type)
            else:
                arr = chunked.combine_chunks()
                if isinstance(arr, pa.ChunkedArray):
                    arr = arr.chunk(0)
            cols.append(_column_from_arrow_fallback(name, arr, arrow_table, shared))
        table = Table(cols)
        if wire_rows:
            table.wire_rows = wire_rows
        return table

    def to_arrow(self, dictionary_encode_strings: bool = False):
        """An Arrow table with real nulls (null slots become Arrow nulls,
        not the neutral fill). DECIMAL columns, float64 in memory, are
        written as float64 with the logical type in the field's metadata,
        so a round trip keeps the DecimalType but not more precision than
        float64 holds."""
        import pyarrow as pa

        arrays, fields = [], []
        for name, ctype in self.schema:
            col = self.column(name)
            values = col.values
            valid = np.asarray(col.valid)
            if values.dtype == object:
                # explicit string type: an ALL-NULL column would otherwise
                # infer Arrow's null type, which Parquet cannot dictionary-write
                kind = pa.string() if ctype == ColumnType.STRING else None
                try:
                    arr = pa.array(values, type=kind, mask=~valid)
                except (pa.lib.ArrowException, TypeError):
                    # backing values Arrow will not take as they are
                    arr = pa.array([v if ok else None for v, ok in zip(values, valid)], type=kind)
                if dictionary_encode_strings and pa.types.is_string(arr.type):
                    arr = arr.dictionary_encode()
            else:
                arr = pa.array(values, mask=~valid)
            metadata = (
                {b"deequ_tpu.logical_type": ctype.value.encode()}
                if ctype == ColumnType.DECIMAL
                else None
            )
            fields.append(pa.field(name, arr.type, metadata=metadata))
            arrays.append(arr)
        return pa.table(arrays, schema=pa.schema(fields))

    def to_parquet(
        self,
        path: str,
        row_group_size: Optional[int] = None,
        dictionary_encode_strings: bool = False,
    ) -> None:
        import pyarrow.parquet as pq

        pq.write_table(
            self.to_arrow(dictionary_encode_strings), path, row_group_size=row_group_size
        )

    @staticmethod
    def from_parquet(path: str, columns: Optional[List[str]] = None) -> "Table":
        import pyarrow.parquet as pq

        return Table.from_arrow(pq.read_table(path, columns=columns))

    @staticmethod
    def scan_parquet(path: str, columns: Optional[List[str]] = None, batch_rows: int = 1 << 22):
        """A Parquet file as a streamed source every pass consumes in
        batches of at most `batch_rows` rows: host memory stays bounded,
        and decode overlaps the device's work."""
        from deequ_tpu_torch.data.source import ParquetSource

        return ParquetSource(path, columns=columns, batch_rows=batch_rows)

    @staticmethod
    def scan_parquet_dataset(
        paths, columns: Optional[List[str]] = None, batch_rows: int = 1 << 22
    ):
        """A directory (or a list) of Parquet partition files, folded one
        partition at a time and merged in the files' name order."""
        from deequ_tpu_torch.data.source import PartitionedParquetSource

        return PartitionedParquetSource(paths, columns=columns, batch_rows=batch_rows)

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

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.to_pydict())

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
