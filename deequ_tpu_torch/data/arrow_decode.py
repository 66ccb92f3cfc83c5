"""Buffer-level Arrow decode: the fast route of `Table.from_arrow`.

For a column the planner approves (ops/fused.py:plan_decode_fastpath)
this module walks the column's chunks and hands each chunk's raw buffers
(values, the validity bitmap, a dictionary's index buffer) to the C
library's decode kernels (ops/native, decode.c), which write the engine
Column backing in one pass: the neutral fill at null slots, a bool mask,
NaN folded into the mask for floats. No intermediate numpy arrays, no
byte expansion of the bitmap, no fill_null copy.

Every function returns None where the C route cannot take the input (an
unexpected buffer layout, a dictionary in more than one chunk);
`Table.from_arrow` then decodes the column on its host route. Both
routes give the same Columns bit for bit, so the choice only moves
decode time.

`decode_wire_column` goes one step further for a column whose every
reader is the device program (ops/fused.py:classify_wire_columns): its
chunks decode straight into the wire rows `pack_batch_inputs` would have
built (MSB-first mask bits, a narrow-int or float64 value row), and a
lazy stub stands in for the Column.

The JAX counterpart is deequ_tpu/data/arrow_decode.py.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from deequ_tpu_torch.data.table import (
    Column,
    ColumnType,
    LazyColumn,
    _arrow_dictionary_digest,
    _arrow_logical_decimal,
    _column_from_arrow_fallback,
    dictionary_uniques_fallback,
    gather_with_null,
    pool_empty,
    shared_all_true,
)
from deequ_tpu_torch.ops import native, runtime


def decode_fast_column(
    name: str, chunks: List, arrow_table, shared: Dict[str, np.ndarray]
) -> Optional[Column]:
    """Decode one column's chunks through the C kernels, each chunk at its
    row offset into one preallocated output (no concatenation copy).
    Returns None to send the column to the host route."""
    import pyarrow as pa

    if not chunks or not native.available():
        return None
    t = chunks[0].type
    if pa.types.is_dictionary(t):
        return _decode_dictionary(name, chunks, shared)
    if pa.types.is_boolean(t):
        return _decode_boolean(name, chunks, shared)
    spec = native.DECODE_PRIMITIVES.get(str(t))
    if spec is None:
        return None
    return _decode_primitive(name, chunks, arrow_table, shared, str(t), spec)


def _validity_addr(arr) -> Optional[int]:
    """Address of the chunk's validity bitmap, or None when null-free.
    A chunk with nulls always has buffer 0 in Arrow's layout."""
    bufs = arr.buffers()
    if arr.null_count == 0 or bufs[0] is None:
        return None
    return bufs[0].address


def _decode_primitive(name, chunks, arrow_table, shared, kind, spec):
    _fn_name, itemsize = spec
    is_float = kind in ("double", "float")
    n = sum(len(c) for c in chunks)
    out_vals = pool_empty(n, np.float64 if is_float else np.int64)
    out_valid = pool_empty(n, np.bool_)
    invalid = 0
    pos = 0
    for ch in chunks:
        bufs = ch.buffers()
        if len(bufs) != 2 or bufs[1] is None:
            return None
        invalid += native.decode_primitive(
            kind,
            bufs[1].address + ch.offset * itemsize,
            _validity_addr(ch),
            ch.offset,
            len(ch),
            out_vals[pos:],
            out_valid[pos:],
        )
        pos += len(ch)
    # no invalid row: null-free chunks and (for floats) no NaN, the two
    # cases in which the host route shares the all-true mask
    valid = shared_all_true(shared, n) if invalid == 0 else out_valid
    if is_float:
        ctype = (
            ColumnType.DECIMAL if _arrow_logical_decimal(arrow_table, name) else ColumnType.DOUBLE
        )
    else:
        ctype = ColumnType.LONG
    return Column(name, ctype, out_vals, valid)


def _decode_boolean(name, chunks, shared):
    n = sum(len(c) for c in chunks)
    out_vals = pool_empty(n, np.bool_)
    out_valid = pool_empty(n, np.bool_)
    invalid = 0
    pos = 0
    for ch in chunks:
        bufs = ch.buffers()
        if len(bufs) != 2 or bufs[1] is None:
            return None
        # the values buffer is itself a bitmap sharing the chunk's offset
        invalid += native.decode_bool_bitmap(
            bufs[1].address,
            ch.offset,
            _validity_addr(ch),
            ch.offset,
            len(ch),
            out_vals[pos:],
            out_valid[pos:],
        )
        pos += len(ch)
    valid = shared_all_true(shared, n) if invalid == 0 else out_valid
    return Column(name, ColumnType.BOOLEAN, out_vals, valid)


def wire_bits_to_mask(bits: np.ndarray, n: int) -> np.ndarray:
    """A wire mask row (MSB-first bits) back as a Column mask."""
    return np.unpackbits(bits[: (n + 7) // 8], count=n).astype(np.bool_)


def _rebuild_column(name, chunks, arrow_table) -> Column:
    """The Column a wire-fused column would have had: the same decode it
    takes without fusion (the C kernels, else the host chain)."""
    import pyarrow as pa

    shared: Dict[str, np.ndarray] = {}
    col = decode_fast_column(name, chunks, arrow_table, shared)
    if col is not None:
        return col
    if len(chunks) == 1:
        arr = chunks[0]
    else:
        arr = pa.chunked_array(chunks).combine_chunks()
    return _column_from_arrow_fallback(name, arr, arrow_table, shared)


class WireStubColumn(LazyColumn):
    """The Column of a column decoded straight to the wire: `.valid`
    unpacks the wire bits, `.values` decodes the retained Arrow chunks
    again."""

    def __init__(self, name, ctype, n, chunks, arrow_table, wire_bits):
        self._wire_bits = wire_bits  # None when only values were fused
        self._wire_chunks = chunks
        self._wire_arrow = arrow_table
        super().__init__(name, ctype, n)

    def _rebuild(self) -> Column:
        return _rebuild_column(self.name, self._wire_chunks, self._wire_arrow)

    def _quick_valid(self):
        if self._wire_bits is None:
            return None
        return wire_bits_to_mask(self._wire_bits, len(self))


def decode_wire_column(name, chunks, arrow_table, spec: "runtime.ColumnWireSpec"):
    """One column's chunks straight to its wire rows: (stub Column,
    {input key: runtime.WireRow}), or None to decode the column as usual
    this batch (a chunk type or layout other than the plan's, or a value
    past the pinned int width). Each chunk writes at its running row
    offset, so a chunk that ends inside a byte continues there in the
    shared mask row (the kernels only OR bits in)."""
    if not chunks or not native.available():
        return None
    token = str(chunks[0].type)
    if token != spec.token or any(str(c.type) != token for c in chunks):
        return None
    n = sum(len(c) for c in chunks)
    if n == 0:
        return None
    padded = runtime.wire_pad_size(n)
    # zeroed: the pad tail must be zero, as in pack_batch_inputs' buffers,
    # and the mask row is written by OR
    bits = np.zeros(padded // 8, dtype=np.uint8) if spec.want_valid else None
    vals = np.zeros(padded, dtype=np.dtype(spec.value_dtype)) if spec.want_value else None
    is_float = token in ("double", "float")
    invalid = 0
    pos = 0
    for ch in chunks:
        m = len(ch)
        if m == 0:
            continue
        if spec.want_value or is_float:
            bufs = ch.buffers()
            if len(bufs) != 2 or bufs[1] is None:
                return None
            itemsize = native.DECODE_PRIMITIVES[token][1]
            rc = native.wire_primitive(
                token, bufs[1].address + ch.offset * itemsize, _validity_addr(ch), ch.offset, m,
                0.0, vals[pos:] if vals is not None else None, bits, pos,
            )
        else:
            # an int or bool column read for its mask only: the bits come
            # from the validity bitmap (no NaN to fold)
            rc = native.wire_valid_bits(_validity_addr(ch), ch.offset, m, bits, pos)
        if rc is None:
            return None
        invalid += rc
        pos += m
    rows: Dict[str, runtime.WireRow] = {}
    if spec.want_value:
        rows[f"num:{name}"] = runtime.WireRow(kind=spec.value_kind, arr=vals)
    if spec.want_valid:
        rows[f"valid:{name}"] = runtime.WireRow(kind="bits", arr=bits, all_valid=invalid == 0)
    if token == "bool":
        ctype = ColumnType.BOOLEAN
    elif is_float:
        ctype = ColumnType.DECIMAL if _arrow_logical_decimal(arrow_table, name) else ColumnType.DOUBLE
    else:
        ctype = ColumnType.LONG
    return WireStubColumn(name, ctype, n, list(chunks), arrow_table, bits), rows


def _decode_dictionary(name, chunks, shared):
    """dictionary<string, int32> through the index-buffer kernel. A
    dictionary column in more than one chunk needs its dictionaries
    unified, which only the host route's combine_chunks does."""
    import pyarrow as pa

    if len(chunks) != 1:
        return None
    arr = chunks[0]
    t = arr.type
    if not (pa.types.is_string(t.value_type) or pa.types.is_large_string(t.value_type)):
        return None
    if t.index_type != pa.int32():
        return None
    idx = arr.indices
    bufs = idx.buffers()
    if len(bufs) != 2 or bufs[1] is None:
        return None
    n = len(idx)
    codes = pool_empty(n, np.int32)
    out_valid = pool_empty(n, np.bool_)
    invalid = native.decode_dict_codes(
        bufs[1].address + idx.offset * 4,
        _validity_addr(idx),
        idx.offset,
        n,
        codes,
        out_valid,
    )
    valid = shared_all_true(shared, n) if invalid == 0 else out_valid
    uniques = dictionary_uniques_fallback(arr.dictionary)
    col = Column(
        name,
        ColumnType.STRING,
        lambda codes=codes, uniques=uniques: gather_with_null(uniques, codes, ""),
        valid,
    )
    col._cache["dict_encode"] = (codes, uniques)
    col._dict_content_key = _arrow_dictionary_digest(arr.dictionary)
    return col
