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

The JAX counterpart is deequ_tpu/data/arrow_decode.py (its wire route,
which decodes straight into the packed device format, is not ported).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from deequ_tpu_torch.data.table import (
    Column,
    ColumnType,
    _arrow_dictionary_digest,
    _arrow_logical_decimal,
    dictionary_uniques_fallback,
    gather_with_null,
    pool_empty,
    shared_all_true,
)
from deequ_tpu_torch.ops import native


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
