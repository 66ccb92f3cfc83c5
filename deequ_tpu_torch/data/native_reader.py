"""The C Parquet column-chunk reader: from file bytes to engine Columns
without pyarrow.

For a column chunk with a recipe from the footer (data/source.py:
ParquetSource._reader_chunk_meta) this module preads the chunk's byte
range and hands it to the C library's reader (ops/native, parquet_read.c: Thrift
page headers, snappy or zstd page bodies, PLAIN and RLE-dictionary value
decode), which returns Arrow-layout buffers: values in the engine's
dtype with zeros at null slots and an LSB validity bitmap. Assembly into
the Column backing then goes through the same decode kernels the Arrow
fast route uses (data/arrow_decode.py), so a column read here equals the
pyarrow route's bit for bit.

A function returns None where the C route cannot take the input (a short
read, a page that does not decode); data/source.py then reads that column
through pyarrow.

The JAX counterpart is deequ_tpu/data/native_reader.py (its encoded-run
decode, its wire assembly and its fault points are not ported).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from deequ_tpu_torch.data.table import Column, ColumnType, pool_empty, shared_all_true
from deequ_tpu_torch.ops import native


@dataclass(frozen=True)
class ChunkMeta:
    """One column chunk's decode recipe, from the Parquet footer alone."""

    column: str
    token: str  # engine decode token ("double", "int32", "bool", ...)
    dtype: str  # numpy dtype name of the values, or "bits" for bool
    phys: int  # parquet physical type enum (native.READER_PHYS_ENUM)
    codec: int  # parquet codec enum (native.READER_CODEC_ENUM)
    offset: int  # the chunk's first page byte (the dictionary page's, if any)
    nbytes: int  # total_compressed_size: the pread span
    num_values: int
    max_def: int  # 0 = a required column (no validity bitmap in its pages)


@dataclass(frozen=True)
class DecodedChunk:
    """One decoded column chunk in Arrow buffer layout: `values` in the
    engine dtype (an LSB bitmap for bool) with zeros at null slots,
    `validity` the LSB bitmap or None when null-free."""

    token: str
    values: np.ndarray
    validity: Optional[np.ndarray]
    null_count: int
    num_values: int
    pages: int
    uncompressed_bytes: int


def fetch_chunk(fd: int, meta: ChunkMeta) -> Optional[np.ndarray]:
    """pread the chunk's byte range: the raw bytes as uint8, or None on a
    short read (the file changed; the column reads through pyarrow, which
    raises its own error)."""
    raw = os.pread(fd, meta.nbytes, meta.offset)
    if len(raw) != meta.nbytes:
        return None
    return np.frombuffer(raw, dtype=np.uint8)


def decode_chunk(raw: np.ndarray, meta: ChunkMeta) -> Optional[DecodedChunk]:
    """Decode one raw chunk through parquet_read.c. None on any decode
    error (a truncated page, an unexpected encoding, corrupt Thrift):
    bad bytes never raise here, the column reads through pyarrow."""
    nv = meta.num_values
    if meta.token == "bool":
        out_values = np.zeros((nv + 7) // 8, dtype=np.uint8)
        itemsize = 0
    else:
        out_values = np.zeros(nv, dtype=np.dtype(meta.dtype))
        itemsize = out_values.dtype.itemsize
    out_validity = np.zeros((nv + 7) // 8, dtype=np.uint8) if meta.max_def else None
    res = native.read_chunk(
        raw, meta.phys, meta.codec, itemsize, meta.max_def, nv, out_values, out_validity
    )
    if res is None:
        return None
    null_count, pages, uncompressed = res
    return DecodedChunk(
        token=meta.token,
        values=out_values,
        validity=out_validity if null_count else None,
        null_count=null_count,
        num_values=nv,
        pages=pages,
        uncompressed_bytes=uncompressed,
    )


def _segment_overlaps(
    segments: List[DecodedChunk], start: int, stop: int
) -> List[Tuple[DecodedChunk, int, int]]:
    """(segment, local start, local stop) triples covering rows
    [start, stop) of the segments' concatenation."""
    out = []
    base = 0
    for seg in segments:
        lo = max(start, base)
        hi = min(stop, base + seg.num_values)
        if lo < hi:
            out.append((seg, lo - base, hi - base))
        base += seg.num_values
        if base >= stop:
            break
    return out


def _validity_addr(seg: DecodedChunk) -> Optional[int]:
    """The segment's validity bitmap address, or None when null-free (as
    arrow_decode._validity_addr on an Arrow chunk)."""
    if seg.validity is None:
        return None
    return seg.validity.ctypes.data


def assemble_column(
    name: str,
    token: str,
    segments: List[DecodedChunk],
    start: int,
    stop: int,
    shared: Dict[str, np.ndarray],
) -> Column:
    """Rows [start, stop) of the decoded segments as an engine Column,
    through the decode kernels the Arrow fast route uses, on the same
    (address, bit offset) contract: widening, neutral fill, NaN fold and
    the shared all-true mask are those of that route."""
    if not native.available():
        return _assemble_column_numpy_fallback(name, token, segments, start, stop)
    n = stop - start
    is_float = token in ("double", "float")
    is_bool = token == "bool"
    if is_bool:
        out_vals = pool_empty(n, np.bool_)
    else:
        out_vals = pool_empty(n, np.float64 if is_float else np.int64)
    out_valid = pool_empty(n, np.bool_)
    invalid = 0
    pos = 0
    itemsize = 0 if is_bool else native.DECODE_PRIMITIVES[token][1]
    for seg, lo, hi in _segment_overlaps(segments, start, stop):
        m = hi - lo
        if is_bool:
            invalid += native.decode_bool_bitmap(
                seg.values.ctypes.data, lo, _validity_addr(seg), lo, m,
                out_vals[pos:], out_valid[pos:],
            )
        else:
            invalid += native.decode_primitive(
                token, seg.values.ctypes.data + lo * itemsize, _validity_addr(seg), lo, m,
                out_vals[pos:], out_valid[pos:],
            )
        pos += m
    valid = shared_all_true(shared, n) if invalid == 0 else out_valid
    if is_bool:
        ctype = ColumnType.BOOLEAN
    elif is_float:
        # a float64 field annotated DECIMAL never reaches the reader
        # (ParquetSource._reader_chunk_meta leaves it to pyarrow)
        ctype = ColumnType.DOUBLE
    else:
        ctype = ColumnType.LONG
    return Column(name, ctype, out_vals, valid)


def _assemble_column_numpy_fallback(
    name: str, token: str, segments: List[DecodedChunk], start: int, stop: int
) -> Column:
    """decode.c's semantics in numpy (neutral fill 0, float NaN folded
    into the mask, C-cast int widening), for a library turned off after
    the chunks decoded."""
    n = stop - start
    is_float = token in ("double", "float")
    is_bool = token == "bool"
    if is_bool:
        out_vals = np.zeros(n, dtype=np.bool_)
    else:
        out_vals = np.zeros(n, dtype=np.float64 if is_float else np.int64)
    out_valid = np.zeros(n, dtype=np.bool_)
    pos = 0
    for seg, lo, hi in _segment_overlaps(segments, start, stop):
        m = hi - lo
        if seg.validity is None:
            vmask = np.ones(m, dtype=np.bool_)
        else:
            vmask = np.unpackbits(seg.validity, bitorder="little")[lo:hi].astype(np.bool_)
        if is_bool:
            bits = np.unpackbits(seg.values, bitorder="little")[lo:hi]
            out_vals[pos : pos + m] = bits.astype(np.bool_) & vmask
        else:
            vals = seg.values[lo:hi].astype(out_vals.dtype)
            if is_float:
                nan = np.isnan(vals)
                vals = np.where(nan, 0.0, vals)
                vmask = vmask & ~nan
            out_vals[pos : pos + m] = np.where(vmask, vals, 0)
        out_valid[pos : pos + m] = vmask
        pos += m
    ctype = ColumnType.BOOLEAN if is_bool else (ColumnType.DOUBLE if is_float else ColumnType.LONG)
    return Column(name, ctype, out_vals, out_valid)
