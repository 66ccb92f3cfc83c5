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

Two further routes start from the same chunk bytes:
- `assemble_wire_column` writes a decode-to-wire column's batch rows
  straight into its wire rows through the wire kernels
  (arrow_decode.decode_wire_column's contract), with a lazy stub Column;
- `decode_chunk_runs` decodes a dictionary-coded chunk into encoded-run
  streams (`RunChunk`: (run length, dictionary code) value runs and
  definition-level runs) for the encoded fold (data/encfold.py), and
  `expand_runs` expands one back to rows through `read_chunk`.

A function returns None where the C route cannot take the input (a short
read, a page that does not decode); data/source.py then reads that column
through pyarrow, or decodes it at row width.

The JAX counterpart is deequ_tpu/data/native_reader.py (its fault points
are not ported).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from deequ_tpu_torch.data.table import Column, ColumnType, LazyColumn, pool_empty, shared_all_true
from deequ_tpu_torch.ops import native, runtime
from deequ_tpu_torch.testing import faults


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


def fadvise_chunk(fd: int, meta: ChunkMeta) -> None:
    """Tell the kernel the chunk's byte range will be pread soon
    (posix_fadvise WILLNEED), so that its page cache fills while the
    read-ahead slot waits. A hint only: where the platform has no
    posix_fadvise, nothing happens."""
    try:
        os.posix_fadvise(fd, meta.offset, meta.nbytes, os.POSIX_FADV_WILLNEED)
    except (AttributeError, OSError):  # a hint: the pread follows either way
        pass


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
    error (a truncated page, an unexpected encoding, corrupt Thrift) and
    on the `decode.chunk` chaos directive: bad bytes never raise here, the
    column reads through pyarrow."""
    if faults.fault_point("decode.chunk") == "fail":
        return None
    return _decode_rows(raw, meta)


def _decode_rows(raw: np.ndarray, meta: ChunkMeta) -> Optional[DecodedChunk]:
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


#: tokens the runs mode takes: numeric columns whose dictionary rolls up
#: to the engine's int64 or float64 (boolean pages are not
#: dictionary-coded, and uint64 has no exact engine widening)
ENCFOLD_TOKENS = frozenset(
    {"double", "float", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32"}
)


@dataclass
class RunChunk:
    """One column chunk as encoded-run streams instead of rows: coalesced
    (run length, dictionary code) value runs, coalesced (run length,
    present) definition-level runs, and the dictionary rolled up to the
    engine's representation. `raw` keeps the chunk's bytes, so a reader
    the plan did not foresee can still expand it to rows (`expand_runs`)
    through the row route's own decode."""

    meta: ChunkMeta
    raw: np.ndarray  # the chunk's bytes, for a lazy expansion
    kind: str  # "i64" | "f64": the engine representation of dict_values
    dict_values: np.ndarray  # the dictionary as int64 or float64
    run_len: np.ndarray  # int64 coalesced non-null value runs
    run_code: np.ndarray  # uint32 dictionary codes, each < dict_count
    def_len: np.ndarray  # int64 coalesced definition-level runs
    def_val: np.ndarray  # uint8: 0 = null rows, 1 = present rows
    null_count: int
    num_values: int
    pages: int
    uncompressed_bytes: int

    @property
    def dict_count(self) -> int:
        return len(self.dict_values)


def _dict_to_engine(draw: np.ndarray, phys: int, token: str):
    """Dictionary page values (physical layout) in the engine's
    representation, with the widening chain the row route applies to each
    value (a C-cast narrowing to the backing dtype, then the decode's
    widening), so a wrapped entry rolls up to the value its rows would
    have: (values, "i64" | "f64")."""
    phys_np = {1: "<i4", 2: "<i8", 4: "<f4", 5: "<f8"}[int(phys)]
    entries = draw.view(np.dtype(phys_np))
    if token in ("double", "float"):
        return entries.astype(np.float64), "f64"
    backing = native.READER_TOKENS[token][1]
    return entries.astype(np.dtype(backing)).astype(np.int64), "i64"


def decode_chunk_runs(raw: np.ndarray, meta: ChunkMeta) -> Optional[RunChunk]:
    """One raw chunk as encoded-run streams through the C reader's runs
    mode. None on any refusal (a PLAIN data page, an oversized dictionary,
    a corrupt stream) and on the `decode.runs` chaos directive: the
    caller decodes the chunk at row width, so a corrupt run fails closed
    and never folds into wrong values."""
    if faults.fault_point("decode.runs") == "fail":
        return None
    if meta.token not in ENCFOLD_TOKENS:
        return None
    res = native.read_chunk_runs(raw, meta.phys, meta.codec, meta.max_def, meta.num_values)
    if res is None:
        return None
    draw, run_len, run_code, def_len, def_val, nulls, pages, unc, _dcount = res
    # the definition runs must fold to the page loop's null count and the
    # value runs to the non-null count: anything else is a corrupt stream
    def_nulls = native.encfold_def_nulls(def_len, def_val, meta.num_values)
    if def_nulls is None or def_nulls != nulls:
        return None
    if int(run_len.sum()) != meta.num_values - nulls:
        return None
    dict_values, kind = _dict_to_engine(draw, meta.phys, meta.token)
    return RunChunk(
        meta=meta,
        raw=raw,
        kind=kind,
        dict_values=dict_values,
        run_len=run_len,
        run_code=run_code,
        def_len=def_len,
        def_val=def_val,
        null_count=nulls,
        num_values=meta.num_values,
        pages=pages,
        uncompressed_bytes=unc,
    )


def expand_runs(rc: RunChunk) -> Optional[DecodedChunk]:
    """A RunChunk at row width, decoded again from its kept bytes (the
    row route's `decode_chunk` without its chaos point: these bytes have
    decoded once already); None when they do not decode."""
    return _decode_rows(rc.raw, rc.meta)


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


class NativeWireStub(LazyColumn):
    """The Column of a column the C reader decoded straight to the wire:
    `.valid` unpacks the wire bits, `.values` assembles the rows from the
    retained decoded chunks (`assemble_column`)."""

    def __init__(self, name, ctype, token, segments, start, stop, wire_bits):
        self._wire_bits = wire_bits  # None when only values were fused
        self._wire_token = token
        self._wire_segments = segments
        self._wire_start = int(start)
        super().__init__(name, ctype, stop - start)

    def _rebuild(self) -> Column:
        return assemble_column(
            self.name, self._wire_token, self._wire_segments, self._wire_start,
            self._wire_start + len(self), {},
        )

    def _quick_valid(self):
        if self._wire_bits is None:
            return None
        from deequ_tpu_torch.data.arrow_decode import wire_bits_to_mask

        return wire_bits_to_mask(self._wire_bits, len(self))


def assemble_wire_column(
    name: str,
    token: str,
    segments: List[DecodedChunk],
    start: int,
    stop: int,
    spec: "runtime.ColumnWireSpec",
) -> Optional[Tuple[Column, Dict[str, "runtime.WireRow"]]]:
    """Rows [start, stop) of the decoded segments straight to the wire
    rows, through the wire kernels at the running row offset (as
    arrow_decode.decode_wire_column): (stub Column, {input key: WireRow}),
    or None to assemble the Column instead this batch (a value past the
    pinned int width)."""
    if not native.available():
        return None
    n = stop - start
    if n == 0:
        return None
    padded = runtime.wire_pad_size(n)
    # zeroed: a zero pad tail, and the mask row is written by OR
    bits = np.zeros(padded // 8, dtype=np.uint8) if spec.want_valid else None
    vals = np.zeros(padded, dtype=np.dtype(spec.value_dtype)) if spec.want_value else None
    is_float = token in ("double", "float")
    invalid = 0
    pos = 0
    for seg, lo, hi in _segment_overlaps(segments, start, stop):
        m = hi - lo
        if spec.want_value or is_float:
            itemsize = native.DECODE_PRIMITIVES[token][1]
            rc = native.wire_primitive(
                token, seg.values.ctypes.data + lo * itemsize, _validity_addr(seg), lo, m, 0.0,
                vals[pos:] if vals is not None else None, bits, pos,
            )
        else:
            # an int or bool column read for its mask only
            rc = native.wire_valid_bits(_validity_addr(seg), lo, m, bits, pos)
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
        ctype = ColumnType.DOUBLE
    else:
        ctype = ColumnType.LONG
    return NativeWireStub(name, ctype, token, segments, start, stop, bits), rows
