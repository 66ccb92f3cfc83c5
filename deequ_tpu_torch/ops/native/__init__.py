"""The C host library: hashing, counts, moments with a decimated sample,
Arrow-buffer decode and a Parquet column-chunk reader, loaded with ctypes.

These are the host loops that are not one vectorized numpy reduction:
the HLL input codes (xxhash64 + leading-zero count + pack in one pass),
dictionary-code counts, the profiler's moments-and-sample selection of a
cast string column, and the decode of Arrow and Parquet buffers into the
engine's Column backing. The sources in this directory are copies of the
JAX package's (deequ_tpu/ops/native/); this module binds the entry points
the port calls.

The library builds with gcc at first use, never at import, into
`deequ_tpu_torch/build/` (a directory git ignores), under a name that
carries a digest of the sources and flags, by an atomic rename, so
processes that build at once never load a half-written file.
`DEEQU_TPU_NO_NATIVE` (any non-empty value) turns the library off: every
caller then takes its numpy route, which gives the same results (the
moments of `masked_moments_select` aside: the C route sums in long
double). Without the switch a failed build or load raises with the
compiler's output; it never falls back on its own. `reset()` forgets the
loaded library, so a test can flip the switch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_PKG_DIR)), "build")
#: every C translation unit of the one library: the digest covers all of
#: them, so editing any source rebuilds
SOURCES = tuple(
    os.path.join(_PKG_DIR, name)
    for name in ("xxhash_hll.c", "decode.c", "parquet_read.c", "encfold.c")
)
# parquet_read.c dlopens the decompressors and guards codec init with
# pthread_once
CFLAGS = ("-O3", "-shared", "-fPIC")
LDFLAGS = ("-ldl", "-lpthread")
COMPILER = "gcc"

_LIB: Optional[ctypes.CDLL] = None
_TRIED = False
_LOCK = threading.Lock()


class NativeBuildError(RuntimeError):
    """The C library failed to build or load; the message carries the
    compiler's output."""


def library_path() -> str:
    digest = hashlib.sha256()
    for source in SOURCES:
        with open(source, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join((COMPILER,) + CFLAGS + LDFLAGS).encode())
    return os.path.join(BUILD_DIR, f"libdeequ_native-{digest.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the library unless this digest's file exists; returns its
    path. Raises NativeBuildError with the compiler's stderr."""
    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [COMPILER, *CFLAGS, *SOURCES, "-o", tmp, *LDFLAGS]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise NativeBuildError(
            f"{COMPILER} failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _bind(lib: ctypes.CDLL) -> None:
    ptr, u8p = ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)
    i32, i64 = ctypes.c_int32, ctypes.c_int64
    lib.xxhash64_pack.argtypes = [
        ctypes.POINTER(ctypes.c_int64), u8p, i64, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.xxhash64_pack.restype = None
    for name in ("bincount_i64", "bincount_i32", "bincount_i8"):
        fn = getattr(lib, name)
        fn.argtypes = [ptr, u8p, i64, i64, i64, ctypes.POINTER(ctypes.c_int64)]
        fn.restype = None
    lib.masked_moments_select.argtypes = [
        ctypes.POINTER(ctypes.c_double), u8p, u8p, i64, i64,
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int, ctypes.POINTER(ctypes.c_int32),
    ]
    lib.masked_moments_select.restype = ctypes.c_int
    # decode.c: values and bitmaps arrive as raw addresses, so a caller
    # passes pre-advanced pointers into Arrow buffers
    for fn_name, _itemsize in DECODE_PRIMITIVES.values():
        fn = getattr(lib, fn_name)
        fn.argtypes = [ptr, ptr, i64, i64, ptr, u8p]
        fn.restype = i64
    lib.decode_bool.argtypes = [ptr, i64, ptr, i64, i64, u8p, u8p]
    lib.decode_bool.restype = i64
    lib.decode_dict_i32.argtypes = [ptr, ptr, i64, i64, ctypes.POINTER(ctypes.c_int32), u8p]
    lib.decode_dict_i32.restype = i64
    # parquet_read.c: page headers, decompression, PLAIN / RLE-dictionary /
    # RLE-boolean decode into the Arrow buffer layout decode.c reads
    lib.pq_reader_codecs.argtypes = []
    lib.pq_reader_codecs.restype = ctypes.c_int
    lib.pq_decode_chunk.argtypes = [ptr, i64, i32, i32, i32, i32, i64, ptr, ptr,
                                    ctypes.POINTER(ctypes.c_int64)]
    lib.pq_decode_chunk.restype = i64


def _load() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        if os.environ.get("DEEQU_TPU_NO_NATIVE"):
            _TRIED = True
            return None
        path = build()
        try:
            lib = ctypes.CDLL(path)
            _bind(lib)
        except (OSError, AttributeError) as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        _LIB, _TRIED = lib, True
        return _LIB


def reset() -> None:
    """Forget the loaded library and the switch's reading: the next call
    reads `DEEQU_TPU_NO_NATIVE` again."""
    global _LIB, _TRIED
    with _LOCK:
        _LIB, _TRIED = None, False


def available() -> bool:
    """Whether the library is on (builds it at the first call)."""
    return _load() is not None


def _u8(mask: Optional[np.ndarray]) -> Optional[np.ndarray]:
    """A contiguous uint8 view of a bool mask (None stays None: all rows)."""
    if mask is None:
        return None
    mask = np.ascontiguousarray(mask)
    if mask.dtype == np.bool_:
        return mask.view(np.uint8)
    return mask.astype(np.uint8, copy=False)


def _u8_ptr(mask: Optional[np.ndarray]):
    return None if mask is None else mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _check_rows(n: int, **masks) -> None:
    """The kernels read one mask byte per row: a shorter mask would be
    read past its end."""
    for name, mask in masks.items():
        if mask is not None and len(mask) != n:
            raise ValueError(f"{name} has {len(mask)} rows, the values {n}")


def xxhash64_pack(values: np.ndarray, valid: np.ndarray) -> Optional[np.ndarray]:
    """(register idx << 6 | rank) int32 per row from canonical int64
    values, 0 for invalid rows; None when the library is off."""
    lib = _load()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.int64)
    valid_u8 = _u8(np.asarray(valid, dtype=np.bool_))
    _check_rows(len(values), valid=valid_u8)
    packed = np.empty(len(values), dtype=np.int32)
    lib.xxhash64_pack(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u8_ptr(valid_u8),
        len(values),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return packed


def bincount(
    codes: np.ndarray, nbins: int, base: int = 0, where: Optional[np.ndarray] = None
) -> Optional[np.ndarray]:
    """int64 counts[c + base] over in-range codes in one pass (no shifted
    copy); None when the library is off. int8, int32 and int64 codes go
    in as they are, other integer types as int64."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes)
    if codes.dtype == np.int8:
        fn = lib.bincount_i8
    elif codes.dtype == np.int32:
        fn = lib.bincount_i32
    else:
        codes = codes.astype(np.int64, copy=False)
        fn = lib.bincount_i64
    where = _u8(where)
    _check_rows(len(codes), where=where)
    out = np.zeros(int(nbins), dtype=np.int64)
    fn(codes.ctypes.data, _u8_ptr(where), len(codes), int(base), int(nbins),
       out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out


def masked_moments_select(
    x: np.ndarray, valid: Optional[np.ndarray], where: Optional[np.ndarray], cap: int
) -> Optional[Tuple[np.ndarray, np.ndarray, int, int]]:
    """The moments [count, sum, min, max, m2, n_where] of the live rows
    (sums in long double) and the quantile sketch's decimated sample,
    ``sorted(x[valid & where])[stride//2::stride][:cap]`` with stride =
    2^ceil(log2(n_valid / cap)), by histogram-assisted selection instead
    of a sort: (moments, sample, n_valid, level). None when the library
    is off; raises when the kernel fails (its scratch allocation)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    valid, where = _u8(valid), _u8(where)
    _check_rows(len(x), valid=valid, where=where)
    samples = np.empty(max(int(cap), 1), dtype=np.float64)
    meta = np.zeros(3, dtype=np.int64)
    mom = np.zeros(6, dtype=np.float64)
    rc = lib.masked_moments_select(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _u8_ptr(valid),
        _u8_ptr(where),
        len(x),
        int(cap),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mom.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        None,
        0,
        None,
    )
    if rc != 0:
        raise RuntimeError(f"masked_moments_select failed ({rc}) on {len(x)} rows, cap {cap}")
    return mom, samples[: int(meta[2])], int(meta[0]), int(meta[1])


#: arrow type token -> (decode.c entry point, value width in bytes)
DECODE_PRIMITIVES = {
    "double": ("decode_f64", 8),
    "float": ("decode_f32", 4),
    "int8": ("decode_i8", 1),
    "int16": ("decode_i16", 2),
    "int32": ("decode_i32", 4),
    "int64": ("decode_i64", 8),
    "uint8": ("decode_u8", 1),
    "uint16": ("decode_u16", 2),
    "uint32": ("decode_u32", 4),
    "uint64": ("decode_u64", 8),
}


def decode_primitive(
    kind: str,
    values_addr: int,
    validity_addr: Optional[int],
    bit_offset: int,
    n: int,
    out_values: np.ndarray,
    out_valid: np.ndarray,
) -> int:
    """One Arrow numeric chunk -> the Column backing in one pass: int64 or
    float64 values with 0 at null slots, a bool mask, NaN folded into the
    mask for floats. `values_addr` points at the chunk's first element;
    `validity_addr` is the bitmap buffer (row i's bit at bit_offset + i)
    or None for a null-free chunk. Writes `n` rows into the output views
    and returns the number of invalid rows."""
    fn = getattr(_load(), DECODE_PRIMITIVES[kind][0])
    return int(
        fn(
            ctypes.c_void_p(values_addr),
            ctypes.c_void_p(validity_addr) if validity_addr else None,
            int(bit_offset),
            int(n),
            out_values.ctypes.data_as(ctypes.c_void_p),
            out_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
    )


def decode_bool_bitmap(
    values_addr: int,
    value_bit_offset: int,
    validity_addr: Optional[int],
    valid_bit_offset: int,
    n: int,
    out_values: np.ndarray,
    out_valid: np.ndarray,
) -> int:
    """An Arrow boolean chunk (its values are a bitmap) -> bool values
    (null -> False) and mask in one pass; returns the invalid-row count."""
    return int(
        _load().decode_bool(
            ctypes.c_void_p(values_addr),
            int(value_bit_offset),
            ctypes.c_void_p(validity_addr) if validity_addr else None,
            int(valid_bit_offset),
            int(n),
            out_values.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            out_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
    )


def decode_dict_codes(
    indices_addr: int,
    validity_addr: Optional[int],
    bit_offset: int,
    n: int,
    out_codes: np.ndarray,
    out_valid: np.ndarray,
) -> int:
    """A dictionary column's int32 index buffer -> dictionary codes (null
    -> -1) and mask in one pass; returns the invalid-row count."""
    return int(
        _load().decode_dict_i32(
            ctypes.c_void_p(indices_addr),
            ctypes.c_void_p(validity_addr) if validity_addr else None,
            int(bit_offset),
            int(n),
            out_codes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out_valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
    )


#: arrow type token -> (parquet physical types that may back it, engine
#: numpy dtype name). The reader's recipes (data/source.py:
#: ParquetSource._reader_chunk_meta) key off this map. uint32 may be stored as INT64 or INT32 (writer-dependent);
#: "bits" marks booleans, whose out buffer is an LSB bitmap.
READER_TOKENS = {
    "double": (("DOUBLE",), "float64"),
    "float": (("FLOAT",), "float32"),
    "int8": (("INT32",), "int8"),
    "int16": (("INT32",), "int16"),
    "int32": (("INT32",), "int32"),
    "int64": (("INT64",), "int64"),
    "uint8": (("INT32",), "uint8"),
    "uint16": (("INT32",), "uint16"),
    "uint32": (("INT64", "INT32"), "uint32"),
    "uint64": (("INT64",), "uint64"),
    "bool": (("BOOLEAN",), "bits"),
}

#: parquet physical-type name -> format enum (parquet_read.c)
READER_PHYS_ENUM = {"BOOLEAN": 0, "INT32": 1, "INT64": 2, "FLOAT": 4, "DOUBLE": 5}

#: parquet codec name -> format enum (parquet_read.c)
READER_CODEC_ENUM = {"UNCOMPRESSED": 0, "SNAPPY": 1, "ZSTD": 6}

#: parquet codec name -> pq_reader_codecs() capability bit
READER_CODEC_MASK = {"UNCOMPRESSED": 1, "SNAPPY": 2, "ZSTD": 4}

#: page encodings the reader decodes; any other (BIT_PACKED, DELTA_*,
#: BYTE_STREAM_SPLIT) leaves the column to pyarrow
READER_ENCODINGS = frozenset({"PLAIN", "RLE", "PLAIN_DICTIONARY", "RLE_DICTIONARY"})


def reader_codecs() -> int:
    """Bitmask of the decompression codecs the reader can use on this
    host (READER_CODEC_MASK; snappy and zstd load by dlopen); 0 when the
    library is off."""
    lib = _load()
    if lib is None:
        return 0
    return int(lib.pq_reader_codecs())


def read_chunk(
    chunk: np.ndarray,
    phys: int,
    codec: int,
    out_itemsize: int,
    max_def: int,
    num_values: int,
    out_values: np.ndarray,
    out_validity: Optional[np.ndarray],
) -> Optional[Tuple[int, int, int]]:
    """Decode one raw column-chunk byte range (dictionary page and data
    pages) into caller-zeroed Arrow-layout buffers: `out_values` gets the
    values (an LSB bitmap for booleans) with zeros at null slots,
    `out_validity` (an LSB bitmap, required when max_def == 1) its bits
    set at non-null rows. Returns (null_count, pages, uncompressed bytes),
    or None when the bytes do not decode (truncated or corrupt pages, an
    unexpected encoding): the caller reads the column through pyarrow."""
    info = np.zeros(3, dtype=np.int64)
    rc = int(
        _load().pq_decode_chunk(
            chunk.ctypes.data_as(ctypes.c_void_p),
            int(len(chunk)),
            int(phys),
            int(codec),
            int(out_itemsize),
            int(max_def),
            int(num_values),
            out_values.ctypes.data_as(ctypes.c_void_p),
            out_validity.ctypes.data_as(ctypes.c_void_p) if out_validity is not None else None,
            info.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    )
    if rc < 0:
        return None
    return rc, int(info[0]), int(info[1])
