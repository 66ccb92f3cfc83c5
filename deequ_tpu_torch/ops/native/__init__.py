"""The C host library: hashing, counts, moments with a decimated sample,
Arrow-buffer decode, decode-to-wire, a Parquet column-chunk reader and
the encoded fold's run-stream kernels, loaded with ctypes.

These are the host loops that are not one vectorized numpy reduction:
the HLL input codes (xxhash64 + leading-zero count + pack in one pass)
and register scatter, dictionary-code and windowed or hashed value
counts, the moments and decimated quantile samples of host-folded
families (one column or many in one traversal), and the decode of Arrow
and Parquet buffers into the engine's Column backing, into wire rows or
into run streams. The sources in this directory are copies of the JAX
package's (deequ_tpu/ops/native/); this module binds their entry points
with the JAX package's contracts: a wrapper returns None (or False) when
the library is off or when the input is not for its kernel, and the
caller takes its other route; it never means that the build failed.

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

import functools

import numpy as np

from deequ_tpu_torch import observe

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


def _traced_kernel(fn):
    """One `native:<name>` span per call of a C kernel, with the length of
    its first array argument as `n`. Untraced, it costs one call and the
    span's thread-local probe."""
    name = f"native:{fn.__name__}"

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        kernel_sp = observe.span(name, cat="native")
        if not kernel_sp:
            return fn(*args, **kwargs)
        with kernel_sp:
            first = args[0] if args else None
            if hasattr(first, "__len__"):
                kernel_sp.set(n=len(first))
            return fn(*args, **kwargs)

    return wrapper


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
    dp, i64p = ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64)
    lib.masked_moments.argtypes = [dp, u8p, u8p, i64, dp]
    lib.masked_moments.restype = None
    lib.hll_update_registers.argtypes = [ctypes.POINTER(ctypes.c_int32), u8p, i64,
                                         ctypes.POINTER(ctypes.c_int32)]
    lib.hll_update_registers.restype = None
    lib.hashcount_u64.argtypes = [ctypes.POINTER(ctypes.c_uint64), u8p, u8p, i64, i64, i64, i64,
                                  ctypes.POINTER(ctypes.c_uint64), i64p, i64p]
    lib.hashcount_u64.restype = i64
    lib.bincount_window_i64.argtypes = [i64p, u8p, u8p, i64, i64, i64, i64p, i64p]
    lib.bincount_window_i64.restype = None
    lib.masked_select_decimate.argtypes = [dp, u8p, u8p, i64, i64, dp, i64p]
    lib.masked_select_decimate.restype = ctypes.c_int
    lib.masked_moments_select_multi.argtypes = [
        ctypes.POINTER(dp), ctypes.POINTER(u8p), u8p, i64, i64, i64, dp, i64p, dp,
        ctypes.POINTER(i64p), ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    lib.masked_moments_select_multi.restype = ctypes.c_int
    # decode.c's wire kernels: the same raw-address convention, writing the
    # wire buffers (an MSB-first mask row, a value row) at a row offset
    lib.wire_valid_bits.argtypes = [ptr, i64, i64, u8p, i64]
    lib.wire_valid_bits.restype = i64
    for name in _WIRE_FLOAT_KERNELS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i64, i64, ctypes.c_double, ptr, u8p, i64]
        fn.restype = i64
    for name in _WIRE_INT_KERNELS.values():
        fn = getattr(lib, name)
        fn.argtypes = [ptr, ptr, i64, i64, ctypes.c_int, ctypes.c_double, ptr, u8p, i64]
        fn.restype = i64
    # encfold.c and parquet_read.c's runs mode: encoded-run streams
    lib.pq_decode_chunk_runs.argtypes = [ptr, i64, i32, i32, i32, i64, ptr, i64, ptr, ptr, i64,
                                         ptr, ptr, i64, i64p]
    lib.pq_decode_chunk_runs.restype = i64
    lib.encfold_code_counts.argtypes = [ptr, ptr, i64, i64, ptr]
    lib.encfold_code_counts.restype = i64
    lib.encfold_def_nulls.argtypes = [ptr, ptr, i64, i64]
    lib.encfold_def_nulls.restype = i64
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


@_traced_kernel
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


@_traced_kernel
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


@_traced_kernel
def masked_moments(
    x: np.ndarray, valid: Optional[np.ndarray], where: Optional[np.ndarray]
) -> Optional[np.ndarray]:
    """The moments [count, sum, min, max, m2, n_where] of x's live rows
    (valid & where; None = every row) in one pass; None when the library
    is off."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    valid, where = _u8(valid), _u8(where)
    _check_rows(len(x), valid=valid, where=where)
    out = np.empty(6, dtype=np.float64)
    lib.masked_moments(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _u8_ptr(valid), _u8_ptr(where), len(x),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


@_traced_kernel
def hll_update_registers(
    packed: np.ndarray, where: Optional[np.ndarray], registers: np.ndarray
) -> bool:
    """Fold packed (idx << 6 | rank) codes of the `where` rows (None =
    every row) into the int32 `registers` in place, by register max;
    False when the library is off."""
    lib = _load()
    if lib is None:
        return False
    packed = np.ascontiguousarray(packed, dtype=np.int32)
    where = _u8(where)
    _check_rows(len(packed), where=where)
    if registers.dtype != np.int32 or not registers.flags.c_contiguous or len(registers) != 512:
        raise ValueError("registers must be 512 contiguous int32")
    lib.hll_update_registers(
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), _u8_ptr(where), len(packed),
        registers.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return True


_HASHCOUNT_LOG2 = 17  # 131,072 slots: a load factor of at most 0.5
_HASHCOUNT_MAX_DISTINCT = 1 << 16


@_traced_kernel
def hashcount(
    keys_u64: np.ndarray,
    valid: Optional[np.ndarray],
    where: Optional[np.ndarray],
    max_distinct: int = _HASHCOUNT_MAX_DISTINCT,
):
    """Counts of the distinct 8-byte keys (float64 bit patterns or int64
    values) of the live rows, in one open-addressing pass:
    (distinct keys as uint64, counts, n_valid, n_where). None when the
    library is off or the column holds more than `max_distinct` distinct
    values (the kernel stops after a bounded prefix)."""
    lib = _load()
    if lib is None:
        return None
    keys_u64 = np.ascontiguousarray(keys_u64)
    if keys_u64.dtype != np.uint64:
        keys_u64 = keys_u64.view(np.uint64)
    valid, where = _u8(valid), _u8(where)
    _check_rows(len(keys_u64), valid=valid, where=where)
    slots = 1 << _HASHCOUNT_LOG2
    table_keys = np.zeros(slots, dtype=np.uint64)
    table_counts = np.zeros(slots, dtype=np.int64)
    meta = np.zeros(2, dtype=np.int64)
    cap = int(min(max_distinct, _HASHCOUNT_MAX_DISTINCT))
    distinct = lib.hashcount_u64(
        keys_u64.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        _u8_ptr(valid), _u8_ptr(where), len(keys_u64), _HASHCOUNT_LOG2, cap, 4 * cap,
        table_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        table_counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if distinct < 0:
        return None
    occupied = table_counts > 0
    return table_keys[occupied], table_counts[occupied], int(meta[0]), int(meta[1])


@_traced_kernel
def bincount_window(
    values: np.ndarray,
    valid: Optional[np.ndarray],
    where: Optional[np.ndarray],
    lo: int,
    nbins: int,
):
    """Counts of an int64 column's live values over [lo, lo + nbins) in
    one pass: (counts, n_valid, n_where). None when the library is off or
    a live value falls outside the window (the pass stops there)."""
    lib = _load()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.int64)
    valid, where = _u8(valid), _u8(where)
    _check_rows(len(values), valid=valid, where=where)
    counts = np.zeros(int(nbins), dtype=np.int64)
    meta = np.zeros(3, dtype=np.int64)
    lib.bincount_window_i64(
        values.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        _u8_ptr(valid), _u8_ptr(where), len(values), int(lo), int(nbins),
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if meta[2]:
        return None
    return counts, int(meta[0]), int(meta[1])


@_traced_kernel
def masked_select_decimate(
    x: np.ndarray, valid: Optional[np.ndarray], where: Optional[np.ndarray], cap: int
):
    """The quantile sketch's decimated sample of one batch,
    ``sorted(x[valid & where])[stride//2::stride][:cap]`` with stride =
    2^ceil(log2(n_valid / cap)), by histogram-assisted selection:
    (sample, n_valid, level). None when the library is off."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    valid, where = _u8(valid), _u8(where)
    _check_rows(len(x), valid=valid, where=where)
    samples = np.empty(max(int(cap), 1), dtype=np.float64)
    meta = np.zeros(3, dtype=np.int64)
    rc = lib.masked_select_decimate(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _u8_ptr(valid), _u8_ptr(where), len(x), int(cap),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise RuntimeError(f"masked_select_decimate failed ({rc}) on {len(x)} rows, cap {cap}")
    return samples[: int(meta[2])], int(meta[0]), int(meta[1])


@_traced_kernel
def masked_moments_select(
    x: np.ndarray,
    valid: Optional[np.ndarray],
    where: Optional[np.ndarray],
    cap: int,
    hll_mode: int = 0,
    hashvals: Optional[np.ndarray] = None,
):
    """The moments [count, sum, min, max, m2, n_where] of the live rows
    (sums in long double) and the quantile sketch's decimated sample,
    ``sorted(x[valid & where])[stride//2::stride][:cap]`` with stride =
    2^ceil(log2(n_valid / cap)), by histogram-assisted selection instead
    of a sort. `hll_mode` folds the HLL registers into the same pass: 1
    hashes x's float64 bit pattern, 2 the canonical int64 `hashvals`.
    Returns (moments, sample, n_valid, level, registers or None); None
    when the library is off; raises when the kernel fails (its scratch
    allocation)."""
    lib = _load()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    valid, where = _u8(valid), _u8(where)
    _check_rows(len(x), valid=valid, where=where)
    samples = np.empty(max(int(cap), 1), dtype=np.float64)
    meta = np.zeros(3, dtype=np.int64)
    mom = np.zeros(6, dtype=np.float64)
    hash_ptr = regs = regs_ptr = None
    if hll_mode == 2 and hashvals is not None:
        hashvals = np.ascontiguousarray(hashvals, dtype=np.int64)
        _check_rows(len(x), hashvals=hashvals)
        hash_ptr = hashvals.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    elif hll_mode == 2:
        hll_mode = 0
    if hll_mode:
        regs = np.zeros(512, dtype=np.int32)
        regs_ptr = regs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.masked_moments_select(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        _u8_ptr(valid),
        _u8_ptr(where),
        len(x),
        int(cap),
        samples.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        meta.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        mom.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        hash_ptr,
        int(hll_mode),
        regs_ptr,
    )
    if rc != 0:
        raise RuntimeError(f"masked_moments_select failed ({rc}) on {len(x)} rows, cap {cap}")
    return mom, samples[: int(meta[2])], int(meta[0]), int(meta[1]), regs


@_traced_kernel
def masked_moments_select_multi(columns, where: Optional[np.ndarray], cap: int):
    """`masked_moments_select` for K columns of one row count in one
    row-blocked traversal. `columns` holds (x, valid or None, hll_mode,
    hashvals or None) per column; `where` is the group's shared mask.
    Returns one (moments, sample, n_valid, level, registers or None) per
    column, each the bits a solo call gives; None when the library is
    off or the lengths disagree (the caller runs the solo kernel)."""
    lib = _load()
    if lib is None:
        return None
    k = len(columns)
    if k == 0:
        return []
    PD = ctypes.POINTER(ctypes.c_double)
    PU8 = ctypes.POINTER(ctypes.c_uint8)
    PI64 = ctypes.POINTER(ctypes.c_int64)
    xptrs, vptrs, hptrs = (PD * k)(), (PU8 * k)(), (PI64 * k)()
    modes = np.zeros(k, dtype=np.int32)
    keep = []  # the converted arrays, alive for the call
    n = None
    for idx, (x, valid, hll_mode, hashvals) in enumerate(columns):
        x = np.ascontiguousarray(x, dtype=np.float64)
        if n is None:
            n = len(x)
        elif len(x) != n:
            return None
        keep.append(x)
        xptrs[idx] = x.ctypes.data_as(PD)
        v = _u8(valid)
        if v is not None:
            if len(v) != n:
                return None
            keep.append(v)
            vptrs[idx] = v.ctypes.data_as(PU8)
        if hll_mode == 2 and hashvals is not None:
            hv = np.ascontiguousarray(hashvals, dtype=np.int64)
            if len(hv) != n:
                return None
            keep.append(hv)
            hptrs[idx] = hv.ctypes.data_as(PI64)
        elif hll_mode == 2:
            hll_mode = 0
        modes[idx] = int(hll_mode)
    where = _u8(where)
    if where is not None and len(where) != n:
        return None
    cap = max(int(cap), 1)
    samples = np.empty((k, cap), dtype=np.float64)
    meta = np.zeros((k, 3), dtype=np.int64)
    mom = np.zeros((k, 6), dtype=np.float64)
    regs = np.zeros((k, 512), dtype=np.int32) if modes.any() else None
    rc = lib.masked_moments_select_multi(
        xptrs, vptrs, _u8_ptr(where), n, k, cap,
        samples.ctypes.data_as(PD), meta.ctypes.data_as(PI64), mom.ctypes.data_as(PD),
        hptrs, modes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        regs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)) if regs is not None else None,
    )
    del keep
    if rc != 0:
        return None
    return [
        (
            mom[i].copy(),
            samples[i, : int(meta[i, 2])].copy(),
            int(meta[i, 0]),
            int(meta[i, 1]),
            regs[i].copy() if regs is not None and modes[i] else None,
        )
        for i in range(k)
    ]


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


@_traced_kernel
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


@_traced_kernel
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


@_traced_kernel
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


#: (Arrow float token, wire value dtype) -> decode-to-wire entry point
_WIRE_FLOAT_KERNELS = {
    ("double", "float64"): "wire_f64",
    ("double", "float32"): "wire_f64_to_f32",
    ("float", "float64"): "wire_f32_to_f64",
    ("float", "float32"): "wire_f32",
}

#: Arrow int token -> decode-to-wire entry point (uint64 is absent: its
#: int64 wrap stays on the Column route)
_WIRE_INT_KERNELS = {
    "int8": "wire_i8",
    "int16": "wire_i16",
    "int32": "wire_i32",
    "int64": "wire_i64",
    "uint8": "wire_u8",
    "uint16": "wire_u16",
    "uint32": "wire_u32",
}

#: wire value dtype -> the int kernels' output selector
_WIRE_OUT_CODES = {"int8": 0, "int16": 1, "int32": 2, "float64": 3, "float32": 4}


def wire_supported(token: str, out_dtype_name: str) -> bool:
    """Whether a decode-to-wire kernel takes (Arrow type token, wire value
    dtype): the planner approves no column the decode cannot take."""
    if (token, out_dtype_name) in _WIRE_FLOAT_KERNELS:
        return True
    return token in _WIRE_INT_KERNELS and out_dtype_name in _WIRE_OUT_CODES


@_traced_kernel
def wire_valid_bits(
    validity_addr: Optional[int], bit_offset: int, n: int, out_bits: np.ndarray, out_bit_offset: int
) -> Optional[int]:
    """An LSB validity bitmap (None = null-free) as wire mask bits, MSB
    first as np.packbits packs them, OR-ed into the zeroed `out_bits` from
    bit `out_bit_offset`; returns the invalid-row count, None when the
    library is off."""
    lib = _load()
    if lib is None:
        return None
    return int(
        lib.wire_valid_bits(
            ctypes.c_void_p(validity_addr) if validity_addr else None,
            int(bit_offset),
            int(n),
            out_bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            int(out_bit_offset),
        )
    )


@_traced_kernel
def wire_primitive(
    token: str,
    values_addr: int,
    validity_addr: Optional[int],
    bit_offset: int,
    n: int,
    shift: float,
    out_values: Optional[np.ndarray],
    out_bits: Optional[np.ndarray],
    out_bit_offset: int,
) -> Optional[int]:
    """One Arrow numeric chunk straight to the wire in one pass: the value
    row in `out_values`' dtype (0 at invalid rows; ints checked against the
    pinned narrow width) and the MSB mask bits (validity, with NaN folded
    in) OR-ed into `out_bits` from `out_bit_offset`; either output may be
    None. Returns the invalid-row count, or None when the library is off,
    no kernel takes the pair, or a value overflows the pinned width (the
    caller builds the Column instead)."""
    lib = _load()
    if lib is None:
        return None
    out_dtype_name = out_values.dtype.name if out_values is not None else None
    bits_ptr = (
        out_bits.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)) if out_bits is not None else None
    )
    vals_ptr = out_values.ctypes.data_as(ctypes.c_void_p) if out_values is not None else None
    validity_ptr = ctypes.c_void_p(validity_addr) if validity_addr else None
    if token in ("double", "float"):
        name = _WIRE_FLOAT_KERNELS.get((token, out_dtype_name or "float64"))
        if name is None:
            return None
        rc = getattr(lib, name)(
            ctypes.c_void_p(values_addr), validity_ptr, int(bit_offset), int(n), float(shift),
            vals_ptr, bits_ptr, int(out_bit_offset),
        )
    else:
        name = _WIRE_INT_KERNELS.get(token)
        code = _WIRE_OUT_CODES.get(out_dtype_name or "")
        if name is None or code is None:
            return None
        rc = getattr(lib, name)(
            ctypes.c_void_p(values_addr), validity_ptr, int(bit_offset), int(n), int(code),
            float(shift), vals_ptr, bits_ptr, int(out_bit_offset),
        )
    rc = int(rc)
    return None if rc < 0 else rc


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


@_traced_kernel
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


#: the dictionary entries the runs mode accepts per chunk; a larger
#: dictionary fails the chunk, which then decodes at row width
ENCFOLD_DICT_CAP = 65536


@_traced_kernel
def read_chunk_runs(
    chunk: np.ndarray,
    phys: int,
    codec: int,
    max_def: int,
    num_values: int,
    cap_dict: int = ENCFOLD_DICT_CAP,
) -> Optional[tuple]:
    """Decode one raw column chunk into encoded-run streams instead of
    rows: coalesced (run length, dictionary code) value runs and
    (run length, present) definition-level runs, with the dictionary
    page's values in their physical layout. Only fully dictionary-coded
    chunks qualify: a PLAIN data page, a boolean column, an oversized
    dictionary or corrupt bytes give None (the caller decodes the chunk
    at row width). Returns (dictionary bytes, run_len, run_code, def_len,
    def_val, null_count, pages, uncompressed bytes, dictionary count)."""
    lib = _load()
    if lib is None:
        return None
    item = {1: 4, 2: 8, 4: 4, 5: 8}.get(int(phys))
    if item is None:
        return None
    nv = int(num_values)
    cap_dict = int(cap_dict)
    out_dict = np.zeros(max(cap_dict, 1) * item, dtype=np.uint8)
    # coalescing bounds both streams by the chunk's value count
    run_len = np.empty(max(nv, 1), dtype=np.int64)
    run_code = np.empty(max(nv, 1), dtype=np.uint32)
    def_len = np.empty(max(nv, 1), dtype=np.int64)
    def_val = np.empty(max(nv, 1), dtype=np.uint8)
    info = np.zeros(5, dtype=np.int64)
    rc = int(
        lib.pq_decode_chunk_runs(
            chunk.ctypes.data_as(ctypes.c_void_p), int(len(chunk)), int(phys), int(codec),
            int(max_def), nv, out_dict.ctypes.data_as(ctypes.c_void_p), cap_dict,
            run_len.ctypes.data_as(ctypes.c_void_p), run_code.ctypes.data_as(ctypes.c_void_p),
            int(len(run_len)), def_len.ctypes.data_as(ctypes.c_void_p),
            def_val.ctypes.data_as(ctypes.c_void_p), int(len(def_len)),
            info.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        )
    )
    if rc < 0:
        return None
    n_runs, n_defs, dict_count = int(info[3]), int(info[4]), int(info[2])
    # copies of the live prefixes, so the full-size scratch goes at once
    return (
        out_dict[: dict_count * item].copy(),
        run_len[:n_runs].copy(),
        run_code[:n_runs].copy(),
        def_len[:n_defs].copy(),
        def_val[:n_defs].copy(),
        rc,
        int(info[0]),
        int(info[1]),
        dict_count,
    )


@_traced_kernel
def encfold_code_counts(
    run_len: np.ndarray, run_code: np.ndarray, dict_count: int
) -> Optional[np.ndarray]:
    """Occurrences of each dictionary code in a (run length, code) stream.
    None when the library is off or a run is corrupt (a non-positive
    length, a code out of range): the caller decodes at row width."""
    lib = _load()
    if lib is None:
        return None
    run_len = np.ascontiguousarray(run_len, dtype=np.int64)
    run_code = np.ascontiguousarray(run_code, dtype=np.uint32)
    if len(run_len) != len(run_code):
        raise ValueError(f"{len(run_len)} run lengths but {len(run_code)} codes")
    dict_count = int(dict_count)
    counts = np.zeros(max(dict_count, 1), dtype=np.int64)
    rc = lib.encfold_code_counts(
        run_len.ctypes.data_as(ctypes.c_void_p), run_code.ctypes.data_as(ctypes.c_void_p),
        int(len(run_len)), dict_count, counts.ctypes.data_as(ctypes.c_void_p),
    )
    if int(rc) < 0:
        return None
    return counts[:dict_count]


@_traced_kernel
def encfold_def_nulls(def_len: np.ndarray, def_val: np.ndarray, expect_rows: int = -1) -> Optional[int]:
    """The null count of (run length, present) definition-level runs,
    with no validity mask built. None when the library is off or a run is
    corrupt (a non-positive length, a value not 0 or 1, a row total other
    than `expect_rows` when that is not negative)."""
    lib = _load()
    if lib is None:
        return None
    def_len = np.ascontiguousarray(def_len, dtype=np.int64)
    def_val = np.ascontiguousarray(def_val, dtype=np.uint8)
    if len(def_len) != len(def_val):
        raise ValueError(f"{len(def_len)} run lengths but {len(def_val)} values")
    rc = int(
        lib.encfold_def_nulls(
            def_len.ctypes.data_as(ctypes.c_void_p), def_val.ctypes.data_as(ctypes.c_void_p),
            int(len(def_len)), int(expect_rows),
        )
    )
    return None if rc < 0 else rc
