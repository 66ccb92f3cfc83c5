"""ASan/UBSan/TSan smoke tests for the port's C host library.

Builds the C library with DEEQU_TPU_SANITIZE=address,undefined or
DEEQU_TPU_SANITIZE=thread in a
subprocess (the sanitizer runtime must be LD_PRELOADed before python
starts, so an in-process test cannot work) and drives the batched
multi-family kernel through it. The TSan variant hammers the kernels
from concurrent threads — the exact shape the family worker pool and
parallel scan threads produce, since the kernels release the GIL. Any
heap overflow / UB / data race the instrumented build detects aborts
the subprocess, failing the test; environments without a
sanitizer-capable toolchain skip.

Port-mapped from tests/test_native_sanitize.py, against
deequ_tpu_torch/ops/native: the loader builds into its own directory
(`native.BUILD_DIR`, pointed at the test's temporary directory so that a
sanitized library never lands beside the plain one), and a failed build
raises `NativeBuildError` where the JAX loader returns None.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile

import pytest


def _sanitizer_runtime(library: str = "libasan.so"):
    """Path to a sanitizer runtime via the toolchain, or None."""
    for compiler in ("cc", "gcc"):
        try:
            out = subprocess.run(
                [compiler, f"-print-file-name={library}"],
                capture_output=True,
                text=True,
                timeout=30,
            )
        except (OSError, subprocess.SubprocessError):
            continue
        path = out.stdout.strip()
        if out.returncode == 0 and os.path.isabs(path) and os.path.exists(path):
            return path
    return None


_ASAN_SCRIPT = r"""
import ctypes, sys
import numpy as np
import os
import deequ_tpu_torch.ops.native as native

native.BUILD_DIR = os.environ["DEEQU_TPU_CACHE_DIR"]
try:
    path = native.build()
except native.NativeBuildError:
    print("BUILD_UNAVAILABLE")
    sys.exit(0)
assert "-san" in os.path.basename(path), path
try:
    lib = native._load()
except native.NativeBuildError:
    print("LOAD_UNAVAILABLE")
    sys.exit(0)
assert native.available()

rng = np.random.default_rng(7)
n = 4096
cols = []
for i in range(3):
    x = rng.random(n)
    valid = rng.random(n) > 0.05
    cols.append((x, valid, 1, None))
where = rng.random(n) > 0.3

multi = native.masked_moments_select_multi(cols, where, cap=256)
assert multi is not None and len(multi) == 3
for (x, valid, _, _), (mom, samples, n_valid, level, regs) in zip(cols, multi):
    mask = valid & where
    ref = x[mask]
    assert int(mom[0]) == ref.size == n_valid
    assert abs(mom[1] - ref.sum()) < 1e-6
    assert mom[2] == ref.min() and mom[3] == ref.max()
    solo = native.masked_moments_select(x, valid, where, cap=256, hll_mode=1)
    assert solo is not None
    assert np.array_equal(solo[0], mom)
    assert np.array_equal(solo[1], samples)
    assert np.array_equal(solo[4], regs)

# the scalar kernels too, while instrumented
vals = rng.integers(0, 1000, n)
packed = native.xxhash64_pack(vals, np.ones(n, dtype=bool))
assert packed is not None and packed.shape == (n,)
counts = native.bincount(vals.astype(np.int64), 1000)
assert counts is not None and counts.sum() == n

# decode kernels on SLICED arrays: slice offsets put the validity scan
# at a non-byte-aligned bit position and the row count ends mid-byte,
# the exact shapes where an off-by-one reads past the bitmap
import pyarrow as pa

f = pa.array([float(i) if i % 7 else None for i in range(1001)]).slice(3, 900)
out_v = np.empty(len(f), dtype=np.float64)
out_m = np.empty(len(f), dtype=np.bool_)
bufs = f.buffers()
rc = native.decode_primitive(
    "double", bufs[1].address + f.offset * 8, bufs[0].address,
    f.offset, len(f), out_v, out_m,
)
assert rc == sum(v is None for v in f.to_pylist())
assert [v if m else None for v, m in zip(out_v, out_m)] == f.to_pylist()

b = pa.array([bool(i % 3) if i % 5 else None for i in range(997)]).slice(6, 901)
out_b = np.empty(len(b), dtype=np.bool_)
out_bm = np.empty(len(b), dtype=np.bool_)
bb = b.buffers()
rc = native.decode_bool_bitmap(
    bb[1].address, b.offset, bb[0].address, b.offset, len(b), out_b, out_bm
)
assert rc == sum(v is None for v in b.to_pylist())
assert [bool(v) if m else None for v, m in zip(out_b, out_bm)] == b.to_pylist()

d = pa.array(
    ["abc", None, "de", "abc", "f"] * 201
).dictionary_encode().slice(2, 1000)
idx = d.indices
out_c = np.empty(len(idx), dtype=np.int32)
out_cm = np.empty(len(idx), dtype=np.bool_)
ib = idx.buffers()
rc = native.decode_dict_codes(
    ib[1].address + idx.offset * 4, ib[0].address, idx.offset,
    len(idx), out_c, out_cm,
)
assert rc == d.null_count
assert all(c == -1 for c, m in zip(out_c, out_cm) if not m)

# decode-to-wire kernels on the same sliced odd-offset shapes: the
# bitpacked output lands MID-BYTE (odd out_bit_offset) and the row
# count ends off a byte boundary — exactly where an off-by-one reads
# past the validity bitmap or writes past the mask tail
wb = np.zeros(128, dtype=np.uint8)
wv = np.zeros(len(f), dtype=np.float64)
rcw = native.wire_primitive(
    "double", bufs[1].address + f.offset * 8, bufs[0].address,
    f.offset, len(f), 0.0, wv, wb, 5,
)
assert rcw == sum(v is None for v in f.to_pylist())
wm = np.unpackbits(wb, count=5 + len(f))[5:].astype(bool)
assert [v if m else None for v, m in zip(wv, wm)] == f.to_pylist()

wv32 = np.zeros(len(f), dtype=np.float32)
wb32 = np.zeros(128, dtype=np.uint8)
rcs = native.wire_primitive(
    "double", bufs[1].address + f.offset * 8, bufs[0].address,
    f.offset, len(f), 500.25, wv32, wb32, 3,
)
assert rcs == rcw

ia = pa.array(
    [i % 120 if i % 4 else None for i in range(1003)], type=pa.int64()
).slice(7, 900)
iab = ia.buffers()
wvi = np.zeros(len(ia), dtype=np.int8)
wbi = np.zeros(128, dtype=np.uint8)
rci = native.wire_primitive(
    "int64", iab[1].address + ia.offset * 8, iab[0].address,
    ia.offset, len(ia), 0.0, wvi, wbi, 1,
)
assert rci == sum(v is None for v in ia.to_pylist())
im = np.unpackbits(wbi, count=1 + len(ia))[1:].astype(bool)
assert [int(v) if m else None for v, m in zip(wvi, im)] == ia.to_pylist()

wbv = np.zeros(128, dtype=np.uint8)
rcv = native.wire_valid_bits(iab[0].address, ia.offset, len(ia), wbv, 9)
assert rcv == rci

# native parquet page decode (parquet_read.c) while instrumented: a
# real column chunk (Thrift headers, dict + data pages) decoded into
# arrow-layout buffers, then truncated and bit-flipped variants which
# must fail cleanly without reading or writing out of bounds
import os as _os
import tempfile as _tempfile

import pyarrow.parquet as _pq

_n = 3000
_tbl = pa.table({"x": pa.array([float(i) if i % 7 else None for i in range(_n)])})
_tmp = _tempfile.mkstemp(suffix=".parquet")[1]
_pq.write_table(
    _tbl, _tmp, compression="NONE", data_page_size=1024, row_group_size=_n
)
_md = _pq.ParquetFile(_tmp).metadata
_ch = _md.row_group(0).column(0)
_start = _ch.data_page_offset
if _ch.has_dictionary_page and _ch.dictionary_page_offset is not None:
    _start = min(_start, _ch.dictionary_page_offset)
with open(_tmp, "rb") as _f:
    _f.seek(_start)
    _chunk = np.frombuffer(_f.read(_ch.total_compressed_size), dtype=np.uint8)
_os.unlink(_tmp)
_vals = np.zeros(_n, dtype=np.float64)
_valid = np.zeros((_n + 7) // 8, dtype=np.uint8)
res = native.read_chunk(_chunk, 5, 0, 8, 1, _n, _vals, _valid)
assert res is not None and res[0] == _tbl.column("x").null_count
_rngc = np.random.default_rng(23)
for _t in range(60):
    _bad = _chunk.copy()
    if _t % 2:
        _bad = _bad[: int(_rngc.integers(0, len(_bad)))].copy()
    else:
        for _ in range(4):
            _bad[int(_rngc.integers(0, len(_bad)))] = int(_rngc.integers(0, 256))
    _vals[:] = 0
    _valid[:] = 0
    native.read_chunk(_bad, 5, 0, 8, 1, _n, _vals, _valid)

# runs-mode decode (pq_decode_chunk_runs) while instrumented: the same
# chunk as coalesced (run_length, dict_code) + definition-level runs,
# folded by the encfold kernels, then corrupt-run streams and
# truncated/bit-flipped chunk variants which must fail closed without
# reading or writing out of bounds
_rr = native.read_chunk_runs(_chunk, 5, 0, 1, _n)
assert _rr is not None
_draw, _rl, _rcodes, _dl, _dv, _rnulls, _rpg, _rub, _dc = _rr
assert _rnulls == _tbl.column("x").null_count
_cnts = native.encfold_code_counts(_rl, _rcodes, _dc)
assert _cnts is not None and int(_cnts.sum()) == _n - _rnulls
assert native.encfold_def_nulls(_dl, _dv, _n) == _rnulls
_bad_rl = _rl.copy(); _bad_rl[0] = -3
assert native.encfold_code_counts(_bad_rl, _rcodes, _dc) is None
_bad_rc = _rcodes.copy(); _bad_rc[0] = _dc + 7
assert native.encfold_code_counts(_rl, _bad_rc, _dc) is None
assert native.encfold_def_nulls(_dl, _dv, _n + 1) is None
for _t in range(60):
    _bad = _chunk.copy()
    if _t % 2:
        _bad = _bad[: int(_rngc.integers(0, len(_bad)))].copy()
    else:
        for _ in range(4):
            _bad[int(_rngc.integers(0, len(_bad)))] = int(_rngc.integers(0, 256))
    native.read_chunk_runs(_bad, 5, 0, 1, _n)

# directed structural corruption while instrumented: extreme multi-byte
# varints that byte-wise fuzzing cannot synthesize. A bit-packed group
# count ~2^58 at bit width 32 and a dictionary count ~2^61 each used to
# overflow int64 size math and read out of bounds; both must now fail
# closed with no sanitizer report.
def _uv(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)

def _hdr(ptype, size, sfid, fields):
    out = bytearray()
    prev = 0
    for fid, val in ((1, ptype), (2, size), (3, size)):
        out.append(((fid - prev) << 4) | 0x05)
        out += _uv(val << 1)
        prev = fid
    out.append(((sfid - prev) << 4) | 0x0C)
    sprev = 0
    for fid, val in fields:
        out.append(((fid - sprev) << 4) | 0x05)
        out += _uv(val << 1)
        sprev = fid
    return bytes(out) + b"\x00\x00"

_drun = _uv(8 << 1) + b"\x01"
_defs8 = len(_drun).to_bytes(4, "little") + _drun
_dictb = np.arange(4, dtype=np.float64).tobytes()
_idx_huge = bytes([32]) + _uv(((1 << 58) << 1) | 1) + b"\x00" * 8
_body_a = _defs8 + _idx_huge
_body_b = _defs8 + bytes([1, 0x03, 0xFF])
for _evil in [
    _hdr(2, len(_dictb), 7, [(1, 4), (2, 0)]) + _dictb
    + _hdr(0, len(_body_a), 5, [(1, 8), (2, 8), (3, 3)]) + _body_a,
    _hdr(2, 8, 7, [(1, 1 << 61), (2, 0)]) + b"\x00" * 8
    + _hdr(0, len(_body_b), 5, [(1, 8), (2, 8), (3, 3)]) + _body_b,
]:
    _ev = np.frombuffer(_evil, dtype=np.uint8)
    _vals8 = np.zeros(8, dtype=np.float64)
    _valid8 = np.zeros(1, dtype=np.uint8)
    assert native.read_chunk(_ev, 5, 0, 8, 1, 8, _vals8, _valid8) is None
    assert native.read_chunk_runs(_ev, 5, 0, 1, 8) is None
print("SANITIZED_OK")
"""


def test_sanitized_build_runs_clean():
    runtime = _sanitizer_runtime()
    if runtime is None:
        pytest.skip("no sanitizer-capable toolchain")

    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ)
        env.update(
            {
                "DEEQU_TPU_SANITIZE": "address,undefined",
                "DEEQU_TPU_CACHE_DIR": cache,
                "LD_PRELOAD": runtime,
                # python itself leaks by sanitizer standards; we only
                # care about the kernel's memory errors, not exit leaks
                "ASAN_OPTIONS": "detect_leaks=0,abort_on_error=1",
            }
        )
        env.pop("DEEQU_TPU_NO_NATIVE", None)
        proc = subprocess.run(
            [sys.executable, "-c", _ASAN_SCRIPT],
            capture_output=True,
            text=True,
            timeout=300,
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        if "BUILD_UNAVAILABLE" in proc.stdout or "LOAD_UNAVAILABLE" in proc.stdout:
            pytest.skip("sanitized native build unavailable in this environment")
        assert proc.returncode == 0, (
            f"sanitized run failed (rc={proc.returncode})\n"
            f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
        )
        assert "SANITIZED_OK" in proc.stdout


def test_sanitize_flags_parse():
    from deequ_tpu_torch.ops.native import _sanitize_flags

    old = os.environ.pop("DEEQU_TPU_SANITIZE", None)
    try:
        assert _sanitize_flags() == []
        os.environ["DEEQU_TPU_SANITIZE"] = "address,undefined"
        flags = _sanitize_flags()
        assert "-fsanitize=address,undefined" in flags
        assert "-g" in flags
        os.environ["DEEQU_TPU_SANITIZE"] = "  "
        assert _sanitize_flags() == []
    finally:
        if old is not None:
            os.environ["DEEQU_TPU_SANITIZE"] = old
        else:
            os.environ.pop("DEEQU_TPU_SANITIZE", None)


_TSAN_SCRIPT = r"""
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import os
import deequ_tpu_torch.ops.native as native

native.BUILD_DIR = os.environ["DEEQU_TPU_CACHE_DIR"]
try:
    path = native.build()
except native.NativeBuildError:
    print("BUILD_UNAVAILABLE")
    sys.exit(0)
assert "-san" in os.path.basename(path), path
try:
    lib = native._load()
except native.NativeBuildError:
    print("LOAD_UNAVAILABLE")
    sys.exit(0)
assert native.available()

rng = np.random.default_rng(11)
n = 8192
N_THREADS = 4
ROUNDS = 8

# per-thread inputs: the kernels must be race-free even when every
# thread traverses its OWN arrays concurrently (thread-local arenas),
# and when two threads share the SAME read-only input (the family pool
# dispatches same-batch groups concurrently)
shared_x = rng.random(n)
shared_valid = rng.random(n) > 0.05
shared_where = rng.random(n) > 0.3

# one shared sliced arrow chunk decoded by every thread — the decode
# worker pool's shape (threads share the arrow buffers, write disjoint
# outputs)
import pyarrow as pa
shared_arrow = pa.array(
    [float(i) if i % 9 else None for i in range(n + 11)]
).slice(5, n)
_ab = shared_arrow.buffers()

# decode-to-wire concurrency shape: every thread reads the SAME arrow
# buffers and packs its own disjoint byte-aligned slice of one shared
# prezeroed bitmask (in the engine each batch's wire buffers have a
# single writer; the sharing under test is the read side + disjoint
# output bytes)
N_SEG = n // N_THREADS  # byte-aligned: n and N_THREADS are powers of 2
shared_wire_bits = np.zeros(n // 8, dtype=np.uint8)

# one shared raw parquet chunk every thread page-decodes concurrently —
# the native reader's decode-worker shape (threads share the chunk
# bytes read-only, each writes its own output buffers)
import os as _os
import tempfile as _tempfile

import pyarrow.parquet as _pq

_cn = 2000
_ctbl = pa.table(
    {"x": pa.array([float(i) if i % 7 else None for i in range(_cn)])}
)
_ctmp = _tempfile.mkstemp(suffix=".parquet")[1]
_pq.write_table(
    _ctbl, _ctmp, compression="NONE", data_page_size=1024, row_group_size=_cn
)
_cch = _pq.ParquetFile(_ctmp).metadata.row_group(0).column(0)
_cstart = _cch.data_page_offset
if _cch.has_dictionary_page and _cch.dictionary_page_offset is not None:
    _cstart = min(_cstart, _cch.dictionary_page_offset)
with open(_ctmp, "rb") as _cf:
    _cf.seek(_cstart)
    shared_chunk = np.frombuffer(
        _cf.read(_cch.total_compressed_size), dtype=np.uint8
    )
_os.unlink(_ctmp)
shared_chunk_nulls = _ctbl.column("x").null_count

def work(seed):
    r = np.random.default_rng(seed)
    x = r.random(n)
    valid = r.random(n) > 0.05
    where = r.random(n) > 0.3
    for _ in range(ROUNDS):
        own = native.masked_moments_select(x, valid, where, cap=256, hll_mode=1)
        assert own is not None
        cols = [(x, valid, 1, None), (shared_x, shared_valid, 1, None)]
        multi = native.masked_moments_select_multi(cols, where, cap=256)
        assert multi is None or len(multi) == 2
        sh = native.masked_moments_select(
            shared_x, shared_valid, shared_where, cap=128
        )
        assert sh is not None
        vals = r.integers(0, 500, n)
        packed = native.xxhash64_pack(vals, np.ones(n, dtype=bool))
        assert packed is not None
        counts = native.bincount(vals.astype(np.int64), 500)
        assert counts is not None and counts.sum() == n
        dv = np.empty(len(shared_arrow), dtype=np.float64)
        dm = np.empty(len(shared_arrow), dtype=np.bool_)
        rc = native.decode_primitive(
            "double", _ab[1].address + shared_arrow.offset * 8,
            _ab[0].address, shared_arrow.offset, len(shared_arrow), dv, dm,
        )
        assert rc == shared_arrow.null_count
        off = seed * N_SEG
        wv = np.zeros(N_SEG, dtype=np.float64)
        rcw = native.wire_primitive(
            "double", _ab[1].address + (shared_arrow.offset + off) * 8,
            _ab[0].address, shared_arrow.offset + off, N_SEG, 0.0, wv,
            shared_wire_bits, off,
        )
        assert rcw is not None and rcw >= 0
        cv = np.zeros(_cn, dtype=np.float64)
        cb = np.zeros((_cn + 7) // 8, dtype=np.uint8)
        cres = native.read_chunk(shared_chunk, 5, 0, 8, 1, _cn, cv, cb)
        assert cres is not None and cres[0] == shared_chunk_nulls
    # deterministic reference: same shared inputs -> same moments
    mom = native.masked_moments_select(
        shared_x, shared_valid, shared_where, cap=128
    )[0]
    return tuple(mom[:4])

with ThreadPoolExecutor(max_workers=N_THREADS) as pool:
    results = list(pool.map(work, range(N_THREADS)))
assert len(set(results)) == 1, "concurrent runs diverged: " + repr(results)
expected_mask = np.array(shared_arrow.is_valid())
assert np.array_equal(
    np.unpackbits(shared_wire_bits, count=n).astype(bool), expected_mask
), "shared wire bitmask diverged from the validity reference"
print("TSAN_OK")
"""


def test_tsan_build_runs_clean_multithreaded():
    """DEEQU_TPU_SANITIZE=thread: the kernels driven concurrently from
    multiple threads under ThreadSanitizer — the native layer's
    concurrency contract (GIL-released kernels, thread-local arenas,
    read-only shared inputs) checked by the instrument, not by luck."""
    runtime = _sanitizer_runtime("libtsan.so")
    if runtime is None:
        pytest.skip("no TSan-capable toolchain")

    with tempfile.TemporaryDirectory() as cache:
        env = dict(os.environ)
        env.update(
            {
                "DEEQU_TPU_SANITIZE": "thread",
                "DEEQU_TPU_CACHE_DIR": cache,
                "LD_PRELOAD": runtime,
                # only the kernel's races matter; halt hard when one is
                # found so the assertion below cannot miss it
                "TSAN_OPTIONS": "halt_on_error=1,exitcode=66",
            }
        )
        env.pop("DEEQU_TPU_NO_NATIVE", None)
        proc = subprocess.run(
            [sys.executable, "-c", _TSAN_SCRIPT],
            capture_output=True,
            text=True,
            timeout=300,
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        if "BUILD_UNAVAILABLE" in proc.stdout or "LOAD_UNAVAILABLE" in proc.stdout:
            pytest.skip("TSan native build unavailable in this environment")
        assert proc.returncode == 0, (
            f"TSan run failed (rc={proc.returncode})\n"
            f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr}"
        )
        assert "TSAN_OK" in proc.stdout
        assert "WARNING: ThreadSanitizer" not in proc.stderr


def test_sanitized_build_has_its_own_library_name(monkeypatch):
    """A sanitized build never shadows the plain library, nor is it
    shadowed by it: each has its own file name."""
    from deequ_tpu_torch.ops import native

    monkeypatch.delenv("DEEQU_TPU_SANITIZE", raising=False)
    plain = native.library_path()
    monkeypatch.setenv("DEEQU_TPU_SANITIZE", "address,undefined")
    asan = native.library_path()
    monkeypatch.setenv("DEEQU_TPU_SANITIZE", "thread")
    tsan = native.library_path()
    assert len({plain, asan, tsan}) == 3
    assert "-san" not in os.path.basename(plain)
    assert os.path.dirname(plain) == os.path.dirname(asan) == os.path.dirname(tsan)


def test_sanitize_flags_equal_jax(monkeypatch):
    from deequ_tpu.ops.native import _sanitize_flags as jflags
    from deequ_tpu_torch.ops.native import _sanitize_flags

    for spec in ("", "  ", "address,undefined", "thread", " address , undefined ,", ","):
        monkeypatch.setenv("DEEQU_TPU_SANITIZE", spec)
        assert _sanitize_flags() == jflags(), spec
