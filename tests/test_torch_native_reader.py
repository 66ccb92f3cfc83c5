"""The port's C Parquet reader and its Arrow-buffer decode, against
pyarrow and against the JAX package.

Port-mapped from tests/test_native_reader.py (every case: the chunk
differential against pyarrow, the corrupt and truncated chunks that
must give None, the crafted pages, the assembly against its numpy
mirror, the classifier's reasons, the kill switch) and from
tests/test_decode_fastpath.py: `TestFromArrowBitIdentity` whole,
`TestSourceDecode` without `test_workers_env_knob` (the port decodes on
one thread; parallel decode is not ported), `TestPlannerAndDrift`'s two
classifier cases (its drift and EXPLAIN cases wait for lint/), and
none of `TestObservability` (observe/ is not ported). The wire,
encoded-fold and pruning cases of both files are not ported either.

Then the whole route: streamed verification and profiles through the
C reader equal the pyarrow route (`DEEQU_TPU_NATIVE_READER=0`,
`DEEQU_TPU_DECODE_FASTPATH=0`) bit for bit, and the JAX package's
reader route (one decode worker) within the repo's parity rules.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu_torch.data import native_reader as nr
from deequ_tpu_torch.data.source import ParquetSource
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops import native, runtime


@pytest.fixture(autouse=True)
def _library_on(monkeypatch):
    monkeypatch.delenv("DEEQU_TPU_NO_NATIVE", raising=False)
    native.reset()
    yield
    native.reset()


# -- port-mapped: tests/test_native_reader.py -----------------------------------


def _codec_names():
    mask = native.reader_codecs()
    return [
        name
        for name, bit in native.READER_CODEC_MASK.items()
        if mask & bit
    ]


def _mixed_table(n=4000, seed=7):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=n)
    d[rng.random(n) < 0.1] = np.nan
    return pa.table(
        {
            "d": pa.array(d, mask=rng.random(n) < 0.2),
            "f": pa.array(rng.normal(size=n).astype(np.float32)),
            "i64": pa.array(
                rng.integers(-(10**12), 10**12, size=n),
                mask=rng.random(n) < 0.3,
            ),
            "i32": pa.array(rng.integers(-(2**31), 2**31, size=n).astype(np.int32)),
            "u8": pa.array(rng.integers(0, 256, size=n).astype(np.uint8)),
            "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
            # low-cardinality double: stays dictionary-encoded on disk
            "dictish": pa.array((rng.integers(0, 8, size=n) * 1.5).astype(np.float64)),
        }
    )


def _write(table, path, codec, version="2.6", **kw):
    pq.write_table(
        table,
        path,
        compression=codec if codec != "UNCOMPRESSED" else "NONE",
        version=version,
        data_page_size=4096,
        row_group_size=max(1, table.num_rows // 2),
        **kw,
    )


def _metas(path, columns):
    """The source's own per-(group, column) native decode recipes."""
    src = ParquetSource(str(path))
    return src._reader_chunk_meta(frozenset(columns)), src


def _decode_all(path, metas):
    fd = os.open(str(path), os.O_RDONLY)
    try:
        out = {}
        for key, meta in metas.items():
            raw = nr.fetch_chunk(fd, meta)
            assert raw is not None, key
            out[key] = nr.decode_chunk(raw, meta)
        return out
    finally:
        os.close(fd)


# the codecs by name, not from the library: collection builds nothing
@pytest.mark.parametrize("codec", sorted(native.READER_CODEC_MASK))
@pytest.mark.parametrize("version", ["1.0", "2.6"])
def test_decode_chunk_bit_identical_to_pyarrow(tmp_path, codec, version):
    if codec not in _codec_names():
        pytest.skip(f"{codec} not loadable here")
    table = _mixed_table()
    path = tmp_path / f"mix_{codec}_{version}.parquet"
    _write(table, path, codec, version=version)
    cols = list(table.column_names)
    metas, _ = _metas(path, cols)
    assert metas, "no chunk proved eligible — recipe builder regressed"
    # every column of this table is reader-eligible; both row groups too
    pf = pq.ParquetFile(str(path))
    assert len(metas) == pf.metadata.num_row_groups * len(cols)

    decoded = _decode_all(path, metas)
    for (g, name), seg in decoded.items():
        assert seg is not None, (g, name)
        ref = pf.read_row_group(g, columns=[name]).column(0).combine_chunks()
        assert seg.null_count == ref.null_count, (g, name)
        nv = seg.num_values
        ref_valid = ~np.asarray(ref.is_null())
        if seg.validity is not None:
            got_valid = np.unpackbits(seg.validity, bitorder="little")[:nv].astype(bool)
        else:
            got_valid = np.ones(nv, dtype=bool)
        assert np.array_equal(got_valid, ref_valid), (g, name)
        fill = False if seg.token == "bool" else 0
        ref_np = np.asarray(ref.fill_null(fill).to_numpy(zero_copy_only=False))
        if seg.token == "bool":
            got = np.unpackbits(seg.values, bitorder="little")[:nv].astype(bool)
            # null slots decode to 0 bits; compare where valid
            assert np.array_equal(got[got_valid], ref_np[got_valid]), (g, name)
        elif seg.token in ("double", "float"):
            uint = np.uint64 if seg.token == "double" else np.uint32
            a = seg.values[got_valid].view(uint)
            b = ref_np.astype(seg.values.dtype)[got_valid].view(uint)
            assert np.array_equal(a, b), (g, name)
        else:
            a = seg.values[got_valid]
            b = ref_np[got_valid].astype(seg.values.dtype)
            assert np.array_equal(a, b), (g, name)
        assert seg.pages >= 1
        assert seg.uncompressed_bytes > 0


def _one_chunk(tmp_path, name="plain", use_dictionary=True):
    """One eligible UNCOMPRESSED chunk's (raw bytes, meta)."""
    rng = np.random.default_rng(13)
    n = 2000
    table = pa.table(
        {"x": pa.array(rng.normal(size=n), mask=rng.random(n) < 0.2)}
    )
    path = tmp_path / f"{name}.parquet"
    pq.write_table(
        table,
        path,
        compression="NONE",
        data_page_size=4096,
        row_group_size=n,
        use_dictionary=use_dictionary,
    )
    metas, _ = _metas(path, ["x"])
    assert len(metas) == 1
    meta = metas[0, "x"]
    fd = os.open(str(path), os.O_RDONLY)
    try:
        raw = nr.fetch_chunk(fd, meta)
    finally:
        os.close(fd)
    assert raw is not None
    assert nr.decode_chunk(raw, meta) is not None, "healthy chunk must decode"
    return raw, meta


def test_decode_chunk_truncated_page_returns_none(tmp_path):
    raw, meta = _one_chunk(tmp_path)
    for cut in (0, 1, 3, len(raw) // 4, len(raw) // 2, len(raw) - 1):
        assert nr.decode_chunk(raw[:cut].copy(), meta) is None, cut


def test_decode_chunk_corrupt_thrift_varint_returns_none(tmp_path):
    raw, meta = _one_chunk(tmp_path)
    # a compact-Thrift varint with no terminating byte: ten 0xFF
    # continuation bytes where the page header starts
    bad = raw.copy()
    bad[: min(10, len(bad))] = 0xFF
    assert nr.decode_chunk(bad, meta) is None


def test_decode_chunk_oversized_uncompressed_size_returns_none(tmp_path):
    # PLAIN data page first (no dict page): the chunk begins with the
    # compact-Thrift PageHeader — field 1 (type, header byte 0x15) then
    # its varint, field 2 (uncompressed_page_size, 0x15) then its
    # varint. Splice a 5-byte ~2^34 varint in place of that size.
    raw, meta = _one_chunk(tmp_path, name="nodict", use_dictionary=False)
    assert raw[0] == 0x15
    i = 1
    while raw[i] & 0x80:
        i += 1
    i += 1  # past the type varint
    assert raw[i] == 0x15
    j = i + 1
    while raw[j] & 0x80:
        j += 1
    j += 1  # past the original uncompressed_page_size varint
    huge = np.frombuffer(b"\xff\xff\xff\xff\x7f", dtype=np.uint8)
    bad = np.concatenate([raw[: i + 1], huge, raw[j:]])
    assert nr.decode_chunk(bad, meta) is None


def test_decode_chunk_random_corruption_never_raises(tmp_path):
    raw, meta = _one_chunk(tmp_path)
    rng = np.random.default_rng(29)
    for trial in range(150):
        bad = raw.copy()
        if trial % 3 == 0:
            bad = bad[: int(rng.integers(0, len(bad)))].copy()
        else:
            for _ in range(int(rng.integers(1, 8))):
                bad[int(rng.integers(0, len(bad)))] = int(rng.integers(0, 256))
        if len(bad) == 0:
            bad = np.zeros(0, dtype=np.uint8)
        # must return a DecodedChunk or None — never raise, never crash
        out = nr.decode_chunk(bad, meta)
        assert out is None or isinstance(out, nr.DecodedChunk)


# ---- directed structural corruption ----
#
# Byte-wise fuzzing of a valid chunk cannot plausibly synthesize the
# multi-byte varints (bit-packed group counts ~2^58, dictionary counts
# ~2^61) that reach the int64-overflow guards in hybrid_u32 and the
# dictionary-page size check, so these chunks are crafted by hand with a
# minimal compact-Thrift emitter.


def _uvarint(v):
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zz(v):
    assert v >= 0
    return _uvarint(v << 1)


def _page_header(ptype, size, struct_fid, fields):
    """Compact-Thrift PageHeader: type/sizes then one nested struct whose
    int fields are all emitted as zigzag-varint i32 (ftype 5)."""
    out = bytearray()
    prev = 0
    for fid, val in ((1, ptype), (2, size), (3, size)):
        out.append(((fid - prev) << 4) | 0x05)
        out += _zz(val)
        prev = fid
    out.append(((struct_fid - prev) << 4) | 0x0C)
    sprev = 0
    for fid, val in fields:
        out.append(((fid - sprev) << 4) | 0x05)
        out += _zz(val)
        sprev = fid
    out.append(0)  # struct STOP
    out.append(0)  # PageHeader STOP
    return bytes(out)


def _dict_page(num_values, body):
    # PAGE_DICT, DictionaryPageHeader at fid 7: (num_values, PLAIN)
    return _page_header(2, len(body), 7, [(1, num_values), (2, 0)]) + body


def _dict_data_page(num_values, body):
    # PAGE_DATA, DataPageHeader at fid 5: (num_values, RLE_DICT, RLE defs)
    return _page_header(0, len(body), 5, [(1, num_values), (2, 8), (3, 3)]) + body


def _rle_defs(n):
    run = _uvarint(n << 1) + b"\x01"  # one RLE run of n ones (no nulls)
    return len(run).to_bytes(4, "little") + run


def _read_crafted(chunk_bytes, n):
    vals = np.zeros(n, dtype=np.float64)
    valid = np.zeros((n + 7) // 8, dtype=np.uint8)
    chunk = np.frombuffer(chunk_bytes, dtype=np.uint8)
    return native.read_chunk(chunk, 5, 0, 8, 1, n, vals, valid), vals, valid


def test_decode_chunk_crafted_control_decodes():
    # sanity for the emitter itself: a healthy hand-built chunk must
    # decode, so the corruption tests below cannot pass vacuously on an
    # unrelated parse error
    n = 8
    dict_body = np.arange(4, dtype=np.float64).tobytes()
    idx = bytes([2, 0x03, 0xE4, 0xE4])  # bw=2, 1 group: 0,1,2,3,0,1,2,3
    chunk = _dict_page(4, dict_body) + _dict_data_page(n, _rle_defs(n) + idx)
    res, vals, valid = _read_crafted(chunk, n)
    assert res is not None and res[0] == 0
    assert np.array_equal(vals, np.tile(np.arange(4.0), 2))
    assert valid[0] == 0xFF


def test_decode_chunk_huge_bitpacked_group_count_fails_closed(tmp_path):
    # a bit-packed hybrid header declaring ~2^58 groups at bit width 32:
    # groups*8 and groups*bw overflow int64, and an overflowed negative
    # byte count would bypass the truncation check and send unpack8 far
    # past the input buffer; the decoder must reject before multiplying
    n = 64
    dict_body = np.arange(4, dtype=np.float64).tobytes()
    for groups in (1 << 58, 1 << 60, (1 << 63) - 1):
        idx = bytes([32]) + _uvarint((groups << 1) | 1) + b"\x00" * 8
        chunk = _dict_page(4, dict_body) + _dict_data_page(
            n, _rle_defs(n) + idx
        )
        res, _, _ = _read_crafted(chunk, n)
        assert res is None, hex(groups)


def test_decode_chunk_huge_dict_count_fails_closed(tmp_path):
    # dict_num_values ~2^61 with an 8-byte page body: the old multiply
    # dict_num_values*src_size wrapped past int64 (to 0, 8, or negative)
    # and slipped under uncompressed_size, leaving dict_count huge so
    # every index passed validation and gathered from an empty buffer;
    # the size check must reject via division instead
    n = 8
    data_body = _rle_defs(n) + bytes([1, 0x03, 0xFF])  # bw=1, indices all 1
    for count in (1 << 61, (1 << 61) + 1, (1 << 60) + 1):
        chunk = _dict_page(count, b"\x00" * 8) + _dict_data_page(n, data_body)
        res, _, _ = _read_crafted(chunk, n)
        assert res is None, hex(count)


def test_fetch_chunk_short_read_returns_none(tmp_path):
    raw, meta = _one_chunk(tmp_path)
    path = tmp_path / "plain.parquet"
    size = os.path.getsize(path)
    beyond = dataclasses.replace(meta, offset=max(0, size - 8), nbytes=4096)
    fd = os.open(str(path), os.O_RDONLY)
    try:
        assert nr.fetch_chunk(fd, beyond) is None
        assert nr.fetch_chunk(fd, meta) is not None
    finally:
        os.close(fd)


def test_segment_overlaps_walk():
    def seg(nv):
        return nr.DecodedChunk(
            token="double",
            values=np.zeros(nv),
            validity=None,
            null_count=0,
            num_values=nv,
            pages=1,
            uncompressed_bytes=nv * 8,
        )
    segs = [seg(100), seg(50), seg(100)]
    assert nr._segment_overlaps(segs, 0, 100) == [(segs[0], 0, 100)]
    assert nr._segment_overlaps(segs, 90, 160) == [
        (segs[0], 90, 100),
        (segs[1], 0, 50),
        (segs[2], 0, 10),
    ]
    assert nr._segment_overlaps(segs, 150, 250) == [(segs[2], 0, 100)]
    assert nr._segment_overlaps(segs, 250, 260) == []


@pytest.mark.parametrize("column", ["d", "i64", "u8", "b"])
def test_assemble_column_matches_numpy_mirror(tmp_path, column):
    table = _mixed_table(n=3000, seed=17)
    path = tmp_path / "assemble.parquet"
    _write(table, path, "UNCOMPRESSED")
    metas, _ = _metas(path, [column])
    decoded = _decode_all(path, metas)
    segments = [decoded[key] for key in sorted(decoded)]
    assert all(s is not None for s in segments)
    token = segments[0].token
    total = sum(s.num_values for s in segments)
    # slices inside one group, crossing the group boundary, and full
    half = total // 2
    for start, stop in [(0, 500), (half - 250, half + 250), (0, total)]:
        got = nr.assemble_column(column, token, segments, start, stop, {})
        ref = nr._assemble_column_numpy_fallback(
            column, token, segments, start, stop
        )
        assert got is not None
        gv, rv = np.asarray(got.values), np.asarray(ref.values)
        if gv.dtype.kind == "f":
            assert np.array_equal(gv.view(np.uint64), rv.view(np.uint64))
        else:
            assert np.array_equal(gv, rv)
        assert np.array_equal(np.asarray(got.valid), np.asarray(ref.valid))


def test_classifier_names_the_disqualifying_property(tmp_path, monkeypatch):
    """The reader's recipes cover exactly the columns whose every chunk
    it can read: a plain string column gets none, and a codec library
    this host cannot load leaves every column to pyarrow."""
    n = 1000
    table = pa.table(
        {
            "ok": pa.array(np.arange(n, dtype=np.float64)),
            "s": pa.array(["x"] * n),
        }
    )
    path = tmp_path / "cls.parquet"
    _write(table, path, "UNCOMPRESSED")
    metas, src = _metas(path, ["ok", "s"])
    assert sorted(metas) == [(g, "ok") for g in range(src._meta.num_row_groups)]
    assert all(m.token == "double" and m.codec == native.READER_CODEC_ENUM["UNCOMPRESSED"]
               for m in metas.values())

    monkeypatch.setattr(native, "reader_codecs", lambda: 0)
    assert src._reader_chunk_meta(frozenset({"ok", "s"})) == {}


def test_kill_switch_disables_reader(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_NATIVE_READER", "0")
    assert not runtime.native_reader_enabled()
    monkeypatch.setenv("DEEQU_TPU_NATIVE_READER", "1")
    assert runtime.native_reader_enabled()


# -- port-mapped: tests/test_decode_fastpath.py ---------------------------------


def _materialize(col):
    return np.asarray(col.values)


def assert_tables_bit_identical(fast: Table, slow: Table, context=""):
    assert fast.column_names == slow.column_names
    for name in fast.column_names:
        cf, cs = fast.column(name), slow.column(name)
        assert cf.ctype == cs.ctype, (context, name)
        vf, vs = _materialize(cf), _materialize(cs)
        assert vf.dtype == vs.dtype, (context, name, vf.dtype, vs.dtype)
        if vf.dtype == object:
            assert list(vf) == list(vs), (context, name)
        else:
            assert vf.tobytes() == vs.tobytes(), (context, name)
        assert np.array_equal(np.asarray(cf.valid), np.asarray(cs.valid)), (context, name)
        if "dict_encode" in cs._cache:
            codes_f, uniq_f = cf._cache["dict_encode"]
            codes_s, uniq_s = cs._cache["dict_encode"]
            assert codes_f.dtype == codes_s.dtype
            assert np.array_equal(codes_f, codes_s), (context, name)
            assert list(uniq_f) == list(uniq_s), (context, name)
            assert cf._dict_content_key == cs._dict_content_key


def both_paths(arrow_table, columns):
    fast = Table.from_arrow(arrow_table, fastpath_columns=set(columns))
    slow = Table.from_arrow(arrow_table)
    return fast, slow


class TestFromArrowBitIdentity:
    def test_sliced_float_with_nulls_and_nan(self):
        arr = pa.array([1.5, None, float("nan"), 4.0, 5.5, None, 7.0], type=pa.float64())
        t = pa.table({"x": arr.slice(1, 5)})
        fast, slow = both_paths(t, ["x"])
        assert_tables_bit_identical(fast, slow, "sliced f64")
        # null AND NaN slots both fold to invalid + 0.0
        assert _materialize(fast.column("x"))[0] == 0.0
        assert not fast.column("x").valid[0]

    def test_float32_widens_to_float64(self):
        arr = pa.array([1.25, None, float("nan"), 9.0], type=pa.float32())
        t = pa.table({"g": arr})
        fast, slow = both_paths(t, ["g"])
        assert_tables_bit_identical(fast, slow, "f32")
        assert _materialize(fast.column("g")).dtype == np.float64

    @pytest.mark.parametrize(
        "dtype",
        [pa.int8(), pa.int16(), pa.int32(), pa.int64(),
         pa.uint8(), pa.uint16(), pa.uint32(), pa.uint64()],
    )
    def test_integer_widths_widen_with_nulls(self, dtype):
        vals = [1, None, 3, None, 5, 100]
        t = pa.table({"i": pa.array(vals, type=dtype)})
        fast, slow = both_paths(t, ["i"])
        assert_tables_bit_identical(fast, slow, str(dtype))

    def test_uint64_wraps_like_numpy_astype(self):
        big = (1 << 63) + 7  # > INT64_MAX: must wrap, not raise
        t = pa.table({"u": pa.array([big, 1, None], type=pa.uint64())})
        fast, slow = both_paths(t, ["u"])
        assert_tables_bit_identical(fast, slow, "uint64 wrap")

    def test_bool_bitmap_with_nonzero_offset(self):
        arr = pa.array([True, None, False, True, None, True, False, True, True])
        t = pa.table({"b": arr.slice(3, 5)})
        fast, slow = both_paths(t, ["b"])
        assert_tables_bit_identical(fast, slow, "sliced bool")

    def test_validity_bitmap_tail_bits(self):
        for n in (1, 3, 7, 9, 15, 17):
            vals = [None if i % 3 == 0 else float(i) for i in range(n)]
            t = pa.table({"x": pa.array(vals, type=pa.float64())})
            fast, slow = both_paths(t, ["x"])
            assert_tables_bit_identical(fast, slow, f"tail n={n}")

    def test_all_null_column(self):
        t = pa.table({"u": pa.array([None] * 11, type=pa.int32())})
        fast, slow = both_paths(t, ["u"])
        assert_tables_bit_identical(fast, slow, "all-null")
        assert not fast.column("u").valid.any()

    def test_multi_chunk_primitive(self):
        chunked = pa.chunked_array(
            [
                pa.array([1.0, None], type=pa.float64()),
                pa.array([float("nan"), 4.0, 5.0], type=pa.float64()),
                pa.array([], type=pa.float64()),
                pa.array([None, 7.0], type=pa.float64()),
            ]
        )
        t = pa.table({"x": chunked})
        fast, slow = both_paths(t, ["x"])
        assert_tables_bit_identical(fast, slow, "multi-chunk")

    def test_dictionary_column_single_chunk(self):
        arr = pa.array(["a", "b", None, "a", "c", None]).dictionary_encode()
        t = pa.table({"s": arr})
        fast, slow = both_paths(t, ["s"])
        assert_tables_bit_identical(fast, slow, "dict")
        codes, _ = fast.column("s")._cache["dict_encode"]
        assert codes.dtype == np.int32
        assert codes[2] == -1  # null sentinel

    def test_multi_chunk_dictionary_falls_back_identically(self):
        chunked = pa.chunked_array(
            [
                pa.array(["a", "b", "a"]).dictionary_encode(),
                pa.array(["c", "b", None]).dictionary_encode(),
            ]
        )
        t = pa.table({"s": chunked})
        fast, slow = both_paths(t, ["s"])
        assert_tables_bit_identical(fast, slow, "multi-chunk dict")

    def test_fastpath_off_by_default_for_unlisted_columns(self):
        t = pa.table({"x": pa.array([1.0, 2.0]), "y": pa.array([3.0, 4.0])})
        fast, slow = both_paths(t, ["x"])  # y not approved
        assert_tables_bit_identical(fast, slow, "partial set")


class TestSourceDecode:
    def _write(self, tmp_path, n=3000, row_group_size=256):
        rng = np.random.default_rng(5)
        t = pa.table(
            {
                "x": pa.array(np.where(rng.random(n) < 0.1, np.nan, rng.random(n))),
                "i": pa.array(rng.integers(0, 50, n), type=pa.int16()),
                "s": pa.array(rng.choice(["a", "b", "c", None], n).tolist()),
                "b": pa.array((rng.random(n) < 0.5).tolist()),
            }
        )
        path = str(tmp_path / "d.parquet")
        pq.write_table(t, path, row_group_size=row_group_size)
        return path

    def test_decode_column_types_tokens(self, tmp_path):
        path = self._write(tmp_path)
        tokens = ParquetSource(path).decode_column_types()
        assert tokens == {
            "x": "double",
            "i": "int16",
            # strings arrive dictionary-encoded via read_dictionary
            "s": "dictionary<string,int32>",
            "b": "bool",
        }

    @pytest.mark.parametrize("reader", [False, True], ids=["arrow", "reader"])
    def test_dictionary_crossing_row_groups(self, tmp_path, reader):
        # each row group carries its own dictionary; codes must stay
        # per-batch consistent on every route
        path = self._write(tmp_path, n=2000, row_group_size=100)

        def strings(fastpath):
            src = ParquetSource(path, batch_rows=512)
            if fastpath:
                src = src.with_decode_fastpath(["s", "x", "i", "b"])
                if reader:
                    src = src.with_native_reader(["x", "i", "b"])
            out = []
            for batch in src.batches(512):
                col = batch.column("s")
                vals = _materialize(col)
                valid = np.asarray(col.valid)
                out.extend(v if ok else None for v, ok in zip(vals.tolist(), valid))
            return out

        assert strings(True) == strings(False)

    def test_decode_units_replay_serial_coalescing(self, tmp_path, monkeypatch):
        """Units cover every group once, in order, and give the batches
        of the JAX package's serial loop."""
        from deequ_tpu.data.source import ParquetSource as JaxParquetSource

        rng = np.random.default_rng(9)
        parts = [17, 13, 900, 11, 7, 600, 23]  # tiny runs around big groups
        tables = [pa.table({"v": pa.array(rng.random(k))}) for k in parts]
        path = str(tmp_path / "mixed.parquet")
        with pq.ParquetWriter(path, tables[0].schema) as w:
            for t in tables:
                w.write_table(t, row_group_size=max(parts))
        src = ParquetSource(path, batch_rows=512)
        units = src._plan_decode_units(512)
        assert [g for unit in units for g in unit] == list(range(len(parts)))
        serial = [b.num_rows for b in JaxParquetSource(path, batch_rows=512)._iter_tables_serial(512)]
        assert [b.num_rows for b in src._iter_tables(512)] == serial
        reader = src.with_decode_fastpath(["v"]).with_native_reader(["v"])
        assert [b.num_rows for b in reader._iter_tables(512)] == serial

    def test_fastpath_env_knob(self, monkeypatch):
        monkeypatch.delenv("DEEQU_TPU_DECODE_FASTPATH", raising=False)
        assert runtime.decode_fastpath_enabled()
        monkeypatch.setenv("DEEQU_TPU_DECODE_FASTPATH", "0")
        assert not runtime.decode_fastpath_enabled()


class TestPlanner:
    def test_classifier_eligibility_and_reasons(self):
        from deequ_tpu_torch.analyzers.base import InputSpec
        from deequ_tpu_torch.ops.fused import classify_decode_columns

        col_types = {
            "f": "double",
            "i": "int32",
            "b": "bool",
            "d": "dictionary<string,int32>",
            "p": "string",
            "ts": "timestamp[us]",
            "dec": "decimal128(10, 2)",
        }
        specs = {
            "num:f": InputSpec(key="num:f", build=None, columns=("f",)),
            "valid:d": InputSpec(key="valid:d", build=None, columns=("d",)),
        }
        fast, fallbacks = classify_decode_columns(col_types, specs)
        # plain strings, timestamps and decimals take the host chain
        assert fast == ["b", "d", "f", "i"]
        assert fallbacks == [
            ("dec", "decimal values decode host-side"),
            ("p", "plain string values are host objects"),
            ("ts", "timestamp decode needs an arrow cast"),
        ]

    def test_classifier_conservative_on_unknown_prefix(self):
        from deequ_tpu_torch.analyzers.base import InputSpec
        from deequ_tpu_torch.ops.fused import classify_decode_columns

        specs = {"rawstr:d": InputSpec(key="rawstr:d", build=None, columns=("d",))}
        assert classify_decode_columns({"d": "dictionary<string,int32>"}, specs) == (
            [],
            [("d", "host string values may be required by rawstr")],
        )

    def test_classifiers_equal_the_jax_packages(self, tmp_path):
        """The same fast set and reader set as the JAX planner on the same
        file and specs, and the plan's recipes are the ones the scan uses."""
        from deequ_tpu.analyzers.base import InputSpec as JaxInputSpec
        from deequ_tpu.data.source import ParquetSource as JaxParquetSource
        from deequ_tpu.ops import fused as jax_fused
        from deequ_tpu.ops import native as jax_native
        from deequ_tpu_torch.analyzers.base import InputSpec
        from deequ_tpu_torch.ops import fused

        table = _mixed_table(n=1000)
        table = table.append_column("s", pa.array(["x", "y"] * 500))
        path = str(tmp_path / "plan.parquet")
        _write(table, path, "SNAPPY")
        keys = [("num:d", "d"), ("valid:s", "s"), ("hll:i64", "i64"), ("rawstr:s", "s")]
        specs = {k: InputSpec(key=k, build=None, columns=(c,)) for k, c in keys}
        jspecs = {k: JaxInputSpec(key=k, build=None, columns=(c,)) for k, c in keys}
        src, jsrc = ParquetSource(path), JaxParquetSource(path)
        types_ = src.decode_column_types()
        assert types_ == jsrc.decode_column_types()
        fast, fallbacks = fused.classify_decode_columns(types_, specs)
        assert (fast, fallbacks) == jax_fused.classify_decode_columns(types_, jspecs)
        fast_types = {c: types_[c] for c in fast}
        want, want_falloffs, _ = jax_fused.classify_reader_columns(
            fast_types, jsrc.row_group_stats(), jax_native.reader_codecs()
        )
        plan = fused.plan_decode_fastpath(src, specs)
        assert plan.fast == tuple(fast)
        assert list(plan.reader_cols) == want
        assert list(plan.reader_falloffs) == want_falloffs
        assert want == sorted(c for c in table.column_names if c != "s")
        planned = fused.apply_decode_plan(src, plan)
        assert planned._reader_chunks == plan.reader_chunks
        assert planned._reader_chunks == src._reader_chunk_meta(fast)


# -- the whole route ---------------------------------------------------------------


def _stream_table(n: int, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.normal(5, 2, n)
    x[rng.random(n) < 0.05] = np.nan
    return pa.table({
        "x": pa.array(x, mask=rng.random(n) < 0.1),
        "y": pa.array(rng.normal(size=n).astype(np.float32)),
        "id": pa.array(rng.integers(0, n // 3, n)),
        "k": pa.array(rng.integers(-3, 30, n).astype(np.int16), mask=rng.random(n) < 0.2),
        "flag": pa.array(rng.random(n) < 0.3, mask=rng.random(n) < 0.1),
        "cat": pa.array(np.array(["a", "b", "c", "dd"])[rng.integers(0, 4, n)]),
        "num_str": pa.array([f"{v:.1f}" for v in rng.normal(0, 3, n)]),
    })


def _stream_check():
    from deequ_tpu_torch import Check, CheckLevel

    return (Check(CheckLevel.ERROR, "stream")
            .has_size(lambda n: n > 0).is_complete("x").has_mean("x", lambda v: v > 0)
            .has_standard_deviation("y", lambda v: v > 0).has_min("k", lambda v: v >= -3)
            .has_max("id", lambda v: v >= 0).has_approx_count_distinct("id", lambda v: v > 0)
            .has_approx_quantile("x", 0.5, lambda v: True)
            .satisfies("k > 5", "k big", lambda v: v >= 0)
            .has_completeness("flag", lambda v: v > 0.5)
            .has_pattern("cat", r"^[a-d]+$"))


def _run_all(path, batch_rows):
    """The streamed verification and profile of the port on the CPU, as
    plain data with every float's bits."""
    from deequ_tpu_torch import ColumnProfilerRunner, VerificationSuite
    from torch_stream_helpers import bits, comparable

    result = VerificationSuite.on_data(Table.scan_parquet(path, batch_rows=batch_rows),
                                       device="cpu").add_check(_stream_check()).run()
    metrics = {repr(a): bits(comparable(m.value.get())) for a, m in result.metrics.items()}
    profile = ColumnProfilerRunner.on_data(Table.scan_parquet(path, batch_rows=batch_rows),
                                           device="cpu").run().to_json()
    return metrics, [str(r.status) for r in result.check_results.values()], profile


@pytest.mark.parametrize("codec", ["NONE", "snappy", "zstd"])
@pytest.mark.parametrize("row_group_size,batch_rows", [(700, 2048), (3000, 1024)],
                         ids=["coalesced", "sliced"])
def test_streamed_runs_through_the_reader_equal_the_pyarrow_route(
        tmp_path, monkeypatch, codec, row_group_size, batch_rows):
    """Verification and profile through the C reader (and the C decode)
    equal the plain pyarrow route bit for bit; the reader took every
    numeric and boolean column, on every codec."""
    path = str(tmp_path / f"s_{codec}.parquet")
    pq.write_table(_stream_table(6_000, 3), path, row_group_size=row_group_size,
                   compression=codec)
    read = []
    decode_chunk = nr.decode_chunk
    monkeypatch.setattr(nr, "decode_chunk",
                        lambda raw, meta: read.append(meta.column) or decode_chunk(raw, meta))
    on = _run_all(path, batch_rows)
    assert {"x", "y", "id", "k", "flag"} <= set(read) and "cat" not in read
    monkeypatch.setenv("DEEQU_TPU_NATIVE_READER", "0")
    monkeypatch.setenv("DEEQU_TPU_DECODE_FASTPATH", "0")
    read.clear()
    off = _run_all(path, batch_rows)
    assert read == []
    assert on == off


def test_a_chunk_that_does_not_decode_reads_through_pyarrow(tmp_path, monkeypatch):
    path = str(tmp_path / "bad.parquet")
    pq.write_table(_stream_table(3_000, 4), path, row_group_size=1000, compression="NONE")
    monkeypatch.setattr(nr, "decode_chunk", lambda raw, meta: None)
    got = _run_all(path, 4096)
    monkeypatch.setenv("DEEQU_TPU_NATIVE_READER", "0")
    assert got == _run_all(path, 4096)


def test_a_short_read_reads_through_pyarrow(tmp_path, monkeypatch):
    """A pread that comes back short gives no chunk, and the column reads
    through pyarrow; the run's results do not move."""
    path = str(tmp_path / "short.parquet")
    pq.write_table(_stream_table(2_000, 5), path, row_group_size=2000, compression="NONE")
    src = ParquetSource(path)
    (meta,) = src._reader_chunk_meta(frozenset({"x"})).values()
    fd = os.open(path, os.O_RDONLY)
    try:
        assert nr.fetch_chunk(fd, dataclasses.replace(meta, offset=os.fstat(fd).st_size - 4)) is None
        assert src._read_native(fd, meta) is not None
    finally:
        os.close(fd)
    monkeypatch.setattr(nr, "fetch_chunk", lambda fd, meta: None)
    got = _run_all(path, 4096)
    monkeypatch.setenv("DEEQU_TPU_NATIVE_READER", "0")
    assert got == _run_all(path, 4096)


def test_streamed_run_equals_the_jax_reader_route(tmp_path, monkeypatch):
    """The JAX package's reader route (its C reader and decode, one
    decode worker, device placement, no encoded fold) against the port's:
    float sums within 1e-12, everything else exact."""
    from deequ_tpu import Table as JTable, VerificationSuite as JSuite
    from deequ_tpu_torch import VerificationSuite
    from torch_stream_helpers import assert_metric_equal

    for key, value in {"DEEQU_TPU_PLACEMENT": "device", "DEEQU_TPU_DECODE_WORKERS": "1",
                       "DEEQU_TPU_ENCODED_FOLD": "0"}.items():
        monkeypatch.setenv(key, value)
    path = str(tmp_path / "jax.parquet")
    pq.write_table(_stream_table(5_000, 6), path, row_group_size=1_000)
    from deequ_tpu import Check as JCheck, CheckLevel as JLevel

    def checks(check_cls, level):
        return (check_cls(level.ERROR, "stream").is_complete("x")
                .has_mean("x", lambda v: v > 0).has_min("k", lambda v: v >= -3)
                .has_approx_count_distinct("id", lambda v: v > 0)
                .has_approx_quantile("y", 0.5, lambda v: True))

    jcheck = checks(JCheck, JLevel)
    from deequ_tpu_torch import Check, CheckLevel

    pcheck = checks(Check, CheckLevel)
    jres = JSuite.on_data(JTable.scan_parquet(path, batch_rows=2048)).with_engine("single") \
        .add_check(jcheck).run()
    pres = VerificationSuite.on_data(Table.scan_parquet(path, batch_rows=2048), device="cpu") \
        .add_check(pcheck).run()
    assert len(jres.metrics) == len(pres.metrics)
    for ja, pa_ in zip(jres.metrics, pres.metrics):
        assert repr(ja) == repr(pa_)
        assert_metric_equal(jres.metrics[ja], pres.metrics[pa_], repr(pa_))
    assert jres.status.value == pres.status.value
