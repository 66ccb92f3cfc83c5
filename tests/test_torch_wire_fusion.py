"""Decode-to-wire in the port against the JAX package's, on the CPU:
Arrow buffers (or the C reader's decoded chunks) straight to the wire
rows `pack_batch_inputs` would build, with no Column in between.

- The wire kernels (`native.wire_valid_bits`, `wire_primitive`): MSB-first
  mask bits at odd row offsets against np.packbits and against the JAX
  binding, the NaN fold, narrowed ints and their overflow refusal.
- `arrow_decode.decode_wire_column` and `native_reader.assemble_wire_column`:
  the wire rows and the stub Column's lazy `.values`/`.valid` against the
  ordinary decode, across sliced and multi-chunk inputs.
- `fused.classify_wire_columns`: the JAX package's verdicts and fall-off
  reasons (with the offending key), and its static int-width pinning.
- End to end: the planner fuses the packed-only columns
  (`runtime.monitored()`'s `wire_fused`), runs with `DEEQU_TPU_WIRE_FUSED`
  on and off give the same bits with the C reader and without, and the
  metrics equal the JAX package's (sums within 1e-12).

The port's wire pads a batch to a multiple of 8 rows (the JAX package's
to a power of two), so rows compare over the batch's rows and bytes.
Port-mapped from tests/test_wire_fusion.py. No counterpart: the float32
wire's shift cases (`test_f32_shift_parity_with_pack`,
`test_f32_wire_needs_shift`, `test_shift_unavailable_falls_back_this_batch`):
the port's wire is float64. Left out: the EXPLAIN, DQ313, drift and
telemetry cases (`test_explain_pins_to_trace_with_zero_drift`,
`test_dq313_carets_offending_consumer_key`,
`test_telemetry_ratio_and_sentinel_watch`; ROADMAP queue 1 item 8).
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu.analyzers.base import InputSpec as JInputSpec
from deequ_tpu.ops import fused as jax_fused
from deequ_tpu.ops import native as jax_native
from deequ_tpu.ops import runtime as jax_runtime
from deequ_tpu_torch.analyzers.base import InputSpec
from deequ_tpu_torch.data import native_reader as nr
from deequ_tpu_torch.data.arrow_decode import decode_wire_column
from deequ_tpu_torch.data.source import ParquetSource
from deequ_tpu_torch.ops import native, runtime
from deequ_tpu_torch.ops.fused import _pin_int_wire_width, classify_wire_columns


@pytest.fixture(autouse=True)
def _library_on(monkeypatch):
    monkeypatch.delenv("DEEQU_TPU_NO_NATIVE", raising=False)
    native.reset()
    yield
    native.reset()


def _validity_addr(arr):
    bufs = arr.buffers()
    if arr.null_count == 0 or bufs[0] is None:
        return None
    return bufs[0].address


def _expand(bits, n):
    return np.unpackbits(bits, count=n).astype(np.bool_)


# -- the wire kernels ------------------------------------------------------------------


@pytest.mark.parametrize("out_off", [0, 1, 3, 7, 9, 13])
def test_valid_bits_pack_msb_first_at_odd_offsets(out_off):
    vals = [None if i % 3 == 0 else float(i) for i in range(21)]
    arr = pa.array(vals, type=pa.float64())
    out = np.zeros(8, dtype=np.uint8)
    jout = np.zeros(8, dtype=np.uint8)
    invalid = native.wire_valid_bits(_validity_addr(arr), arr.offset, len(arr), out, out_off)
    jinvalid = jax_native.wire_valid_bits(_validity_addr(arr), arr.offset, len(arr), jout, out_off)
    mask = np.zeros(64, dtype=np.uint8)
    mask[out_off : out_off + 21] = [v is not None for v in vals]
    assert np.array_equal(out, np.packbits(mask)) and np.array_equal(out, jout)
    assert invalid == jinvalid == sum(v is None for v in vals)


def test_valid_bits_sliced_odd_offset_input():
    base = pa.array([None if i % 5 == 0 else float(i) for i in range(40)], type=pa.float64())
    arr = base.slice(3, 29)  # bit offset 3 into the validity bitmap
    out = np.zeros(8, dtype=np.uint8)
    invalid = native.wire_valid_bits(_validity_addr(arr), arr.offset, len(arr), out, 0)
    ref = np.zeros(64, dtype=np.uint8)
    ref[:29] = [(i + 3) % 5 != 0 for i in range(29)]
    assert np.array_equal(out, np.packbits(ref))
    assert invalid == int(29 - ref.sum())


def test_valid_bits_null_free_chunk_sets_every_bit():
    out = np.zeros(2, dtype=np.uint8)
    assert native.wire_valid_bits(None, 0, 3, out, 5) == 0
    ref = np.zeros(16, dtype=np.uint8)
    ref[5:8] = 1
    assert np.array_equal(out, np.packbits(ref))


def test_wire_primitive_f64_folds_nan_into_bits_and_zero():
    arr = pa.array([1.5, None, float("nan"), -4.0, 0.25], type=pa.float64())
    out_vals = np.zeros(8, dtype=np.float64)
    out_bits = np.zeros(1, dtype=np.uint8)
    invalid = native.wire_primitive(
        "double", arr.buffers()[1].address, _validity_addr(arr), arr.offset, len(arr), 0.0,
        out_vals, out_bits, 0,
    )
    assert invalid == 2  # the null AND the NaN
    assert np.array_equal(out_vals[:5], [1.5, 0.0, 0.0, -4.0, 0.25])
    assert np.array_equal(_expand(out_bits, 5), [True, False, False, True, True])


@pytest.mark.parametrize("out_dtype,fits", [("int8", 127), ("int16", 32767), ("int32", 2**31 - 1)])
def test_wire_primitive_narrowed_int_exact_and_overflow_none(out_dtype, fits):
    ok = pa.array([0, 1, -(fits // 2), fits, None], type=pa.int64())
    out_vals = np.zeros(8, dtype=np.dtype(out_dtype))
    out_bits = np.zeros(1, dtype=np.uint8)
    rc = native.wire_primitive("int64", ok.buffers()[1].address, _validity_addr(ok), ok.offset,
                               len(ok), 0.0, out_vals, out_bits, 0)
    assert rc == 1
    assert np.array_equal(out_vals[:5], [0, 1, -(fits // 2), fits, 0])
    # one value past the pinned width: the kernel refuses the chunk
    over = pa.array([0, fits + 1], type=pa.int64())
    assert native.wire_primitive("int64", over.buffers()[1].address, None, 0, len(over), 0.0,
                                 np.zeros(8, dtype=np.dtype(out_dtype)), None, 0) is None


def test_wire_primitive_int_to_f64_value_row():
    arr = pa.array([5, None, -9], type=pa.int32())
    out_vals = np.zeros(8, dtype=np.float64)
    rc = native.wire_primitive("int32", arr.buffers()[1].address, _validity_addr(arr),
                               arr.offset, len(arr), 0.0, out_vals, None, 0)
    assert rc == 1
    assert np.array_equal(out_vals[:3], [5.0, 0.0, -9.0])


@pytest.mark.parametrize(
    "token,dtype",
    [("uint64", "float64"), ("double", "float32"), ("int64", "int8"), ("bool", "float64"),
     ("uint32", "int32"), ("float", "float64")],
)
def test_wire_supported_equals_jax(token, dtype):
    assert native.wire_supported(token, dtype) == jax_native.wire_supported(token, dtype)


# -- the decode ------------------------------------------------------------------------


def _spec(**kw):
    base = dict(column="x", token="double", want_value=True, want_valid=True, value_kind="val",
                value_dtype="float64", desc="f64")
    base.update(kw)
    return runtime.ColumnWireSpec(**base)


def _jax_spec(spec):
    return jax_runtime.ColumnWireSpec(
        column=spec.column, token=spec.token, want_value=spec.want_value,
        want_valid=spec.want_valid, value_kind=spec.value_kind, value_dtype=spec.value_dtype,
        needs_shift=False, desc=spec.desc,
    )


def test_decode_wire_column_multi_chunk_odd_lengths():
    from deequ_tpu.data.arrow_decode import decode_wire_column as jax_decode_wire_column

    rng = np.random.default_rng(9)
    parts = []
    for m in (13, 7, 11):  # chunks that end off every byte boundary
        vals = rng.normal(0, 1, m)
        vals[0] = np.nan
        parts.append(pa.array([None if i % 4 == 2 else v for i, v in enumerate(vals)],
                              type=pa.float64()))
    chunks = [parts[0], parts[1].slice(1, 5), parts[2]]
    t = pa.table({"x": pa.chunked_array(chunks)})
    spec = _spec()
    out = decode_wire_column("x", chunks, t, spec)
    assert out is not None
    stub, rows = out
    n = sum(len(c) for c in chunks)
    raw = np.concatenate([np.asarray(c.to_numpy(zero_copy_only=False), dtype=np.float64)
                          for c in chunks])
    present = np.concatenate([np.asarray(c.is_valid()) for c in chunks])
    ref_valid = present & ~np.isnan(np.where(present, raw, 0.0))
    ref_vals = np.where(ref_valid, raw, 0.0)
    assert len(rows["num:x"].arr) == runtime.wire_pad_size(n)
    assert np.array_equal(rows["num:x"].arr[:n], ref_vals)
    assert not rows["num:x"].arr[n:].any()
    bits = rows["valid:x"]
    assert np.array_equal(_expand(bits.arr, n), ref_valid)
    assert not _expand(bits.arr, len(bits.arr) * 8)[n:].any()  # a zero pad tail
    # the JAX package's rows over the batch's rows and bytes
    _jstub, jrows = jax_decode_wire_column(
        "x", chunks, t, _jax_spec(spec), jax_runtime.WireFusionPlan({"x": _jax_spec(spec)}, 256)
    )
    assert rows["num:x"].arr[:n].tobytes() == jrows["num:x"].arr[:n].tobytes()
    assert bits.arr[: (n + 7) // 8].tobytes() == jrows["valid:x"].arr[: (n + 7) // 8].tobytes()
    # the stub's lazy accessors rebuild the exact host data
    assert len(stub) == n
    assert np.array_equal(np.asarray(stub.valid), ref_valid)
    assert np.array_equal(np.asarray(stub.values), ref_vals)


def test_decode_wire_column_narrow_overflow_falls_back_this_batch():
    arr = pa.array([1, 2, 300], type=pa.int64())
    spec = _spec(column="i", token="int64", value_kind="ival", value_dtype="int8", desc="i8")
    assert decode_wire_column("i", [arr], pa.table({"i": arr}), spec) is None


def test_decode_wire_column_valid_only_bool():
    arr = pa.array([True, None, False, True, None])
    spec = _spec(column="b", token="bool", want_value=False, value_kind="", value_dtype="",
                 desc="bits")
    stub, rows = decode_wire_column("b", [arr], pa.table({"b": arr}), spec)
    assert set(rows) == {"valid:b"}
    assert np.array_equal(_expand(rows["valid:b"].arr, 5), [True, False, True, True, False])
    assert not rows["valid:b"].all_valid
    assert np.array_equal(np.asarray(stub.values), [True, False, False, True, False])


def test_decode_wire_column_type_mismatch_falls_back():
    arr = pa.array([1.0, 2.0], type=pa.float64())
    spec = _spec(token="float")
    assert decode_wire_column("x", [arr], pa.table({"x": arr}), spec) is None


def test_assemble_wire_column_equals_the_arrow_route(tmp_path):
    rng = np.random.default_rng(17)
    n = 3000
    x = rng.normal(size=n)
    x[::37] = np.nan
    t = pa.table({"x": pa.array(x, mask=rng.random(n) < 0.1),
                  "i": pa.array(rng.integers(-100, 100, n), mask=rng.random(n) < 0.1)})
    path = str(tmp_path / "w.parquet")
    pq.write_table(t, path, row_group_size=1000, compression="NONE")
    src = ParquetSource(path)
    metas = src._reader_chunk_meta(frozenset({"x", "i"}))
    fd = os.open(path, os.O_RDONLY)
    try:
        segs = {name: [nr.decode_chunk(nr.fetch_chunk(fd, metas[(g, name)]), metas[(g, name)])
                       for g in range(3)] for name in ("x", "i")}
    finally:
        os.close(fd)
    specs = {"x": _spec(), "i": _spec(column="i", token="int64", value_kind="ival",
                                       value_dtype="int8", desc="i8")}
    start, stop = 700, 2300  # across the chunks' boundaries
    for name, spec in specs.items():
        stub, rows = nr.assemble_wire_column(name, spec.token, segs[name], start, stop, spec)
        arrow = t.column(name).slice(start, stop - start)
        _s, want = decode_wire_column(name, list(arrow.chunks), t.slice(start, stop - start), spec)
        for key in rows:
            assert rows[key].kind == want[key].kind
            assert rows[key].arr.tobytes() == want[key].arr.tobytes(), key
            assert rows[key].all_valid == want[key].all_valid
        col = nr.assemble_column(name, spec.token, segs[name], start, stop, {})
        assert np.array_equal(np.asarray(stub.valid), np.asarray(col.valid))
        assert np.asarray(stub.values).tobytes() == np.asarray(col.values).tobytes()


# -- the planner -----------------------------------------------------------------------


def _specs(keys, spec_cls):
    out = {}
    for key in keys:
        out[key] = spec_cls(key=key, build=None, columns=(key.split(":", 1)[1],))
    return out


def _classify_both(col_types, keys, packed_only, int_bounds=None):
    port = classify_wire_columns(col_types, _specs(keys, InputSpec), packed_only,
                                 int_bounds=int_bounds)
    jax_ = jax_fused.classify_wire_columns(col_types, _specs(keys, JInputSpec), packed_only,
                                           "float64", int_bounds=int_bounds)
    assert sorted(port[0]) == sorted(jax_[0])
    for name, spec in port[0].items():
        j = jax_[0][name]
        assert (spec.want_value, spec.want_valid, spec.value_kind, spec.value_dtype, spec.desc) \
            == (j.want_value, j.want_valid, j.value_kind, j.value_dtype, j.desc)
    assert port[1] == jax_[1]
    return port


def test_packed_only_columns_fuse():
    wire, falloffs = _classify_both(
        {"x": "double", "b": "bool"}, ["num:x", "valid:x", "valid:b"],
        {"num:x", "valid:x", "valid:b"},
    )
    assert set(wire) == {"x", "b"}
    assert (wire["x"].value_kind, wire["x"].value_dtype) == ("val", "float64")
    assert not wire["b"].want_value
    assert falloffs == []


def test_off_wire_consumer_names_offending_key():
    wire, falloffs = _classify_both({"x": "double"}, ["num:x", "valid:x"], {"valid:x"})
    assert wire == {}
    (col, reason, key) = falloffs[0]
    assert col == "x" and key == "num:x" and "off-wire" in reason


def test_non_pack_consumer_names_offending_key():
    _, falloffs = _classify_both({"x": "double"}, ["num:x", "raw:x"], {"num:x", "raw:x"})
    (col, reason, key) = falloffs[0]
    assert col == "x" and key == "raw:x"


def test_uint64_and_bool_values_fall_off():
    wire, falloffs = _classify_both(
        {"u": "uint64", "b": "bool"}, ["num:u", "num:b", "valid:b"], {"num:u", "num:b", "valid:b"}
    )
    assert wire == {}
    reasons = {c: r for c, r, _ in falloffs}
    assert "uint64" in reasons["u"] and "astype" in reasons["b"]


def test_unknown_reads_and_unread_columns_fall_off():
    specs = _specs(["num:x"], InputSpec)
    specs["pred:?"] = InputSpec(key="pred:?", build=None, columns=None)
    _, falloffs = classify_wire_columns({"x": "double"}, specs, {"num:x"})
    assert falloffs == [("x", "an input spec reads unknown columns", "")]
    _, falloffs = _classify_both({"x": "double", "y": "double"}, ["num:x"], {"num:x"})
    assert falloffs == [("y", "no live consumer reads this column", "")]


def test_int_pinning_from_bounds_and_type():
    for token, bounds in [("int64", None), ("int64", (0, 100)), ("int64", (-200, 300)),
                          ("int64", (5, 10)), ("int16", None), ("uint32", None), ("uint8", None)]:
        assert _pin_int_wire_width(token, bounds) == jax_fused._pin_int_wire_width(token, bounds)
    assert _pin_int_wire_width("int64", (0, 100)) == "int8"
    assert _pin_int_wire_width("int64", (5, 10)) == "int8"  # widens to take in 0
    wire, _ = _classify_both({"i": "int64"}, ["num:i"], {"num:i"}, int_bounds={"i": (0, 90)})
    assert (wire["i"].value_kind, wire["i"].value_dtype) == ("ival", "int8")
    wire, _ = _classify_both({"i": "int64"}, ["num:i"], {"num:i"})
    assert (wire["i"].value_kind, wire["i"].value_dtype) == ("val", "float64")


# -- end to end ------------------------------------------------------------------------


def _write_numeric_parquet(tmp_path, n=6000, row_group=700):
    rng = np.random.default_rng(21)
    x = rng.normal(50.0, 4.0, n)
    x[::61] = np.nan
    t = pa.table({
        "x": pa.array(x, type=pa.float64()),
        "i": pa.array(rng.integers(-100, 120, n), type=pa.int64()),
        "b": pa.array(rng.random(n) > 0.4),
        "s": pa.array(["k%d" % (k % 30) for k in range(n)]),
    })
    path = str(tmp_path / "wire.parquet")
    pq.write_table(t, path, row_group_size=row_group)
    return path


def _analyzers(m):
    return [m.Mean("x"), m.StandardDeviation("x"), m.Completeness("x"), m.Mean("i"),
            m.Completeness("b"), m.Completeness("s")]


def _run(path, monkeypatch=None):
    import deequ_tpu_torch.analyzers as P
    from deequ_tpu_torch.runners import AnalysisRunner

    with runtime.monitored() as stats:
        ctx = AnalysisRunner.on_data(ParquetSource(path, batch_rows=1400), device="cpu") \
            .add_analyzers(_analyzers(P)).run()
    return {repr(a): m.value.get() for a, m in ctx.metric_map.items()}, stats


@pytest.mark.parametrize("reader", ["1", "0"])
def test_fusion_engages_and_kill_switch_gives_the_same_bits(tmp_path, monkeypatch, reader):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    monkeypatch.setenv("DEEQU_TPU_NATIVE_READER", reader)
    path = _write_numeric_parquet(tmp_path)
    seen = []
    real = __import__("deequ_tpu_torch.ops.fused", fromlist=["x"]).pack_batch_inputs

    def spy(items, padded, sticky, num_rows, pin=False, prepacked=None):
        seen.append(sorted(prepacked or {}))
        return real(items, padded, sticky, num_rows, pin=pin, prepacked=prepacked)

    monkeypatch.setattr("deequ_tpu_torch.ops.fused.pack_batch_inputs", spy)
    on, stats = _run(path)
    assert (stats.wire_fused_cols, stats.wire_cols_total) == (3, 4)
    assert sorted(stats.wire_fused) == ["b", "i", "x"]
    assert stats.wire_falloffs == []
    # every batch splices the decode's rows for all three columns
    assert seen and all(keys == ["num:i", "num:x", "valid:b", "valid:i", "valid:x"] for keys in seen)
    monkeypatch.setenv("DEEQU_TPU_WIRE_FUSED", "0")
    seen.clear()
    off, stats_off = _run(path)
    assert (stats_off.wire_fused_cols, stats_off.wire_cols_total) == (0, 4)
    assert all(keys == [] for keys in seen)
    assert {k: float(v).hex() for k, v in on.items()} == {k: float(v).hex() for k, v in off.items()}


def test_fused_run_equals_jax(tmp_path, monkeypatch):
    import deequ_tpu.analyzers as J
    from deequ_tpu.data.source import ParquetSource as JSource
    from deequ_tpu.runners import AnalysisRunner as JRunner

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", "1")
    path = _write_numeric_parquet(tmp_path)
    got, _ = _run(path)
    jctx = JRunner.do_analysis_run(JSource(path, batch_rows=1400), _analyzers(J), engine="single")
    want = {repr(a): m.value.get() for a, m in jctx.metric_map.items()}
    assert got.keys() == want.keys()
    for key in want:
        if key.startswith(("Mean", "StandardDeviation")):
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
        else:
            assert got[key] == want[key], key


def test_assisted_and_host_readers_keep_the_column_off_the_wire(tmp_path, monkeypatch):
    """A quantile sketch re-reads num:x on the host (its batch finish), and
    under host-discrete Completeness reads valid:b there: neither column
    fuses, with the JAX package's reasons."""
    import deequ_tpu_torch.analyzers as P
    from deequ_tpu_torch.runners import AnalysisRunner

    path = _write_numeric_parquet(tmp_path)
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host-discrete")
    with runtime.monitored() as stats:
        AnalysisRunner.on_data(ParquetSource(path, batch_rows=1400), device="cpu").add_analyzers(
            [P.Mean("x"), P.ApproxQuantile("x", 0.5), P.Completeness("b"), P.Mean("i")]).run()
    assert stats.wire_fused == ["i"]
    reasons = {c: (r, k) for c, r, k in stats.wire_falloffs}
    assert reasons["x"] == ("num:x is re-read off-wire by a host/assisted member", "num:x")
    assert reasons["b"] == ("valid:b is re-read off-wire by a host/assisted member", "valid:b")
