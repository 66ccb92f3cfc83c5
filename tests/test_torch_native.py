"""The port's C host library (deequ_tpu_torch/ops/native) against its
numpy routes and against the JAX package's C library, on the same
seeded inputs.

- C routes bit for bit: packed HLL codes, the three dictionary-code
  bincounts, `masked_moments_select`, decoded Arrow columns.
- A profile with both C libraries on equals the JAX package's within
  1e-9: the port's cast string columns now take the same selection as
  the JAX package's (its quantile sample differed before).
- `DEEQU_TPU_NO_NATIVE` gives the numpy routes; a failed build raises;
  the library builds into deequ_tpu_torch/build/.
- Port-mapped copies of tests/test_native_kernels.py and
  tests/test_no_native_fallback.py (the JAX package's
  `hll_update_registers`, `masked_moments`, `bincount_window` and the
  counts-family routes have no binding in the port: nothing of it calls
  them).
"""

from __future__ import annotations

import json
import os

import numpy as np
import pyarrow as pa
import pytest

from deequ_tpu.data import arrow_decode as jax_arrow_decode
from deequ_tpu.ops import native as jax_native
from deequ_tpu_torch.data import arrow_decode
from deequ_tpu_torch.data.table import Table, _column_from_arrow_fallback
from deequ_tpu_torch.ops import native
from deequ_tpu_torch.ops.sketches import hll

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _library_on(monkeypatch):
    """Both libraries on, whatever an earlier test of this worker did."""
    monkeypatch.delenv("DEEQU_TPU_NO_NATIVE", raising=False)
    native.reset()
    yield
    native.reset()


@pytest.fixture
def no_native(monkeypatch):
    """The port's library off, as `DEEQU_TPU_NO_NATIVE` turns it off (the
    JAX package reads the switch once, at its first load: load it first)."""
    assert jax_native.available()
    monkeypatch.setenv("DEEQU_TPU_NO_NATIVE", "1")
    native.reset()
    assert not native.available()


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(99)


def _reference_pack(canon: np.ndarray, valid: np.ndarray) -> np.ndarray:
    idx, rank = hll.registers_from_hashes(hll.xxhash64_u64(canon[valid]))
    packed = np.zeros(len(canon), dtype=np.int32)
    packed[valid] = (idx << 6) | rank
    return packed


VALUES = [
    lambda r: r.normal(size=50_000),
    lambda r: r.integers(-(2**60), 2**60, 50_000),
    lambda r: r.integers(0, 2, 50_000).astype(bool),
    lambda r: np.array([0.0, -0.0, np.inf, -np.inf, 5e-324, 2.0**31, np.pi]),
]


# -- port-mapped: tests/test_native_kernels.py ----------------------------------


@pytest.mark.parametrize("values", VALUES)
def test_pack_matches_numpy(values, rng):
    vals = values(rng)
    valid = rng.random(len(vals)) > 0.15
    canon = hll.canonical_int64(np.asarray(vals))
    assert np.array_equal(native.xxhash64_pack(canon, valid), _reference_pack(canon, valid))


def test_pack_codes_uses_identical_codes_either_path(rng, monkeypatch):
    vals = rng.normal(size=10_000)
    valid = rng.random(10_000) > 0.1
    with_native = hll.pack_codes(vals, valid)
    monkeypatch.setattr(native, "xxhash64_pack", lambda *_: None)
    without_native = hll.pack_codes(vals, valid)
    assert np.array_equal(with_native, without_native)


def test_fallback_when_disabled(monkeypatch, rng):
    monkeypatch.setattr(native, "xxhash64_pack", lambda *a: None)
    vals = rng.normal(size=1000)
    valid = np.ones(1000, dtype=bool)
    packed = hll.pack_codes(vals, valid)
    assert packed.dtype == np.int32 and (packed != 0).any()


# -- the port's C routes against the JAX package's --------------------------------


@pytest.mark.parametrize("values", VALUES)
def test_pack_equals_the_jax_c_route(values, rng):
    vals = values(rng)
    valid = rng.random(len(vals)) > 0.15
    canon = hll.canonical_int64(np.asarray(vals))
    want = jax_native.xxhash64_pack(canon, valid)
    assert want is not None, "the JAX package's C library did not build"
    assert np.array_equal(native.xxhash64_pack(canon, valid), want)


@pytest.mark.parametrize("dtype", [np.int8, np.int32, np.int64, np.int16])
@pytest.mark.parametrize("with_where", [False, True])
def test_bincount_equals_numpy_and_jax(dtype, with_where, rng):
    n, nbins = 20_000, 90
    codes = rng.integers(-1, nbins - 1, n).astype(dtype)
    where = rng.random(n) > 0.3 if with_where else None
    got = native.bincount(codes, nbins, base=1, where=where)
    kept = codes if where is None else codes[where]
    want = np.bincount(kept.astype(np.int64) + 1, minlength=nbins)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(got, jax_native.bincount(codes, nbins, base=1, where=where))


@pytest.mark.parametrize("n", [0, 1, 7, 300, 5_000, 70_000])
@pytest.mark.parametrize("cap", [16, 460])
def test_masked_moments_select_equals_jax_and_numpy(n, cap, rng):
    x = rng.normal(3.0, 2.0, n)
    x[: n // 10] = np.round(x[: n // 10])  # ties
    valid = rng.random(n) > 0.1
    mom, sample, n_valid, level, regs = native.masked_moments_select(x, valid, None, cap)
    assert regs is None  # no HLL mode asked for
    j_mom, j_sample, j_n, j_level, _ = jax_native.masked_moments_select(x, valid, None, cap)
    assert mom.tobytes() == j_mom.tobytes() and sample.tobytes() == j_sample.tobytes()
    assert (n_valid, level) == (j_n, j_level)
    # the numpy route of _OptimisticNumericStats: the same count, bounds
    # and sample; sums in double against the C route's long double
    live = np.sort(x[valid])
    assert n_valid == live.size == mom[0]
    if live.size:
        stride = 1 << level
        kept = max(0, -(-(live.size - stride // 2) // stride))
        assert level == max(0, int(np.ceil(np.log2(live.size / cap))))
        assert np.array_equal(sample, live[stride // 2 :: stride][:kept])
        assert (mom[2], mom[3]) == (live[0], live[-1])
        assert mom[1] == pytest.approx(live.sum(), rel=1e-12)
        assert mom[4] == pytest.approx(((live - live.mean()) ** 2).sum(), rel=1e-12)


def _arrow_columns(rng, n=3_000):
    mask = rng.random(n) < 0.15
    x = rng.normal(size=n)
    x[rng.random(n) < 0.05] = np.nan
    return {
        "f64": pa.array(x, mask=mask),
        "f32": pa.array(x.astype(np.float32)),
        "i8": pa.array(rng.integers(-100, 100, n).astype(np.int8), mask=mask),
        "i32": pa.array(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)),
        "i64": pa.array(rng.integers(-(2**62), 2**62, n), mask=mask),
        "u16": pa.array(rng.integers(0, 2**16, n).astype(np.uint16)),
        "u64": pa.array(rng.integers(0, 2**62, n).astype(np.uint64), mask=mask),
        "b": pa.array(rng.random(n) < 0.5, mask=mask),
        "s": pa.array(np.array(["a", "bb", "", "ccc"])[rng.integers(0, 4, n)],
                      mask=mask).dictionary_encode(),
    }


def _same_column(a, b):
    assert (a.name, a.ctype) == (b.name, b.ctype)
    assert np.asarray(a.valid).tobytes() == np.asarray(b.valid).tobytes()
    va, vb = np.asarray(a.values), np.asarray(b.values)
    assert va.dtype == vb.dtype
    if va.dtype == object:
        assert list(va) == list(vb)
    else:
        assert va.tobytes() == vb.tobytes()


@pytest.mark.parametrize("sliced", [False, True], ids=["whole", "sliced-chunks"])
def test_decoded_columns_equal_the_host_route_and_jax(sliced, rng):
    """The C decode of every supported type (nulls, NaN, offsets of
    sliced chunks, two chunks) equals the host route bit for bit, and the
    JAX package's C decode."""
    table = pa.table(_arrow_columns(rng))
    if sliced:
        table = pa.concat_tables([table.slice(3, 1_000), table.slice(1_500, 777)])
    for name in table.column_names:
        chunks = table.column(name).chunks
        if name == "s" and len(chunks) > 1:
            # a dictionary column in two chunks: the host route unifies them
            assert arrow_decode.decode_fast_column(name, chunks, table, {}) is None
            continue
        col = arrow_decode.decode_fast_column(name, chunks, table, {})
        arr = table.column(name).combine_chunks() if len(chunks) > 1 else chunks[0]
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.chunk(0)
        _same_column(col, _column_from_arrow_fallback(name, arr, table, {}))
        jcol = jax_arrow_decode.decode_fast_column(name, chunks, table, {})
        assert np.asarray(col.valid).tobytes() == np.asarray(jcol.valid).tobytes()
        if col.ctype.name != "STRING":
            assert np.asarray(col.values).tobytes() == np.asarray(jcol.values).tobytes()
        else:
            assert col.dict_encode()[0].tobytes() == jcol.dict_encode()[0].tobytes()


def test_from_arrow_fast_set_equals_the_host_route(rng):
    table = pa.table(_arrow_columns(rng))
    fast = Table.from_arrow(table, fastpath_columns=set(table.column_names))
    host = Table.from_arrow(table)
    for name in table.column_names:
        _same_column(fast.column(name), host.column(name))


# -- profiles with both libraries on ----------------------------------------------


def _profile_table(seed: int, n: int):
    """A mixed schema whose string columns cast to numbers ("frac" with
    signed zeros among its values), as tests/test_torch_profiler.py's
    random tables."""
    rng = np.random.default_rng(seed)
    num = rng.normal(10, 3, n)
    num[rng.random(n) < 0.1] = np.nan
    return {
        "num": num,
        "code": np.array([str(v) for v in rng.integers(-50, 50, n)], dtype=object),
        "frac": np.array([f"{v:.2f}" for v in rng.normal(0, 5, n)], dtype=object),
        "cat": np.array(["α", "beta", "", "Ωmega", None], dtype=object)[rng.integers(0, 5, n)],
        "wide": rng.integers(0, 1 << 40, n),
    }


@pytest.mark.parametrize("counts_fastpath", [True, False], ids=["counts", "rows"])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_profiles_equal_jax_with_both_libraries_on(monkeypatch, seed, counts_fastpath):
    """Without the counts fast path, a cast string column's statistics
    come from its rows: the JAX package selects its quantile sample with
    the C library, and so does the port now (seed 3's "frac" differed in
    approxPercentiles when the port sorted in numpy)."""
    from deequ_tpu import Table as JTable
    from deequ_tpu.profiles.runner import ColumnProfilerRunner as JRunner
    from deequ_tpu_torch import ColumnProfilerRunner

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    if not counts_fastpath:
        monkeypatch.setenv("DEEQU_TPU_NO_COUNTS_FASTPATH", "1")
    assert jax_native.available()
    data = _profile_table(seed, 2_500)
    jp = JRunner.on_data(JTable.from_numpy(data)).with_engine("single").run()
    pp = ColumnProfilerRunner.on_data(Table.from_numpy(data), device="cpu").run()
    jcols = json.loads(jp.to_json())["columns"]
    pcols = json.loads(pp.to_json())["columns"]
    assert [c["column"] for c in pcols] == [c["column"] for c in jcols]
    for jc, pc in zip(jcols, pcols):
        assert sorted(pc) == sorted(jc)
        for key, value in jc.items():
            if key in ("mean", "sum", "stdDev"):
                assert pc[key] == pytest.approx(value, rel=1e-9), (jc["column"], key)
            else:
                assert pc[key] == value, (jc["column"], key)


# -- the switch, the build ---------------------------------------------------------


def test_the_switch_gives_the_numpy_routes(no_native, rng):
    """Port-mapped test_kernel_wrappers_return_none_without_native, and
    the callers' numpy routes give the C routes' codes and counts."""
    ones = np.ones(128, dtype=bool)
    assert native.xxhash64_pack(np.arange(128, dtype=np.int64), ones) is None
    assert native.bincount(np.zeros(128, dtype=np.int64), 4) is None
    assert native.masked_moments_select(np.ones(128), ones, None, 16) is None
    assert native.reader_codecs() == 0
    vals = rng.normal(size=5_000)
    valid = rng.random(5_000) > 0.2
    numpy_codes = hll.pack_codes(vals, valid)
    os.environ.pop("DEEQU_TPU_NO_NATIVE")
    native.reset()
    assert np.array_equal(hll.pack_codes(vals, valid), numpy_codes)


def test_profile_identical_without_native(monkeypatch):
    """Port-mapped from tests/test_no_native_fallback.py: a profile with
    the library off equals the one with it on (the cast string column's
    sums within 1e-12: long double against double)."""
    from deequ_tpu_torch.profiles.column_profiler import ColumnProfiler

    rng = np.random.default_rng(21)
    n = 40_000
    price = rng.lognormal(1.0, 0.5, n)
    price[rng.random(n) < 0.05] = np.nan
    qty = rng.integers(1, 60, n).astype(np.int64)
    code = np.array([str(v) for v in rng.integers(0, 400, n)], dtype=object)
    cat = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)]

    def build():
        return Table.from_numpy(
            {"qty": qty.copy(), "price": price.copy(), "code": code.copy(), "cat": cat.copy()}
        )

    with_native = ColumnProfiler.profile(build(), device="cpu").profiles
    monkeypatch.setenv("DEEQU_TPU_NO_NATIVE", "1")
    native.reset()
    fallback = ColumnProfiler.profile(build(), device="cpu").profiles
    assert not native.available()

    assert fallback.keys() == with_native.keys()
    for name in fallback:
        f, w = fallback[name], with_native[name]
        assert f.completeness == w.completeness, name
        assert f.data_type == w.data_type, name
        assert f.type_counts == w.type_counts, name
        assert f.approximate_num_distinct_values == w.approximate_num_distinct_values, name
        if getattr(f, "mean", None) is not None:
            assert f.mean == pytest.approx(w.mean, rel=1e-12), name
            assert f.minimum == w.minimum and f.maximum == w.maximum, name
            assert f.std_dev == pytest.approx(w.std_dev, rel=1e-9), name
            assert f.approx_percentiles == w.approx_percentiles, name
        assert (f.histogram is None) == (w.histogram is None), name
        if f.histogram is not None:
            assert f.histogram.values == w.histogram.values, name


def test_the_library_builds_into_the_ports_build_directory():
    assert native.available()
    path = native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "deequ_tpu_torch", "build")
    assert os.path.isfile(path)
    assert os.path.basename(path).startswith("libdeequ_native-")
    for source in native.SOURCES:
        assert os.path.dirname(source) == os.path.join(REPO, "deequ_tpu_torch", "ops", "native")


def test_a_failed_build_raises_with_the_compilers_output(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(native, "CFLAGS", native.CFLAGS + ("-DDQ_BROKEN", "-include", "/nonexistent.h"))
    native.reset()
    with pytest.raises(native.NativeBuildError, match="nonexistent.h"):
        native.available()
    with pytest.raises(native.NativeBuildError):
        hll.pack_codes(np.arange(4.0), np.ones(4, dtype=bool))
    assert list(tmp_path.iterdir()) == []  # no half-written library left behind


def test_a_mask_of_another_length_is_refused():
    with pytest.raises(ValueError, match="valid has 3 rows"):
        native.xxhash64_pack(np.arange(4, dtype=np.int64), np.ones(3, dtype=bool))
    with pytest.raises(ValueError, match="where has 5 rows"):
        native.bincount(np.zeros(4, dtype=np.int32), 2, where=np.ones(5, dtype=bool))
    with pytest.raises(ValueError, match="valid has 2 rows"):
        native.masked_moments_select(np.ones(4), np.ones(2, dtype=bool), None, 8)
