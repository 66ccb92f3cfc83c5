"""The port's counts-based family route and family kernels against the
JAX package's, on the same seeded inputs, on the CPU.

- `ops/counts_family`: a low-range int64 column's moments, decimated
  quantile sample and HLL registers from ONE windowed count pass, and a
  low-cardinality float or sparse int column's from the hash counter,
  against the family kernel (`masked_moments_select`) and against the
  JAX package's counts route: samples, registers, counts, minima and
  maxima exactly, sums exactly for in-range integers and within 1e-12
  otherwise, m2 within 1e-9 (as the JAX test holds them).
- `native.masked_moments_select_multi`: K columns in one traversal give
  the bits of K solo calls, and the JAX package's bits.
- The fused pass's family layer under the host placement: one batched
  call per (where, cap) group, `DEEQU_TPU_NO_MULTI_FAMILY` and
  `DEEQU_TPU_NO_COUNTS_FASTPATH` move no metric, the counts miss is
  probed once per stream, and the metrics equal the JAX package's.

Port-mapped from tests/test_counts_fastpaths.py and
tests/test_multi_family_kernel.py. The skew guard's CPU-time bound of
`test_hash_counts_skew_guard_bails_on_late_tail` does not carry over:
the port's test asserts the result (None), not a time.
"""

from __future__ import annotations

import numpy as np
import pytest

from deequ_tpu.ops import counts_family as jax_counts_family
from deequ_tpu.ops import native as jax_native
from deequ_tpu_torch.ops import counts_family, native, runtime


@pytest.fixture(autouse=True)
def _library_on(monkeypatch):
    monkeypatch.delenv("DEEQU_TPU_NO_NATIVE", raising=False)
    monkeypatch.delenv("DEEQU_TPU_NO_COUNTS_FASTPATH", raising=False)
    monkeypatch.delenv("DEEQU_TPU_NO_MULTI_FAMILY", raising=False)
    native.reset()
    yield
    native.reset()


def _select_reference(vals, valid, where, cap, with_hll):
    return native.masked_moments_select(
        vals.astype(np.float64), valid, where, cap,
        hll_mode=2 if with_hll else 0, hashvals=vals if with_hll else None,
    )


def _same(a, b):
    """The same family outputs, bit for bit."""
    assert (a[2], a[3]) == (b[2], b[3])
    assert a[0].tobytes() == b[0].tobytes()
    assert np.asarray(a[1]).tobytes() == np.asarray(b[1]).tobytes()
    assert (a[4] is None) == (b[4] is None)
    if a[4] is not None:
        assert np.array_equal(a[4], b[4])


def _counts_case(case):
    seeds = {"dense": 1, "nulls": 2, "where": 3, "offset_base": 4, "negative": 5, "tiny": 6,
             "constant": 7, "two_values": 8}
    rng = np.random.default_rng(seeds[case])
    n = 200_000
    valid = where = None
    if case == "dense":
        vals = rng.integers(1, 100, n)
    elif case == "nulls":
        vals = rng.integers(-50, 5000, n)
        valid = rng.random(n) > 0.15
    elif case == "where":
        vals = rng.integers(0, 30, n)
        valid = rng.random(n) > 0.05
        where = rng.random(n) > 0.5
    elif case == "offset_base":
        vals = rng.integers(10**14, 10**14 + 20_000, n)
    elif case == "negative":
        vals = rng.integers(-30_000, -29_000, n)
    elif case == "tiny":
        vals = np.array([3, 1, 4, 1, 5])
    elif case == "constant":
        vals = np.full(n, 77)
    else:  # two_values
        vals = np.where(rng.random(n) > 0.7, 10, 20)
    return vals.astype(np.int64), valid, where


@pytest.mark.parametrize(
    "case",
    ["dense", "nulls", "where", "offset_base", "negative", "tiny", "constant", "two_values"],
)
def test_counts_route_matches_select_kernel_and_jax(case):
    vals, valid, where = _counts_case(case)
    cap = 460
    res = counts_family.counts_for_column(vals, valid, where)
    assert res is not None, case
    counts, lo, n_valid, n_where = res
    jres = jax_counts_family.counts_for_column(vals, valid, where)
    assert np.array_equal(counts, jres[0]) and (lo, n_valid, n_where) == jres[1:]
    got = counts_family.family_from_counts(counts, lo, cap, n_where, want_regs=True)
    _same(got, jax_counts_family.family_from_counts(counts, lo, cap, n_where, want_regs=True))
    mom_c, sample_c, n_c, lvl_c, regs_c = got
    mom_r, sample_r, n_r, lvl_r, regs_r = _select_reference(vals, valid, where, cap, True)
    assert (n_c, lvl_c) == (n_r, lvl_r)
    assert np.array_equal(sample_c, sample_r)
    assert np.array_equal(regs_c, regs_r)
    assert mom_c[0] == mom_r[0] and mom_c[5] == mom_r[5]
    assert mom_c[2] == mom_r[2] and mom_c[3] == mom_r[3]
    # the counts route's integer sum is exact; the kernel's long-double
    # stream equals it while the total fits its mantissa
    if abs(mom_r[1]) < float(1 << 53):
        assert mom_c[1] == mom_r[1]
    else:
        assert mom_c[1] == pytest.approx(mom_r[1], rel=1e-15)
    assert mom_c[4] == pytest.approx(mom_r[4], rel=1e-9, abs=1e-9)


def test_counts_route_fallbacks():
    rng = np.random.default_rng(0)
    # a wide range: the probe refuses before any pass
    wide = rng.integers(0, 10**12, 10_000).astype(np.int64)
    assert counts_family.counts_for_column(wide, None, None) is None
    # only int64 columns
    assert counts_family.counts_for_column(rng.random(1000), None, None) is None
    # a narrow probe, but an outlier the probes missed: the C pass stops
    trick = np.full(100_001, 5, dtype=np.int64)
    trick[70_000] = 10**9
    assert counts_family.counts_for_column(trick, None, None) is None
    # an all-null column gives the probe nothing
    vals = rng.integers(0, 5, 1000).astype(np.int64)
    assert counts_family.counts_for_column(vals, np.zeros(1000, dtype=bool), None) is None


@pytest.mark.parametrize(
    "case", ["discount", "tax_nulls", "neg_zero", "extreme_floats", "sparse_int", "where_float"]
)
def test_hash_counts_match_select_kernel_and_jax(case):
    rng = np.random.default_rng(
        {"discount": 31, "tax_nulls": 32, "neg_zero": 33, "extreme_floats": 34,
         "sparse_int": 35, "where_float": 36}[case]
    )
    n = 150_000
    valid = where = None
    if case == "discount":
        vals = rng.integers(0, 11, n) / 100.0
    elif case == "tax_nulls":
        vals = rng.integers(0, 9, n) / 100.0
        valid = rng.random(n) > 0.15
    elif case == "neg_zero":
        vals = np.where(rng.random(n) > 0.5, 0.0, -0.0)
    elif case == "extreme_floats":
        vals = rng.choice([1.5, -2.25, 1e300, -1e-300, 0.125, np.finfo(float).tiny], n)
    elif case == "sparse_int":
        vals = (rng.integers(0, 4000, n) * 982451653).astype(np.int64)
    else:  # where_float
        vals = rng.integers(0, 4, n) / 4.0
        valid = rng.random(n) > 0.05
        where = rng.random(n) > 0.5
    is_int = np.issubdtype(vals.dtype, np.integer)
    vals = vals.astype(np.int64 if is_int else np.float64)
    kind = "i64" if is_int else "f64"
    cap = 460
    hres = counts_family.hash_counts_for_column(vals, valid, where)
    assert hres is not None, case
    keys, counts, _n_valid, n_where = hres
    got = counts_family.family_from_hash_counts(keys, counts, kind, cap, n_where, want_regs=True)
    jkeys, jcounts, _jn, jn_where = jax_counts_family.hash_counts_for_column(vals, valid, where)
    _same(got, jax_counts_family.family_from_hash_counts(
        jkeys, jcounts, kind, cap, jn_where, want_regs=True))
    if is_int:
        ref = _select_reference(vals, valid, where, cap, True)
    else:
        ref = native.masked_moments_select(vals, valid, where, cap, hll_mode=1)
    mom_c, sample_c, n_c, lvl_c, regs_c = got
    mom_r, sample_r, n_r, lvl_r, regs_r = ref
    assert (n_c, lvl_c) == (n_r, lvl_r), case
    assert np.array_equal(sample_c, sample_r), case
    assert np.array_equal(regs_c, regs_r), case
    assert mom_c[0] == mom_r[0] and mom_c[5] == mom_r[5], case
    assert mom_c[2] == mom_r[2] and mom_c[3] == mom_r[3], case
    assert mom_c[1] == pytest.approx(mom_r[1], rel=1e-12, abs=1e-12)
    assert mom_c[4] == pytest.approx(mom_r[4], rel=1e-9, abs=1e-9)


def test_family_from_value_counts_is_the_hash_route():
    values = np.array([3, -1, 7, 3], dtype=np.int64)[:3]
    counts = np.array([5, 2, 1], dtype=np.int64)
    got = counts_family.family_from_value_counts(values, counts, "i64", 16, 8, True)
    _same(got, counts_family.family_from_hash_counts(values.view(np.uint64), counts, "i64", 16, 8,
                                                      True))
    _same(got, jax_counts_family.family_from_value_counts(values, counts, "i64", 16, 8, True))


def test_hash_counts_high_cardinality_aborts():
    rng = np.random.default_rng(40)
    assert counts_family.hash_counts_for_column(rng.lognormal(3, 1, 200_000), None, None) is None
    assert counts_family.hash_counts_for_column(np.array(["a"], dtype=object), None, None) is None


def test_hash_counts_skew_guard_bails_on_late_tail():
    """A column whose distinct values pass the counter's cap only in a
    late tail: the counter gives up (the JAX test also bounds the time
    it takes; that bound does not carry over to this port's tests)."""
    rng = np.random.default_rng(41)
    n = 1_500_000
    head = rng.integers(0, 64_000, int(n * 0.95)).astype(np.float64)
    tail = rng.integers(64_000, 72_000, n - len(head)).astype(np.float64)
    vals = np.concatenate([head, tail])
    assert counts_family.hash_counts_for_column(vals, None, None) is None
    assert jax_counts_family.hash_counts_for_column(vals, None, None) is None


def test_empty_after_masks():
    vals = np.arange(100, dtype=np.int64)
    res = counts_family.counts_for_column(vals, None, np.zeros(100, dtype=bool))
    assert res is not None
    counts, lo, n_valid, n_where = res
    assert n_valid == 0 and n_where == 0
    mom, sample, m, level, regs = counts_family.family_from_counts(counts, lo, 460, n_where, True)
    assert m == 0 and len(sample) == 0
    assert mom[0] == 0.0 and mom[2] == np.inf and mom[3] == -np.inf
    assert not regs.any()


@pytest.mark.parametrize("placement", ["host-all", "device"])
def test_int64_extreme_sentinels_stay_successful(placement, monkeypatch):
    """Columns of Long.MIN/MAX-adjacent values: the window clamps inside
    int64 and the metrics succeed, equal to the JAX package's."""
    from deequ_tpu.analyzers import ApproxQuantiles as JQuantiles
    from deequ_tpu.analyzers import Mean as JMean
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.runners import AnalysisRunner as JRunner
    from deequ_tpu_torch.analyzers import ApproxQuantiles, Mean
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.runners import AnalysisRunner

    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    for value in (-(1 << 63) + 5, (1 << 63) - 3):
        data = {"x": np.full(5000, value, dtype=np.int64)}
        res = AnalysisRunner.on_data(Table.from_numpy(data), device="cpu").add_analyzers(
            [Mean("x"), ApproxQuantiles("x", (0.5,))]).run()
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host" if placement == "host-all" else placement)
        jres = JRunner.on_data(JTable.from_numpy(data)).add_analyzers(
            [JMean("x"), JQuantiles("x", (0.5,))]).run()
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
        got = sorted((repr(a), m.value.get()) for a, m in res.metric_map.items())
        want = sorted((repr(a), m.value.get()) for a, m in jres.metric_map.items())
        assert got == want


# -- port-mapped: tests/test_multi_family_kernel.py ----------------------------------


def _check_group(columns, where, cap):
    outs = native.masked_moments_select_multi(columns, where, cap)
    assert outs is not None and len(outs) == len(columns)
    jouts = jax_native.masked_moments_select_multi(columns, where, cap)
    for i, (x, valid, hll_mode, hashvals) in enumerate(columns):
        solo = native.masked_moments_select(x, valid, where, cap, hll_mode=hll_mode,
                                            hashvals=hashvals)
        for out in (outs[i], jouts[i]):
            assert (out[2], out[3]) == (solo[2], solo[3])
            assert np.array_equal(out[0], solo[0], equal_nan=True)
            assert np.array_equal(out[1], solo[1])
            assert (out[4] is None) == (solo[4] is None)
            if solo[4] is not None:
                assert np.array_equal(out[4], solo[4])


@pytest.mark.parametrize("with_where", [False, True])
def test_multi_kernel_mixed_columns(with_where):
    rng = np.random.default_rng(3 if with_where else 2)
    n = 120_000
    columns = []
    for i in range(7):
        kind = i % 4
        if kind == 0:
            x = rng.random(n) * (i + 1)
        elif kind == 1:
            x = rng.lognormal(2.0, 1.0, n)
        elif kind == 2:
            x = rng.integers(0, 10**9, n).astype(np.float64)
        else:
            x = 100.0 + rng.random(n) * 1e-9  # every key in one top bucket
        valid = rng.random(n) > 0.1 if i % 3 == 1 else None
        hll_mode = i % 3
        hashvals = rng.integers(-(2**62), 2**62, n) if hll_mode == 2 else None
        columns.append((x, valid, hll_mode, hashvals))
    _check_group(columns, (rng.random(n) > 0.4) if with_where else None, 460)


def test_multi_kernel_degenerate_columns():
    rng = np.random.default_rng(5)
    n = 50_000
    one_valid = np.zeros(n, dtype=bool)
    one_valid[123] = True
    one_val = np.zeros(n)
    one_val[123] = -42.5
    columns = [
        (np.full(n, 3.25), None, 1, None),
        (np.full(n, np.nan), np.zeros(n, dtype=bool), 0, None),
        (one_val, one_valid, 0, None),
        (rng.lognormal(0, 2, n), None, 0, None),
    ]
    _check_group(columns, None, 64)
    _check_group(columns, np.zeros(n, dtype=bool), 64)


@pytest.mark.parametrize("n", [0, 1, 5, 47, 2048, 2049])
def test_multi_kernel_tiny_inputs(n):
    rng = np.random.default_rng(n + 50)
    columns = [
        (rng.random(n) * 3, None, 1, None),
        (rng.lognormal(0.0, 2.0, n), rng.random(n) > 0.5 if n else np.zeros(0, dtype=bool), 0,
         None),
    ]
    _check_group(columns, None, 32)


@pytest.mark.parametrize("cap", [16, 64, 1024, 4096])
def test_multi_kernel_cap_sweep(cap):
    rng = np.random.default_rng(cap)
    n = 200_000
    columns = [
        (rng.random(n) * 7, None, 0, None),
        (rng.lognormal(2.0, 1.0, n), None, 0, None),
        (rng.integers(0, 10**9, n).astype(np.float64), None, 0, None),
    ]
    _check_group(columns, None, cap)


def test_multi_kernel_length_mismatch_returns_none():
    rng = np.random.default_rng(9)
    columns = [(rng.random(100), None, 0, None), (rng.random(99), None, 0, None)]
    assert native.masked_moments_select_multi(columns, None, 32) is None


def _family_data(n=200_000, seed=13):
    """High-cardinality floats: more distinct values than the hash
    counter's bound, so the counts route misses and the kernels run."""
    rng = np.random.default_rng(seed)
    return {
        "a": rng.lognormal(1.0, 0.7, n),
        "b": rng.random(n) * 1000.0,
        "c": rng.standard_normal(n) * 50.0,
        "flag": rng.random(n) < 0.5,
    }


def _family_analyzers(m):
    analyzers = []
    for col in ("a", "b", "c"):
        analyzers += [m.ApproxQuantiles(col, (0.25, 0.5, 0.75)), m.Mean(col),
                      m.StandardDeviation(col), m.ApproxCountDistinct(col)]
    analyzers.append(m.ApproxQuantile("a", 0.5, where="flag"))
    analyzers.append(m.Mean("b", where="flag"))
    return analyzers


def _run_family_analysis(data_or_source):
    import deequ_tpu_torch.analyzers as P
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.runners import AnalysisRunner

    table = Table.from_numpy(data_or_source) if isinstance(data_or_source, dict) else data_or_source
    res = AnalysisRunner.on_data(table, device="cpu").add_analyzers(_family_analyzers(P)).run()
    out = {}
    for analyzer, metric in res.metric_map.items():
        assert metric.value.is_success, (analyzer, metric.value)
        out[repr(analyzer)] = metric.value.get()
    return out


@pytest.fixture
def host_placed(monkeypatch):
    """The family kernels run only for HOST-folded sketch members."""
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")


def test_family_analysis_equals_jax(host_placed):
    import deequ_tpu.analyzers as J
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.runners import AnalysisRunner as JRunner

    got = _run_family_analysis(_family_data())
    res = JRunner.do_analysis_run(
        JTable.from_numpy(_family_data()), _family_analyzers(J), engine="single"
    )
    want = {repr(a): m.value.get() for a, m in res.metric_map.items()}
    assert got.keys() == want.keys()
    for key in want:
        # the same C kernels in both packages: the same bits
        assert got[key] == want[key], key


@pytest.mark.parametrize("switch", ["DEEQU_TPU_NO_MULTI_FAMILY", "DEEQU_TPU_NO_COUNTS_FASTPATH"])
def test_end_to_end_equal_under_toggle(switch, monkeypatch, host_placed):
    """At 60,000 rows every column fits the hash counter, so the counts
    route serves each family. Off, the kernels run: the same counts,
    extremes, samples and registers; a float column's sums agree within
    1e-12 (the counts route adds its distinct values in sorted order,
    the kernel in row order, as the JAX package's own profile test holds
    them). The multi-family switch moves no bit."""
    on = _run_family_analysis(_family_data(n=60_000))
    monkeypatch.setenv(switch, "1")
    off = _run_family_analysis(_family_data(n=60_000))
    assert on.keys() == off.keys()
    for key in on:
        if switch == "DEEQU_TPU_NO_COUNTS_FASTPATH" and key.startswith(("Mean", "StandardDev")):
            assert on[key] == pytest.approx(off[key], rel=1e-12), key
        else:
            assert on[key] == off[key], key


def test_multi_kernel_engages_and_toggle_disables(monkeypatch, host_placed):
    calls = {"multi": 0, "solo": 0}
    real_multi, real_solo = native.masked_moments_select_multi, native.masked_moments_select

    def count_multi(columns, where, cap):
        calls["multi"] += 1
        return real_multi(columns, where, cap)

    def count_solo(*a, **k):
        calls["solo"] += 1
        return real_solo(*a, **k)

    monkeypatch.setattr(native, "masked_moments_select_multi", count_multi)
    monkeypatch.setattr(native, "masked_moments_select", count_solo)
    with runtime.monitored() as stats:
        _run_family_analysis(_family_data())
    # a, b and c share (no where, cap): one batched call; the where group
    # has one sketch member and takes the solo kernel
    assert calls["multi"] >= 1 and calls["solo"] <= 2
    assert stats.family_kernels == calls["multi"] + calls["solo"]
    calls.update(multi=0, solo=0)
    monkeypatch.setenv("DEEQU_TPU_NO_MULTI_FAMILY", "1")
    _run_family_analysis(_family_data())
    assert calls["multi"] == 0 and calls["solo"] >= 3


def test_device_placed_sketches_never_reach_the_family_kernels(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    with runtime.monitored() as stats:
        _run_family_analysis(_family_data(n=20_000))
    assert stats.family_kernels == stats.family_shortcuts == 0


def test_streaming_batches_equal_under_toggle(tmp_path, monkeypatch, host_placed):
    import pyarrow as pa
    import pyarrow.parquet as pq

    from deequ_tpu_torch.data.table import Table

    path = str(tmp_path / "stream.parquet")
    pq.write_table(pa.table(_family_data(n=300_000, seed=21)), path, row_group_size=100_000)

    def stream():
        return Table.scan_parquet(path, batch_rows=100_000)

    batched = _run_family_analysis(stream())
    monkeypatch.setenv("DEEQU_TPU_NO_MULTI_FAMILY", "1")
    assert _run_family_analysis(stream()) == batched


def test_counts_probe_runs_once_per_stream(tmp_path, monkeypatch, host_placed):
    """A high-cardinality column misses the counts route on the first
    batch; the later batches of the scan skip its probe (the memo lives
    for one scan: a second scan probes again)."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from deequ_tpu_torch.data.table import Table

    path = str(tmp_path / "memo.parquet")
    pq.write_table(pa.table(_family_data(n=300_000, seed=22)), path, row_group_size=100_000)
    probes = {"miss": 0}
    real = counts_family.hash_counts_for_column

    def counting(*a, **k):
        res = real(*a, **k)
        if res is None:
            probes["miss"] += 1
        return res

    monkeypatch.setattr(counts_family, "hash_counts_for_column", counting)
    _run_family_analysis(Table.scan_parquet(path, batch_rows=100_000))
    # 4 sketch families, 3 batches: without the memo each miss repeats
    assert 0 < probes["miss"] <= 4
    first_scan = probes["miss"]
    _run_family_analysis(Table.scan_parquet(path, batch_rows=100_000))
    assert probes["miss"] == 2 * first_scan


# -- port-mapped: DataType and the profiler from counts --------------------------------


def test_datatype_from_dictionary_counts_matches_per_row_path(monkeypatch):
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.profiles.column_profiler import ColumnProfiler

    rng = np.random.default_rng(7)
    pool = np.array(["12", "-3", "4.5", "true", "false", "zebra", "", "+8", " 9", "7.", ".5",
                     "NaN"], dtype=object)
    values = pool[rng.integers(0, len(pool), 20_000)]
    values[rng.random(20_000) < 0.1] = None
    for placement in ("device", "host-all"):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
        monkeypatch.delenv("DEEQU_TPU_NO_COUNTS_FASTPATH", raising=False)
        fast = ColumnProfiler.profile(Table.from_pydict({"s": values}), device="cpu").profiles["s"]
        monkeypatch.setenv("DEEQU_TPU_NO_COUNTS_FASTPATH", "1")
        slow = ColumnProfiler.profile(Table.from_pydict({"s": values}), device="cpu").profiles["s"]
        assert fast.type_counts == slow.type_counts
        assert fast.data_type == slow.data_type
        assert fast.completeness == slow.completeness
