"""The encoded fold in the port against the JAX package's, on the CPU:
analyzer families folded over (run length, dictionary code) streams
straight from the C reader, under the host placement.

- Chunk level: `decode_chunk_runs` gives the JAX package's run streams
  and dictionary bit for bit, and `expand_runs` gives exactly what the
  row-width `decode_chunk` gives (long runs, bit-packed alternation,
  all-null pages).
- Failing closed: a dictionary past the code cap and corrupt run streams
  refuse, never fold wrong values.
- The planner: `classify_encfold_columns` approves and refuses the JAX
  package's columns with its reasons (read from `runtime.monitored()`),
  and the plan signature is keyed on the fold mode.
- Suite level: runs with `DEEQU_TPU_ENCODED_FOLD` on and off give the
  same bits, the counts show the fold engaged, and the metrics equal
  the JAX package's (sums within 1e-12; the rest exact).

Port-mapped from tests/test_encoded_fold.py. Left out:
`test_chaos_decode_runs_fault_falls_back_bit_identical` (the
`testing.faults` chaos directive, ROADMAP queue 1 item 8); the EXPLAIN
plan line of `test_classifier_names_the_disqualifying_property` and
`test_kill_switch_disables_planning` (item 8: their reasons and the
absent verdict are read from `runtime.monitored()` here).
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu.data import native_reader as jax_nr
from deequ_tpu.data.source import ParquetSource as JSource
from deequ_tpu_torch.data import native_reader as nr
from deequ_tpu_torch.data.source import ParquetSource
from deequ_tpu_torch.ops import native, runtime

pytestmark = pytest.mark.usefixtures("_host_placement")


@pytest.fixture
def _host_placement(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
    monkeypatch.delenv("DEEQU_TPU_NO_NATIVE", raising=False)
    monkeypatch.delenv("DEEQU_TPU_ENCODED_FOLD", raising=False)
    native.reset()
    yield
    native.reset()


def _write(table, path, version="1.0", row_group_size=None, **kw):
    pq.write_table(table, path, compression="NONE", version=version,
                   row_group_size=row_group_size or table.num_rows, **kw)


def _chunks(tmp_path, column_arrays, name, version="1.0", **kw):
    """Raw bytes and recipes of every (group, column) chunk of a file, in
    both packages."""
    path = tmp_path / f"{name}.parquet"
    _write(pa.table(column_arrays), path, version=version, **kw)
    metas = ParquetSource(str(path))._reader_chunk_meta(frozenset(column_arrays))
    jmetas = JSource(str(path))._reader_chunk_meta(frozenset(column_arrays))
    fd = os.open(str(path), os.O_RDONLY)
    try:
        return {key: (nr.fetch_chunk(fd, meta), meta, jmetas[key]) for key, meta in metas.items()}
    finally:
        os.close(fd)


def _assert_expansion_bit_identical(raw, meta, jmeta):
    """decode_chunk_runs, then expand_runs, equals decode_chunk exactly;
    the run streams equal the JAX package's."""
    rc = nr.decode_chunk_runs(raw, meta)
    assert rc is not None, meta.column
    jrc = jax_nr.decode_chunk_runs(raw, jmeta)
    for field in ("run_len", "run_code", "def_len", "def_val"):
        assert np.array_equal(getattr(rc, field), getattr(jrc, field)), field
    assert rc.dict_values.tobytes() == jrc.dict_values.tobytes()
    assert (rc.kind, rc.null_count, rc.num_values) == (jrc.kind, jrc.null_count, jrc.num_values)
    row = nr.decode_chunk(raw, meta)
    exp = nr.expand_runs(rc)
    assert row is not None and exp is not None
    assert exp.null_count == row.null_count == rc.null_count
    if row.validity is not None:
        nbits = row.num_values
        assert np.array_equal(np.unpackbits(exp.validity, bitorder="little")[:nbits],
                              np.unpackbits(row.validity, bitorder="little")[:nbits])
    assert exp.values.tobytes() == row.values.tobytes()
    return rc


@pytest.mark.parametrize("version", ["1.0", "2.6"])
def test_runs_decode_long_runs_bit_identical(tmp_path, version):
    n = 6000
    sorted_vals = np.sort(np.repeat(np.arange(12, dtype=np.int64), n // 12))
    rng = np.random.default_rng(5)
    chunks = _chunks(tmp_path, {
        "long": pa.array(sorted_vals),
        "nullish": pa.array(sorted_vals.astype(np.float64) * 0.5, mask=rng.random(n) < 0.15),
    }, f"longruns_{version}", version=version)
    for (_g, name), (raw, meta, jmeta) in chunks.items():
        rc = _assert_expansion_bit_identical(raw, meta, jmeta)
        if name == "long":
            assert len(rc.run_len) < n // 50, "runs did not coalesce"
        assert int(np.sum(rc.run_len)) == rc.num_values - rc.null_count


def test_runs_decode_bitpacked_groups_bit_identical(tmp_path):
    n = 4097  # ends inside a bit-packed group
    rng = np.random.default_rng(11)
    vals = rng.integers(0, 64, size=n).astype(np.int64)
    chunks = _chunks(tmp_path, {"alt": pa.array(vals, mask=rng.random(n) < 0.5)}, "bitpacked",
                     data_page_size=2048)
    for (_g, _name), (raw, meta, jmeta) in chunks.items():
        rc = _assert_expansion_bit_identical(raw, meta, jmeta)
        assert native.encfold_def_nulls(rc.def_len, rc.def_val, rc.num_values) == rc.null_count


def test_runs_decode_all_null_def_runs(tmp_path):
    n = 5000
    vals = np.full(n, None, dtype=object)
    vals[-400:] = [float(i % 6) for i in range(400)]
    chunks = _chunks(tmp_path, {"mostly": pa.array(list(vals), type=pa.float64())},
                     "allnullpages", data_page_size=1024)
    ((_g, _name), (raw, meta, jmeta)) = next(iter(chunks.items()))
    rc = _assert_expansion_bit_identical(raw, meta, jmeta)
    assert rc.null_count == n - 400
    assert int(np.sum(rc.run_len)) == 400
    assert int(rc.def_len.max()) > 1024  # the null runs coalesced across pages
    # an entirely null chunk (an empty dictionary) fails in both decoders
    chunks = _chunks(tmp_path, {"gone": pa.array([None] * 1500, type=pa.float64())}, "allnull")
    ((_g, _name), (raw, meta, _j)) = next(iter(chunks.items()))
    assert nr.decode_chunk_runs(raw, meta) is None
    assert nr.decode_chunk(raw, meta) is None


def test_dict_code_overflow_fails_closed(tmp_path):
    n = native.ENCFOLD_DICT_CAP + 1000
    chunks = _chunks(tmp_path, {"wide": pa.array(np.arange(n, dtype=np.int64))}, "overflow",
                     use_dictionary=True, dictionary_pagesize_limit=1 << 21)
    ((_g, _name), (raw, meta, _j)) = next(iter(chunks.items()))
    if nr.decode_chunk(raw, meta) is None:
        pytest.skip("the writer produced no decodable chunk")
    assert nr.decode_chunk_runs(raw, meta) is None


def test_corrupt_run_streams_fail_closed():
    run_len = np.array([3, 5, 2], dtype=np.int64)
    run_code = np.array([0, 1, 0], dtype=np.uint32)
    assert native.encfold_code_counts(run_len, run_code, 2).tolist() == [5, 5]
    bad_len = run_len.copy()
    bad_len[1] = 0
    assert native.encfold_code_counts(bad_len, run_code, 2) is None
    bad_code = run_code.copy()
    bad_code[2] = 9
    assert native.encfold_code_counts(run_len, bad_code, 2) is None
    def_len = np.array([7, 3], dtype=np.int64)
    def_val = np.array([1, 0], dtype=np.uint8)
    assert native.encfold_def_nulls(def_len, def_val, 10) == 3
    assert native.encfold_def_nulls(def_len, def_val, 11) is None
    assert native.encfold_def_nulls(def_len, np.array([1, 2], dtype=np.uint8), 10) is None


def test_payload_slices_equal_jax(tmp_path):
    """A batch's value multiset from run slices that cross chunk and run
    boundaries equals the JAX package's, and the multiset of the rows."""
    from deequ_tpu.data import encfold as jax_encfold
    from deequ_tpu_torch.data import encfold

    n = 9000
    rng = np.random.default_rng(4)
    vals = np.repeat(rng.integers(0, 20, n // 30), 30).astype(np.int64)
    chunks = _chunks(tmp_path, {"c": pa.array(vals, mask=rng.random(n) < 0.1)}, "slices",
                     row_group_size=4000)
    segs = [nr.decode_chunk_runs(raw, meta) for (_g, _n), (raw, meta, _j) in sorted(chunks.items())]
    jsegs = [jax_nr.decode_chunk_runs(raw, jmeta)
             for (_g, _n), (raw, _m, jmeta) in sorted(chunks.items())]
    spec = encfold.EncFoldColSpec("c", "int64", "i64", True)
    jspec = jax_encfold.EncFoldColSpec("c", "int64", "i64", True)
    for start, stop in [(0, 9000), (1234, 5678), (3999, 4001), (8000, 9000)]:
        got = encfold.build_payload(spec, segs, start, stop)
        want = jax_encfold.build_payload(jspec, jsegs, start, stop)
        assert np.array_equal(got.values, want.values) and np.array_equal(got.counts, want.counts)
        assert (got.n_rows, got.null_count, got.runs) == (want.n_rows, want.null_count, want.runs)
        rows = nr.assemble_column("c", "int64", [nr.expand_runs(s) for s in segs], start, stop, {})
        live = np.asarray(rows.values)[np.asarray(rows.valid)]
        uniq, counts = np.unique(live, return_counts=True)
        assert np.array_equal(got.values, uniq) and np.array_equal(got.counts, counts)


def _low_card_table(n=12000, seed=3):
    rng = np.random.default_rng(seed)
    return pa.table({
        "code": pa.array(rng.integers(0, 40, n).astype(np.int64), mask=rng.random(n) < 0.07),
        "price": pa.array(rng.choice(np.round(rng.normal(0, 5, 25), 3), n),
                          mask=rng.random(n) < 0.05),
    })


def _suite(m):
    return [m.Mean("code"), m.Sum("code"), m.Minimum("code"), m.Maximum("code"),
            m.Completeness("code"), m.ApproxQuantile("price", 0.5),
            m.ApproxCountDistinct("price"), m.Mean("price")]


def _run_suite(path, analyzers=None, batch_rows=8192):
    import deequ_tpu_torch.analyzers as P
    from deequ_tpu_torch.runners import AnalysisRunner

    with runtime.monitored() as stats:
        ctx = AnalysisRunner.on_data(ParquetSource(path, batch_rows=batch_rows), device="cpu") \
            .add_analyzers(analyzers or _suite(P)).run()
    values = {repr(a): (m.value.get() if m.value.is_success else None)
              for a, m in ctx.metric_map.items()}
    return values, stats


def _hex(values):
    return {k: (float(v).hex() if isinstance(v, float) else v) for k, v in values.items()}


@pytest.mark.parametrize("pipeline", ["1", "0"])
def test_suite_bit_identical_and_counters(tmp_path, monkeypatch, pipeline):
    monkeypatch.setenv("DEEQU_TPU_PIPELINE", pipeline)
    path = str(tmp_path / "enc.parquet")
    _write(_low_card_table(), path, row_group_size=4096)
    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", "0")
    baseline, off = _run_suite(path)
    assert off.encfold_cols_total == 0 and off.encfold_chunks == 0
    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", "1")
    got, on = _run_suite(path)
    assert _hex(got) == _hex(baseline)
    assert sorted(on.encfold_planned) == ["code", "price"]
    assert (on.encfold_cols, on.encfold_cols_total) == (2, 2)
    assert on.encfold_chunks == 6 and on.encfold_chunks_fallback == 0
    assert on.encfold_runs > 0 and on.encfold_values == 24000
    assert on.encfold_codes_folded > 0
    # the published memos serve the sketch: no family kernel runs
    assert on.family_kernels == 0 and on.device_launches == 0


def test_suite_equals_jax(tmp_path, monkeypatch):
    import deequ_tpu.analyzers as J
    from deequ_tpu.runners import AnalysisRunner as JRunner

    path = str(tmp_path / "enc.parquet")
    _write(_low_card_table(), path, row_group_size=4096)
    got, _ = _run_suite(path)
    jctx = JRunner.do_analysis_run(JSource(path, batch_rows=8192), _suite(J), engine="single")
    want = {repr(a): m.value.get() for a, m in jctx.metric_map.items()}
    assert got.keys() == want.keys()
    for key in want:
        if key.startswith(("Mean", "Sum")):
            assert got[key] == pytest.approx(want[key], rel=1e-12), key
        else:
            assert got[key] == want[key], key


def test_all_null_column_suite_completeness(tmp_path, monkeypatch):
    import deequ_tpu_torch.analyzers as P

    n = 5000
    rng = np.random.default_rng(9)
    t = pa.table({"gone": pa.array([None] * n, type=pa.int64()),
                  "code": pa.array(rng.integers(0, 9, n).astype(np.int64))})
    path = str(tmp_path / "nul.parquet")
    _write(t, path, row_group_size=2048)
    analyzers = [P.Completeness("gone"), P.ApproxCountDistinct("gone"), P.Completeness("code"),
                 P.Mean("code")]
    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", "0")
    baseline, _ = _run_suite(path, analyzers, batch_rows=4096)
    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", "1")
    got, stats = _run_suite(path, analyzers, batch_rows=4096)
    assert _hex(got) == _hex(baseline)
    assert stats.encfold_cols >= 1
    assert baseline["Completeness(gone,None)"] == 0.0


def test_classifier_names_the_disqualifying_property(tmp_path):
    """The fall-off reasons carry their class prefix (analyzer, dict-size,
    codec) and equal the JAX package's classifier's on the same plan."""
    import deequ_tpu.analyzers as J
    import deequ_tpu_torch.analyzers as P
    from deequ_tpu.ops import fused as jax_fused
    from deequ_tpu_torch.ops import fused

    n = 9000
    rng = np.random.default_rng(2)
    t = pa.table({
        "ok_m": pa.array(rng.integers(0, 20, n).astype(np.int64)),
        "ok_d": pa.array(rng.choice(np.round(rng.normal(0, 2, 16), 2), n)),
        "sd": pa.array(rng.integers(0, 6, n).astype(np.int64)),
        "uniq": pa.array(rng.integers(0, 30, n).astype(np.int64)),
        "uniq2": pa.array(rng.integers(0, 30, n).astype(np.int64)),
        "wh": pa.array(rng.integers(0, 7, n).astype(np.int64)),
        "plainish": pa.array(rng.normal(size=n)),
        "plaincodec": pa.array(rng.integers(0, 50, n).astype(np.int64)),
    })
    path = str(tmp_path / "cls.parquet")
    # plaincodec has no dictionary pages: a codec falloff though its
    # consumer (a sketch family) is memo-servable
    _write(t, path, row_group_size=n, use_dictionary=[c for c in t.column_names
                                                      if c != "plaincodec"])

    def analyzers(m):
        return [m.Mean("ok_m"), m.ApproxCountDistinct("ok_d"), m.StandardDeviation("sd"),
                m.Correlation("uniq", "uniq2"), m.Mean("wh", where="wh > 2"),
                m.Mean("plainish"), m.ApproxCountDistinct("plaincodec")]

    _values, stats = _run_suite(path, analyzers(P), batch_rows=4096)
    reasons = dict(stats.encfold_falloffs)
    assert sorted(stats.encfold_planned) == ["ok_d", "ok_m"]
    assert "StandardDeviation" in reasons["sd"]
    assert "Correlation" in reasons["uniq"] and "uniq2" in reasons
    assert "where" in reasons["wh"]
    assert reasons["plainish"].startswith("dict-size:")
    assert reasons["plaincodec"].startswith("codec:")
    # the JAX package's classifier on its own plan of the same pass
    src = JSource(path, batch_rows=4096)
    jplan = jax_fused.plan_scan_members(analyzers(J), "host-all")
    groups = src.row_group_stats()
    cols = sorted(reasons) + sorted(stats.encfold_planned)
    col_types = {c: src.decode_column_types()[c] for c in cols}
    jspecs, jfalloffs = jax_fused.classify_encfold_columns(
        col_types, analyzers(J), jplan.specs, jplan.device_keys, groups,
        int_bounds=jax_fused.wire_int_bounds_from_groups(groups, cols),
    )
    assert dict(jfalloffs) == reasons
    assert sorted(jspecs) == sorted(stats.encfold_planned)
    pplan = fused.plan_scan_members(analyzers(P), "host-all")
    pgroups = ParquetSource(path).row_group_stats()
    pspecs, _ = fused.classify_encfold_columns(
        col_types, analyzers(P), pplan.specs, pplan.device_keys, pgroups,
        int_bounds=fused.wire_int_bounds_from_groups(pgroups, cols),
    )
    for name, spec in pspecs.items():
        j = jspecs[name]
        assert (spec.token, spec.kind, spec.publish_moments) == (j.token, j.kind,
                                                                 j.publish_moments)


def test_device_placed_consumers_fall_off(tmp_path, monkeypatch):
    path = str(tmp_path / "dev.parquet")
    _write(_low_card_table(), path, row_group_size=4096)
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
    _values, stats = _run_suite(path)
    assert stats.encfold_cols == 0 and stats.encfold_chunks == 0
    assert dict(stats.encfold_falloffs) == {
        "code": "analyzer: consumed by a device-placed member",
        "price": "analyzer: consumed by a device-placed member",
    }


def test_row_group_stats_equal_jax(tmp_path):
    path = str(tmp_path / "stats.parquet")
    _write(_low_card_table(), path, row_group_size=4096)
    got = ParquetSource(path).row_group_stats()
    want = JSource(path).row_group_stats()
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert (g.index, g.num_rows) == (w.index, w.num_rows)
        assert g.columns.keys() == w.columns.keys()
        for name in g.columns:
            assert vars(g.columns[name]) == vars(w.columns[name]), name


def test_plan_signature_keyed_on_fold_mode(monkeypatch):
    import deequ_tpu_torch.analyzers as P
    from deequ_tpu_torch.repository.states import plan_signature_for

    cpu = runtime.resolve_device("cpu")
    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", "1")
    assert "encfold" in runtime.fold_signature_variant(cpu)
    on = plan_signature_for([P.Mean("code")], device="cpu")
    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", "0")
    assert "encfold" not in runtime.fold_signature_variant(cpu)
    assert plan_signature_for([P.Mean("code")], device="cpu") != on


def test_kill_switch_disables_planning(tmp_path, monkeypatch):
    path = str(tmp_path / "off.parquet")
    _write(_low_card_table(4000), path)
    monkeypatch.setenv("DEEQU_TPU_ENCODED_FOLD", "0")
    assert not runtime.encoded_fold_enabled()
    _values, stats = _run_suite(path)
    assert stats.encfold_cols_total == 0 and not stats.encfold_falloffs


def test_stub_expands_to_the_row_route(tmp_path, monkeypatch):
    """A batch's stub Column gives the rows the row route gives, to a
    reader the plan did not foresee."""
    from deequ_tpu_torch.data import encfold
    from deequ_tpu_torch.data.table import Table

    path = str(tmp_path / "stub.parquet")
    _write(_low_card_table(), path, row_group_size=4096)
    src = ParquetSource(path, batch_rows=5000).with_encoded_fold({
        "code": encfold.EncFoldColSpec("code", "int64", "i64", True),
    }).with_native_reader(["code", "price"])
    src = src.with_decode_fastpath(["code", "price"])
    rows = Table.scan_parquet(path, batch_rows=5000)
    for got, want in zip(src.batches(5000), rows.batches(5000)):
        col = got.column("code")
        assert isinstance(col, encfold.EncFoldStub)
        assert "code" in got.encfold
        assert np.array_equal(np.asarray(col.valid), np.asarray(want.column("code").valid))
        assert np.asarray(col.values).tobytes() == np.asarray(want.column("code").values).tobytes()
