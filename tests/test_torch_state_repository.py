"""Persistent partition-state cache (repository/states.py): envelope
serde round trips per state family, corruption/truncation/version-bump
fallback, write atomicity + concurrent-writer locking, partition
fingerprints, plan signatures, `merge_range`, and the cached-vs-scanned
split of `FusedScanPass._run_partitioned` — all under the bit-identity
contract: a cache hit must reproduce the exact bytes a rescan would.

Port-mapped from tests/test_state_repository.py: the same cases against
deequ_tpu_torch, with every run on device="cpu" and the toy tables of
tests/fixtures.py as the port's tables (tests/torch_fixtures.py). The
cases that read a run's trace counters (`tracing=True`) read them, and
the same counts from the port's `runtime.monitored()` too.
"""

from __future__ import annotations

import glob
import os
import struct
import threading

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Correlation,
    CountDistinct,
    DataType,
    Maximum,
    Mean,
    Minimum,
    Size,
    StandardDeviation,
    Sum,
)
from deequ_tpu_torch.analyzers import states as S
from deequ_tpu_torch.analyzers.frequency import FrequenciesAndNumRows
from deequ_tpu_torch.data.table import ColumnType, Table
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.ops.fused import FusedScanPass
from deequ_tpu_torch.repository.states import (
    STATE_FORMAT_VERSION,
    STATE_MAGIC,
    FileSystemStateRepository,
    InMemoryStateRepository,
    StateDecodeError,
    decode_states,
    encode_states,
    merge_states,
    plan_signature,
    plan_signature_for,
)
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner


def _bits(x: float) -> bytes:
    """Bit pattern of a float64 — distinguishes -0.0 from +0.0 and
    pins the exact NaN payload."""
    return struct.pack(">d", float(x))


def _random_table(rng: np.random.Generator, n: int = 500) -> Table:
    x = rng.normal(0.0, 10.0, n)
    x[rng.random(n) < 0.1] = np.nan
    x[rng.random(n) < 0.05] = -0.0
    y = x * 0.5 + rng.normal(0, 1.0, n)
    g = rng.integers(0, 40, n)
    return Table.from_pydict(
        {"x": list(x), "y": list(y), "g": [int(v) for v in g]},
        types={
            "x": ColumnType.DOUBLE,
            "y": ColumnType.DOUBLE,
            "g": ColumnType.LONG,
        },
    )


def _fold(analyzers, table):
    """(analyzer, state) pairs from one fused pass over `table`."""
    results = FusedScanPass(list(analyzers), device="cpu").run(table)
    for r in results:
        assert r.error is None, r.error
    return [(r.analyzer, r.state) for r in results]


# ---------------------------------------------------------------------------
# envelope round trips, per state family
# ---------------------------------------------------------------------------


class TestSerdeRoundTrip:
    def test_moment_states_bit_exact(self):
        """Hand-built moment states with the nasty float values: -0.0,
        NaN, infinities must survive the envelope with the exact bit
        pattern (not just ==, which -0.0/NaN would launder)."""
        pairs = [
            (Size(), S.NumMatches(0)),
            (Completeness("x"), S.NumMatchesAndCount(3, 7)),
            (Sum("x"), S.SumState(-0.0)),
            (Mean("x"), S.MeanState(float("nan"), 4)),
            (Minimum("x"), S.MinState(float("-inf"))),
            (Maximum("x"), S.MaxState(float("inf"))),
            (StandardDeviation("x"), S.StandardDeviationState(5.0, -0.0, 2.5)),
            (
                Correlation("x", "y"),
                S.CorrelationState(3.0, 1.5, float("nan"), -0.0, 0.25, 4.0),
            ),
            (DataType("x"), S.DataTypeHistogram(1, 2, 3, 4, 5)),
        ]
        blob = encode_states(pairs)
        decoded = decode_states(blob, [a for a, _ in pairs])
        for (analyzer, original), restored in zip(pairs, decoded):
            assert type(restored) is type(original), repr(analyzer)
            for name in getattr(original, "__dataclass_fields__", {}):
                a = getattr(original, name)
                b = getattr(restored, name)
                if isinstance(a, float):
                    assert _bits(a) == _bits(b), (repr(analyzer), name)
                else:
                    assert a == b, (repr(analyzer), name)

    def test_frequency_state_round_trip(self):
        state = FrequenciesAndNumRows(
            ["s"],
            [np.array(["", "a b", "it's", "v1"], dtype=object)],
            np.array([3, 1, 4, 1], dtype=np.int64),
            9,
        )
        analyzer = CountDistinct(["s"])
        decoded = decode_states(encode_states([(analyzer, state)]), [analyzer])[0]
        assert decoded.columns == state.columns
        assert decoded.num_rows == state.num_rows
        assert np.array_equal(decoded.counts, state.counts)
        for a, b in zip(decoded.key_columns, state.key_columns):
            assert list(a) == list(b)

    def test_none_state_round_trips_as_identity(self):
        analyzers = [Size(), Mean("x")]
        blob = encode_states([(analyzers[0], S.NumMatches(5)), (analyzers[1], None)])
        decoded = decode_states(blob, analyzers)
        assert decoded[0] == S.NumMatches(5)
        assert decoded[1] is None
        assert merge_states(None, decoded[0]) == S.NumMatches(5)
        assert merge_states(decoded[0], None) == S.NumMatches(5)

    @pytest.mark.parametrize("seed", range(4))
    def test_folded_states_round_trip_and_merge_bit_identical(self, seed):
        """The property that makes the cache sound: for every cacheable
        family (moments, HLL, KLL), metric(merge(decode(encode(s1)),
        decode(encode(s2)))) must equal metric(merge(s1, s2)) BIT-exactly
        — including the KLL sketch, whose merge draws compaction offsets
        from its serialized rng position."""
        rng = np.random.default_rng(9_100 + seed)
        analyzers = [
            Size(),
            Completeness("x"),
            Sum("x"),
            Mean("x"),
            Minimum("x"),
            Maximum("x"),
            StandardDeviation("x"),
            Correlation("x", "y"),
            DataType("x"),
            ApproxCountDistinct("g"),
            ApproxQuantile("x", 0.5),
        ]
        pairs_a = _fold(analyzers, _random_table(rng, int(rng.integers(50, 1200))))
        pairs_b = _fold(analyzers, _random_table(rng, int(rng.integers(50, 1200))))

        direct = [
            merge_states(sa, sb)
            for (_, sa), (_, sb) in zip(pairs_a, pairs_b)
        ]
        cached = [
            merge_states(sa, sb)
            for sa, sb in zip(
                decode_states(encode_states(pairs_a), analyzers),
                decode_states(encode_states(pairs_b), analyzers),
            )
        ]
        for analyzer, s_direct, s_cached in zip(analyzers, direct, cached):
            m_direct = analyzer.compute_metric_from(s_direct)
            m_cached = analyzer.compute_metric_from(s_cached)
            assert m_direct.value.is_success == m_cached.value.is_success, (
                repr(analyzer)
            )
            if m_direct.value.is_success:
                va, vb = m_direct.value.get(), m_cached.value.get()
                if isinstance(va, float):
                    assert _bits(va) == _bits(vb), (repr(analyzer), va, vb)
                else:
                    assert va == vb, repr(analyzer)

    def test_kll_rng_position_survives_serde(self):
        """The sketch's generator position is part of its state: without
        it, a deserialized partial merges differently from the live one."""
        rng = np.random.default_rng(7)
        analyzer = ApproxQuantile("x", 0.25)
        ((_, state),) = _fold([analyzer], _random_table(rng, 3000))
        restored = decode_states(
            encode_states([(analyzer, state)]), [analyzer]
        )[0]
        assert state.digest.rng_state_bytes() == restored.digest.rng_state_bytes()
        other = _fold([analyzer], _random_table(rng, 2000))[0][1]
        assert _bits(state.merge(other).digest.quantile(0.25)) == _bits(
            restored.merge(other).digest.quantile(0.25)
        )


# ---------------------------------------------------------------------------
# corruption / truncation / version drift -> rescan, never a wrong answer
# ---------------------------------------------------------------------------


class TestEnvelopeDefects:
    def _blob(self):
        analyzers = [Size(), Mean("x")]
        pairs = [(analyzers[0], S.NumMatches(11)), (analyzers[1], S.MeanState(2.5, 4))]
        return encode_states(pairs), analyzers

    def test_bit_flip_raises_digest_mismatch(self):
        blob, analyzers = self._blob()
        corrupt = bytearray(blob)
        corrupt[len(blob) // 2] ^= 0x40
        with pytest.raises(StateDecodeError, match="digest mismatch"):
            decode_states(bytes(corrupt), analyzers)

    @pytest.mark.parametrize("keep", [0, 3, 11, -1])
    def test_truncation_raises(self, keep):
        blob, analyzers = self._blob()
        with pytest.raises(StateDecodeError):
            decode_states(blob[: keep if keep >= 0 else len(blob) - 5], analyzers)

    def test_version_bump_raises(self):
        """A well-formed envelope from a FUTURE serde version (valid
        digest, different version word) must be refused, not guessed at."""
        blob, analyzers = self._blob()
        body = bytearray(blob[:-32])
        struct.pack_into(">I", body, len(STATE_MAGIC), STATE_FORMAT_VERSION + 1)
        import hashlib

        rebuilt = bytes(body) + hashlib.sha256(bytes(body)).digest()
        with pytest.raises(StateDecodeError, match="version"):
            decode_states(rebuilt, analyzers)

    def test_missing_analyzer_raises(self):
        blob, _ = self._blob()
        with pytest.raises(StateDecodeError, match="no state for analyzer"):
            decode_states(blob, [Size(), Minimum("x")])

    def test_load_states_degrades_to_none_with_dq314(self):
        repo = InMemoryStateRepository()
        blob, analyzers = self._blob()
        corrupt = bytearray(blob)
        corrupt[-1] ^= 0xFF
        repo._put("ds", "sig", "fp0", bytes(corrupt))
        with pytest.warns(RuntimeWarning, match="DQ314"):
            assert repo.load_states("ds", "fp0", "sig", analyzers) is None

    def test_corrupt_entry_falls_back_to_rescan_end_to_end(self, tmp_path, monkeypatch):
        """Corrupt one on-disk .dqstate: the warm run warns DQ314, scans
        exactly that partition, and the metrics stay bit-identical."""
        monkeypatch.delenv("DEEQU_TPU_STATE_CACHE", raising=False)
        rng = np.random.default_rng(42)
        data_dir = tmp_path / "data"
        data_dir.mkdir()
        for i in range(3):
            _random_table(rng, 400 + 13 * i).to_parquet(
                str(data_dir / f"p{i}.parquet"), row_group_size=128
            )
        analyzers = [Size(), Mean("x"), StandardDeviation("x")]
        repo = FileSystemStateRepository(str(tmp_path / "cache"))

        cold = AnalysisRunner.do_analysis_run(
            Table.scan_parquet_dataset(str(data_dir)), analyzers,
            state_repository=repo, dataset_name="defects", device="cpu"
        )
        entries = sorted(glob.glob(str(tmp_path / "cache" / "**" / "*.dqstate"),
                                   recursive=True))
        assert len(entries) == 3
        raw = bytearray(open(entries[1], "rb").read())
        raw[len(raw) // 3] ^= 0x01
        with open(entries[1], "wb") as fh:
            fh.write(raw)

        with pytest.warns(RuntimeWarning, match="DQ314"), runtime.monitored() as stats:
            warm = AnalysisRunner.do_analysis_run(
                Table.scan_parquet_dataset(str(data_dir)), analyzers,
                state_repository=repo, dataset_name="defects", device="cpu", tracing=True,
            )
        assert stats.partitions_cached == 2
        assert stats.partitions_scanned == 1
        counters = warm.run_trace.counters
        assert counters["partitions_cached"] == 2
        assert counters["partitions_scanned"] == 1
        for a in analyzers:
            assert _bits(cold.metric_map[a].value.get()) == _bits(
                warm.metric_map[a].value.get()
            )


# ---------------------------------------------------------------------------
# filesystem backend: atomicity + concurrent writers
# ---------------------------------------------------------------------------


class TestFileSystemBackend:
    def test_writes_are_atomic_no_tmp_left_behind(self, tmp_path):
        repo = FileSystemStateRepository(str(tmp_path))
        pairs = [(Size(), S.NumMatches(1))]
        assert repo.save_states("ds", "fp", "sig", pairs)
        leftovers = [
            p for p in glob.glob(str(tmp_path / "**" / "*"), recursive=True)
            if p.endswith(".tmp")
        ]
        assert leftovers == []
        assert repo.load_states("ds", "fp", "sig", [Size()]) == [S.NumMatches(1)]

    def test_unserializable_state_is_not_cached(self, tmp_path):
        class OpaqueAnalyzer:
            """No serialize_state family handles this analyzer."""

            def __repr__(self):
                return "OpaqueAnalyzer()"

        class OpaqueState:
            def merge(self, other):
                return self

        repo = FileSystemStateRepository(str(tmp_path))
        assert not repo.save_states(
            "ds", "fp", "sig", [(OpaqueAnalyzer(), OpaqueState())]
        )
        assert not repo.has_states("ds", "fp", "sig")

    def test_two_concurrent_writers_never_interleave(self, tmp_path):
        """Regression: two threads hammering the same dataset (including
        the same partition key) must leave every entry decodable — the
        per-dataset lock plus tmp+rename forbids torn or mixed files."""
        repo = FileSystemStateRepository(str(tmp_path))
        analyzers = [Size(), Mean("x")]
        barrier = threading.Barrier(2)
        errors: list = []

        def writer(tid: int) -> None:
            try:
                barrier.wait()
                for i in range(40):
                    pairs = [
                        (analyzers[0], S.NumMatches(1000 * tid + i)),
                        (analyzers[1], S.MeanState(float(tid), i + 1)),
                    ]
                    # fp-shared is contended by both threads; fp-<tid>-<i>
                    # is private — both must end up internally consistent
                    repo.save_states("ds", "fp-shared", "sig", pairs)
                    repo.save_states("ds", f"fp-{tid}-{i}", "sig", pairs)
                    loaded = repo.load_states("ds", "fp-shared", "sig", analyzers)
                    if loaded is not None:
                        size, mean = loaded
                        # an entry is one thread's write in full or the
                        # other's — never a mixture
                        assert size.num_matches // 1000 == int(mean.total), (
                            size, mean,
                        )
            except BaseException as e:  # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=writer, args=(t,)) for t in (1, 2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert errors == []
        for tid in (1, 2):
            for i in range(40):
                assert repo.load_states(
                    "ds", f"fp-{tid}-{i}", "sig", analyzers
                ) is not None

    def test_exotic_dataset_names_stay_one_path_component(self, tmp_path):
        repo = FileSystemStateRepository(str(tmp_path))
        pairs = [(Size(), S.NumMatches(2))]
        for name in ("../escape", "a/b", "sp ace", ""):
            assert repo.save_states(name, "fp", "sig", pairs)
            assert repo.load_states(name, "fp", "sig", [Size()]) == [
                S.NumMatches(2)
            ]
        assert not os.path.exists(str(tmp_path.parent / "escape"))


# ---------------------------------------------------------------------------
# fingerprints + plan signatures
# ---------------------------------------------------------------------------


class TestKeys:
    def test_fingerprint_stable_and_content_sensitive(self, tmp_path):
        from deequ_tpu_torch.data.source import partition_fingerprint

        rng = np.random.default_rng(3)
        path = str(tmp_path / "p0.parquet")
        _random_table(rng, 300).to_parquet(path, row_group_size=100)
        fp1 = partition_fingerprint(path)
        assert fp1 == partition_fingerprint(path)

        # same basename in another directory (dataset relocated):
        # fingerprint survives, so the cache stays warm after a move
        moved = tmp_path / "moved"
        moved.mkdir()
        import shutil

        shutil.copy(path, str(moved / "p0.parquet"))
        assert partition_fingerprint(str(moved / "p0.parquet")) == fp1

        # rewritten content self-invalidates
        _random_table(rng, 301).to_parquet(path, row_group_size=100)
        assert partition_fingerprint(path) != fp1

    def test_fingerprint_memoized_by_stat_signature(self, tmp_path, monkeypatch):
        """An unchanged file (same device/inode/size/mtime_ns) must hit
        the fingerprint memo without re-reading the parquet footer —
        that's what keeps a preempted run's time-to-first-resume-boundary
        flat in partition count. Any rewrite changes the stat signature
        and recomputes."""
        import pyarrow.parquet as pq

        from deequ_tpu_torch.data.source import partition_fingerprint

        rng = np.random.default_rng(5)
        path = str(tmp_path / "m0.parquet")
        _random_table(rng, 200).to_parquet(path, row_group_size=100)
        fp1 = partition_fingerprint(path)

        def boom(*args, **kwargs):
            raise AssertionError("footer re-read on unchanged file")

        monkeypatch.setattr(pq, "ParquetFile", boom)
        assert partition_fingerprint(path) == fp1
        monkeypatch.undo()

        _random_table(rng, 201).to_parquet(path, row_group_size=100)
        assert partition_fingerprint(path) != fp1

    def test_plan_signature_sensitivity(self):
        base = dict(
            placement="device", compute_dtype="float64",
            batch_size=None, batch_rows=1 << 20,
        )
        sig = plan_signature([Size(), Mean("x")], **base)
        assert sig == plan_signature([Size(), Mean("x")], **base)
        assert sig != plan_signature([Mean("x"), Size()], **base)
        assert sig != plan_signature([Size()], **base)
        assert sig != plan_signature(
            [Size(), Mean("x")], **{**base, "placement": "host"}
        )
        assert sig != plan_signature(
            [Size(), Mean("x")], **{**base, "compute_dtype": "float32"}
        )
        assert sig != plan_signature(
            [Size(), Mean("x")], **{**base, "batch_rows": 1 << 19}
        )


# ---------------------------------------------------------------------------
# merge_range: zero-scan range metrics
# ---------------------------------------------------------------------------


class TestMergeRange:
    def test_merge_range_matches_full_scan(self, tmp_path, monkeypatch):
        monkeypatch.delenv("DEEQU_TPU_STATE_CACHE", raising=False)
        rng = np.random.default_rng(11)
        data_dir = tmp_path / "data"
        data_dir.mkdir()
        for i in range(4):
            _random_table(rng, 200 + 31 * i).to_parquet(
                str(data_dir / f"p{i}.parquet"), row_group_size=64
            )
        analyzers = [Size(), Mean("x"), ApproxQuantile("x", 0.5)]
        repo = FileSystemStateRepository(str(tmp_path / "cache"))
        source = Table.scan_parquet_dataset(str(data_dir))
        full = AnalysisRunner.do_analysis_run(
            source, analyzers, state_repository=repo, dataset_name="range", device="cpu"
        )

        signature = plan_signature_for(analyzers, source, device="cpu")
        fingerprints = [p.fingerprint for p in source.partitions()]
        ranged = repo.merge_range("range", fingerprints, analyzers, signature, device="cpu")
        for a in analyzers:
            assert _bits(full.metric_map[a].value.get()) == _bits(
                ranged.metric_map[a].value.get()
            )

        # a strict subset must equal a direct scan of those files
        subset = source.partitions()[1:3]
        sub_source = Table.scan_parquet_dataset([p.path for p in subset])
        direct = AnalysisRunner.do_analysis_run(sub_source, analyzers, device="cpu")
        ranged_subset = repo.merge_range(
            "range", [p.fingerprint for p in subset], analyzers, signature, device="cpu"
        )
        for a in analyzers:
            assert _bits(direct.metric_map[a].value.get()) == _bits(
                ranged_subset.metric_map[a].value.get()
            )

    def test_merge_range_missing_partition_raises(self):
        repo = InMemoryStateRepository()
        with pytest.raises(KeyError):
            repo.merge_range("ds", ["nope"], [Size()], "sig", device="cpu")


# ---------------------------------------------------------------------------
# the kill switch
# ---------------------------------------------------------------------------


def test_state_cache_kill_switch(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    for i in range(3):
        _random_table(rng, 150).to_parquet(str(data_dir / f"p{i}.parquet"))
    analyzers = [Size(), Mean("x")]
    repo = FileSystemStateRepository(str(tmp_path / "cache"))

    monkeypatch.delenv("DEEQU_TPU_STATE_CACHE", raising=False)
    warm_prep = AnalysisRunner.do_analysis_run(
        Table.scan_parquet_dataset(str(data_dir)), analyzers,
        state_repository=repo, dataset_name="kill", device="cpu"
    )
    monkeypatch.setenv("DEEQU_TPU_STATE_CACHE", "0")
    with runtime.monitored() as stats:
        off = AnalysisRunner.do_analysis_run(
            Table.scan_parquet_dataset(str(data_dir)), analyzers,
            state_repository=repo, dataset_name="kill", device="cpu", tracing=True,
        )
    assert stats.partitions_scanned == 3
    assert stats.partitions_cached == 0
    counters = off.run_trace.counters
    assert counters["partitions_scanned"] == 3
    assert "partitions_cached" not in counters
    for a in analyzers:
        assert _bits(warm_prep.metric_map[a].value.get()) == _bits(
            off.metric_map[a].value.get()
        )
