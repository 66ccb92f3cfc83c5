"""The port's sharded streaming scan (parallel/multihost.py:
run_sharded_analysis): every shard folds its own partitions through the
solo partitioned scan's sub-scan and the shards all-merge per-partition
state envelopes. A port-mapped copy of tests/test_sharded_scan.py.

What is pinned: a sharded run at any shard count (with an excluded
shard, after a lost envelope, a corrupt entry, a cancel and a resume) is
bit for bit the port's solo partitioned run, the two share a state
repository in both directions, and the shard envelopes are byte for byte
the JAX package's. The gather is injected: N shards run as N threads
over a barrier gather (tests/test_torch_multihost.py runs real
processes)."""

from __future__ import annotations

import os
import threading
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu.repository import states as jstates
from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Maximum,
    Mean,
    Minimum,
    StandardDeviation,
    Sum,
    Uniqueness,
)
from deequ_tpu_torch.core.controller import RunCancelled, RunController, SharedCancelToken
from deequ_tpu_torch.data.source import PartitionedParquetSource
from deequ_tpu_torch.ops import fused, runtime
from deequ_tpu_torch.parallel import run_sharded_analysis
from deequ_tpu_torch.repository.states import (
    FileSystemStateRepository,
    StateDecodeError,
    decode_shard_states,
    encode_shard_states,
)
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner
from deequ_tpu_torch.testing import faults

N_PARTS = 9


@pytest.fixture(autouse=True)
def _device_placement(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


def make_dataset(root, n_parts=N_PARTS, seed=0):
    """`n_parts` uneven Parquet partitions with NULLs in x."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths = []
    for i in range(n_parts):
        n = 300 + 131 * i
        x = rng.normal(3.0, 2.0, n)
        x[:: max(5, i + 3)] = np.nan
        t = pa.table({"x": pa.array(x, mask=np.isnan(x)), "g": pa.array(rng.integers(0, 40, n))})
        p = os.path.join(root, f"part-{i:03d}.parquet")
        pq.write_table(t, p, row_group_size=256)
        paths.append(p)
    return paths


def analyzer_suite():
    return [
        Mean("x"), Sum("x"), Minimum("x"), Maximum("x"), StandardDeviation("x"),
        Completeness("x"), ApproxCountDistinct("g"), ApproxQuantile("x", 0.5),
        Uniqueness(("g",)),  # grouping: rides the second gather
    ]


def metric_values(ctx):
    """Metric values by analyzer repr, floats as their exact hex."""
    out = {}
    for a, m in ctx.metric_map.items():
        if m.value.is_failure:
            out[repr(a)] = ("FAIL", type(m.value.exception).__name__)
        else:
            v = m.value.get()
            out[repr(a)] = v.hex() if isinstance(v, float) else v
    return out


def solo(src, analyzers, **kw):
    return AnalysisRunner.do_analysis_run(src, analyzers, "cpu", **kw)


class ThreadGather:
    """Barrier all-gather for N shards run as threads: each thread binds
    its rank, deposits its payload, waits for the round and reads every
    payload in rank order; rounds advance per thread, so the shareable
    and the grouping gathers both work."""

    def __init__(self, n):
        self.barrier = threading.Barrier(n)
        self.rounds = {}
        self.lock = threading.Lock()
        self.local = threading.local()

    def bind(self, rank):
        self.local.rank = rank
        self.local.round = 0

    def __call__(self, payload):
        r = self.local.round
        self.local.round += 1
        with self.lock:
            self.rounds.setdefault(r, {})[self.local.rank] = payload
        self.barrier.wait(timeout=120)
        out = [self.rounds[r][i] for i in sorted(self.rounds[r])]
        self.barrier.wait(timeout=120)
        return out


def run_threads(src, analyzers, shards, num_shards, controllers=None, **kw):
    """Run shard ids `shards` as threads over a barrier gather.
    -> (contexts, errors), by position in `shards`."""
    tg = ThreadGather(len(shards))
    out = [None] * len(shards)
    errs = [None] * len(shards)
    controllers = controllers or {}

    def work(pos, k):
        tg.bind(k)
        try:
            out[pos] = run_sharded_analysis(
                src, analyzers, shard=k, num_shards=num_shards, gather=tg,
                device="cpu", controller=controllers.get(k), **kw,
            )
        except BaseException as e:  # noqa: BLE001 - reported to the caller
            errs[pos] = e
            if not isinstance(e, RunCancelled):
                # a cancel raises after the exchange: the others are past
                # the barrier, which an abort could still break for them
                tg.barrier.abort()

    threads = [threading.Thread(target=work, args=(pos, k)) for pos, k in enumerate(shards)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
        assert not t.is_alive(), "sharded run deadlocked"
    return out, errs


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    paths = make_dataset(str(tmp_path_factory.mktemp("sharded")))
    src = PartitionedParquetSource(paths)
    return {"paths": paths, "solo": metric_values(solo(src, analyzer_suite()))}


@pytest.mark.parametrize("num_shards", [1, 2, 3, 4])
def test_every_shard_count_is_bit_identical(dataset, num_shards):
    src = PartitionedParquetSource(dataset["paths"])
    ctxs, errs = run_threads(src, analyzer_suite(), list(range(num_shards)), num_shards)
    assert errs == [None] * num_shards
    for ctx in ctxs:
        assert metric_values(ctx) == dataset["solo"]


def test_excluded_shard_is_bit_identical(dataset):
    src = PartitionedParquetSource(dataset["paths"])
    ctxs, errs = run_threads(src, analyzer_suite(), [0, 2], 3, exclude=(1,))
    assert errs == [None, None]
    for ctx in ctxs:
        assert metric_values(ctx) == dataset["solo"]


def test_fuzzed_datasets_and_shard_counts(tmp_path):
    rng = np.random.default_rng(42)
    for trial in range(2):
        src = PartitionedParquetSource(
            make_dataset(str(tmp_path / f"ds{trial}"), n_parts=6, seed=100 + trial)
        )
        analyzers = [Mean("x"), Sum("x"), StandardDeviation("x")]
        want = metric_values(solo(src, analyzers))
        num_shards = int(rng.integers(2, 5))
        ctxs, errs = run_threads(src, analyzers, list(range(num_shards)), num_shards)
        assert errs == [None] * num_shards
        for ctx in ctxs:
            assert metric_values(ctx) == want


def test_shard_counters(dataset):
    src = PartitionedParquetSource(dataset["paths"])
    with runtime.monitored() as stats:
        run_sharded_analysis(src, [Mean("x")], shard=0, num_shards=1, device="cpu")
    assert stats.shard_partitions_local == N_PARTS
    assert stats.shard_merge_bytes > 0
    assert stats.shard_rows_local == src.num_rows
    assert stats.partitions_scanned == N_PARTS


class TestStateCacheInterop:
    """Sharded and solo runs save partition states under the same
    (dataset, signature, fingerprint) keys: each resumes the other."""

    def test_sharded_saves_feed_a_solo_resume(self, dataset, tmp_path):
        src = PartitionedParquetSource(dataset["paths"])
        repo = FileSystemStateRepository(str(tmp_path / "cache"))
        analyzers = [Mean("x"), Minimum("x"), StandardDeviation("x")]
        ctxs, errs = run_threads(src, analyzers, [0, 1], 2, state_repository=repo, dataset_name="ds")
        assert errs == [None, None]
        with runtime.monitored() as stats:
            resumed = solo(src, analyzers, state_repository=repo, dataset_name="ds")
        assert metric_values(resumed) == metric_values(ctxs[0])
        assert (stats.partitions_cached, stats.partitions_scanned) == (N_PARTS, 0)

    def test_solo_saves_feed_a_sharded_resume(self, dataset, tmp_path, monkeypatch):
        src = PartitionedParquetSource(dataset["paths"])
        repo = FileSystemStateRepository(str(tmp_path / "cache"))
        analyzers = [Mean("x"), Maximum("x")]
        want = metric_values(solo(src, analyzers, state_repository=repo, dataset_name="ds"))
        calls = []
        orig = fused.scan_partition
        monkeypatch.setattr(fused, "scan_partition", lambda *a, **kw: calls.append(1) or orig(*a, **kw))
        ctxs, errs = run_threads(src, analyzers, [0, 1, 2], 3, state_repository=repo, dataset_name="ds")
        assert errs == [None] * 3
        for ctx in ctxs:
            assert metric_values(ctx) == want
        assert not calls  # resumed wholly from the solo run's states

    def test_mismatched_signatures_raise(self, dataset):
        src = PartitionedParquetSource(dataset["paths"])

        def gather(payload):
            other = encode_shard_states(1, "another-plan", [])
            return [payload, other]

        with pytest.raises(ValueError, match="plan-signature mismatch"):
            run_sharded_analysis(src, [Mean("x")], shard=0, num_shards=2, gather=gather, device="cpu")


class TestCancellationAndResume:
    def test_cancel_propagates_through_the_gather(self, dataset):
        src = PartitionedParquetSource(dataset["paths"])
        ctl = RunController()
        ctl.cancel_at_boundary("preempted")
        _ctxs, errs = run_threads(src, [Mean("x"), Sum("x")], [0, 1], 2, controllers={0: ctl})
        assert isinstance(errs[0], RunCancelled) and isinstance(errs[1], RunCancelled)
        assert errs[1].reason == "preempted" and errs[1].code == "DQ405"

    def test_mid_run_cancel_resumes_bit_identically(self, dataset, tmp_path):
        src = PartitionedParquetSource(dataset["paths"])
        repo = FileSystemStateRepository(str(tmp_path / "cache"))
        analyzers = [Mean("x"), StandardDeviation("x")]
        ctl = RunController()
        ctl.set_boundary_probe(
            lambda progress: "preempted" if progress.get("partitions_done", 0) >= 1 else None
        )
        _ctxs, errs = run_threads(
            src, analyzers, [0, 1], 2, controllers={1: ctl},
            state_repository=repo, dataset_name="ds",
        )
        assert all(isinstance(e, RunCancelled) for e in errs)
        ctxs, errs = run_threads(src, analyzers, [0, 1], 2, state_repository=repo, dataset_name="ds")
        assert errs == [None, None]
        want = metric_values(solo(src, analyzers))
        for ctx in ctxs:
            assert metric_values(ctx) == want

    def test_shared_cancel_token_stops_a_shard(self, dataset, tmp_path):
        token = SharedCancelToken(str(tmp_path / "cancel.token"))
        assert not token.tripped and token.reason() is None
        token.trip("drain")
        token.trip("quota")  # the first trip wins
        assert token.tripped and token.reason() == "drain"
        with pytest.raises(RunCancelled) as exc:
            run_sharded_analysis(
                PartitionedParquetSource(dataset["paths"]), [Mean("x")], shard=0, num_shards=1,
                controller=RunController(), cancel_token=token, device="cpu",
            )
        assert exc.value.reason == "drain" and exc.value.code == "DQ407"

    def test_a_cancelled_shard_trips_the_token_for_the_others(self, dataset, tmp_path):
        token = SharedCancelToken(str(tmp_path / "cancel.token"))
        ctl = RunController()
        ctl.cancel("cancelled")
        with pytest.raises(RunCancelled):
            run_sharded_analysis(
                PartitionedParquetSource(dataset["paths"]), [Mean("x")], shard=0, num_shards=1,
                controller=ctl, cancel_token=token, device="cpu",
            )
        assert token.reason() == "cancelled"

    def test_soft_cancel_passes_batch_checks(self):
        ctl = RunController()
        ctl.cancel_at_boundary("quota")
        ctl.check("batch")  # a batch check lets a soft cancel through
        assert ctl.soft_cancelled and not ctl.cancelled
        with pytest.raises(RunCancelled) as exc:
            ctl.check("partition", boundary=True)
        assert exc.value.code == "DQ406"


class TestRecovery:
    """A lost shard envelope or a corrupt partition entry (injected
    through the gather) recovers from saved states or a local rescan and
    lands on the solo bits, with a DQ320 warning."""

    def _populate(self, dataset, tmp_path, analyzers):
        src = PartitionedParquetSource(dataset["paths"])
        repo = FileSystemStateRepository(str(tmp_path / "cache"))
        ctxs, errs = run_threads(src, analyzers, [0, 1], 2, state_repository=repo, dataset_name="ds")
        assert errs == [None, None]
        return src, repo, metric_values(ctxs[0])

    def test_host_loss_recovers_from_saved_states(self, dataset, tmp_path):
        analyzers = [Mean("x"), Sum("x"), Minimum("x")]
        src, repo, want = self._populate(dataset, tmp_path, analyzers)
        with runtime.monitored() as stats, warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ctx = run_sharded_analysis(
                src, analyzers, shard=0, num_shards=1, gather=lambda p: [b""],
                state_repository=repo, dataset_name="ds", device="cpu",
            )
        assert metric_values(ctx) == want
        assert any("DQ320" in str(w.message) for w in caught)
        assert stats.partitions_scanned == 0  # all from the repository

    def test_host_loss_without_a_repository_rescans(self, dataset):
        src = PartitionedParquetSource(dataset["paths"])
        analyzers = [Mean("x"), Maximum("x"), ApproxQuantile("x", 0.5)]
        want = metric_values(solo(src, analyzers))

        def lose_the_other(payload):
            return [payload, b""]

        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            ctx = run_sharded_analysis(
                src, analyzers, shard=0, num_shards=2, gather=lose_the_other, device="cpu"
            )
        assert metric_values(ctx) == want

    def test_corrupt_entry_recovers(self, dataset, tmp_path):
        analyzers = [Mean("x"), StandardDeviation("x")]
        src, repo, want = self._populate(dataset, tmp_path, analyzers)

        def truncate_one_entry(payload):
            env = decode_shard_states(payload)
            fp, blob = env.entries[0]
            entries = [(fp, blob[:-1])] + env.entries[1:]
            return [encode_shard_states(env.shard, env.signature, entries)]

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            ctx = run_sharded_analysis(
                src, analyzers, shard=0, num_shards=1, gather=truncate_one_entry,
                state_repository=repo, dataset_name="ds", device="cpu",
            )
        assert metric_values(ctx) == want
        assert any("DQ320" in str(w.message) and "partition" in str(w.message) for w in caught)


class TestChaosRecovery:
    """The chaos points: a lost shard envelope or a corrupt partition
    entry recovers from committed states (or a local rescan) and
    converges bit-identically — DQ320 warns, nothing silently drops.
    Port-mapped from tests/test_sharded_scan.py's TestChaosRecovery."""

    def _populate(self, dataset, tmp_path, analyzers):
        src = PartitionedParquetSource(dataset["paths"])
        repo = FileSystemStateRepository(str(tmp_path / "cache"))
        ctxs, errs = run_threads(src, analyzers, [0, 1], 2, state_repository=repo, dataset_name="ds")
        assert errs == [None, None]
        return src, repo, metric_values(ctxs[0])

    def test_host_loss_recovers_from_committed_states(self, dataset, tmp_path):
        analyzers = [Mean("x"), Sum("x"), Minimum("x")]
        src, repo, expected = self._populate(dataset, tmp_path, analyzers)
        with faults.install("shard.host_loss:1:1"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ctx = run_sharded_analysis(
                    src, analyzers, shard=0, num_shards=1,
                    state_repository=repo, dataset_name="ds", device="cpu",
                )
        assert metric_values(ctx) == expected
        assert any("DQ320" in str(w.message) for w in caught)

    def test_host_loss_without_cache_rescans(self, dataset):
        # no repository: the lost envelope's partitions rescan locally —
        # slower, never wrong
        src = PartitionedParquetSource(dataset["paths"])
        analyzers = [Mean("x"), Maximum("x")]
        want = metric_values(solo(src, analyzers))
        with faults.install("shard.host_loss:1:1"):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                ctx = run_sharded_analysis(src, analyzers, shard=0, num_shards=1, device="cpu")
        assert metric_values(ctx) == want

    def test_corrupt_merge_entry_recovers(self, dataset, tmp_path):
        analyzers = [Mean("x"), StandardDeviation("x")]
        src, repo, expected = self._populate(dataset, tmp_path, analyzers)
        with faults.install("shard.merge:1:1"):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                ctx = run_sharded_analysis(
                    src, analyzers, shard=0, num_shards=1,
                    state_repository=repo, dataset_name="ds", device="cpu",
                )
        assert metric_values(ctx) == expected
        assert any("DQ320" in str(w.message) for w in caught)

    def test_two_shard_mesh_survives_host_loss_fault(self, dataset, tmp_path):
        # the fault fires inside a live 2-shard mesh (budget 1: one
        # shard drops its neighbour's envelope post-gather); both still
        # converge on solo
        analyzers = [Mean("x"), Sum("x")]
        src, repo, expected = self._populate(dataset, tmp_path, analyzers)
        with faults.install("shard.host_loss:1:1"):
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                ctxs, errs = run_threads(
                    src, analyzers, [0, 1], 2, state_repository=repo, dataset_name="ds",
                )
        assert errs == [None, None]
        for ctx in ctxs:
            assert metric_values(ctx) == expected

    def test_shard_assign_fault_raises_before_any_scan(self, dataset):
        """`shard.assign` is raise-kind with no containment: the planner
        fails before a partition is read, as the reference's does."""
        from deequ_tpu_torch.testing.faults import InjectedFaultError

        src = PartitionedParquetSource(dataset["paths"])
        with runtime.monitored() as stats, faults.install("shard.assign:1:1") as plan:
            with pytest.raises(InjectedFaultError):
                run_sharded_analysis(src, [Mean("x")], shard=0, num_shards=1, device="cpu")
        assert plan.injected == {"shard.assign": 1}
        assert stats.partitions_scanned == 0


class TestShardEnvelope:
    @pytest.mark.parametrize("cancelled,reason", [(False, ""), (True, "preempted"), (True, "ünï")])
    def test_round_trip_and_bytes_equal_jax(self, cancelled, reason):
        entries = [("fp-a", b"blob-a"), ("fp-ß", b"blob-b" * 100), ("", b"")]
        blob = encode_shard_states(3, "sig123", entries, cancelled=cancelled, reason=reason)
        assert blob == jstates.encode_shard_states(
            3, "sig123", entries, cancelled=cancelled, reason=reason
        )
        env = decode_shard_states(blob)
        assert (env.shard, env.signature, env.cancelled, env.reason) == (3, "sig123", cancelled, reason)
        assert env.entries == entries
        jenv = jstates.decode_shard_states(blob)
        assert jenv.entries == env.entries

    def test_real_envelope_equals_jax(self, dataset):
        """A shard's envelope over real partition states equals the one
        the JAX package encodes from the same entries."""
        src = PartitionedParquetSource(dataset["paths"])
        captured = []

        def capture(payload):
            captured.append(payload)
            return [payload]

        run_sharded_analysis(src, [Mean("x"), Maximum("x")], shard=0, num_shards=1, gather=capture, device="cpu")
        env = decode_shard_states(captured[0])
        assert len(env.entries) == N_PARTS
        assert captured[0] == jstates.encode_shard_states(env.shard, env.signature, env.entries)

    @pytest.mark.parametrize(
        "mutate",
        [
            lambda b: b[:-1],
            lambda b: b"XXXX" + b[4:],
            lambda b: b[:10] + bytes([b[10] ^ 0xFF]) + b[11:],
            lambda b: b"",
            lambda b: b + b"\x00",
        ],
        ids=["truncated", "magic", "bit-flip", "empty", "trailing"],
    )
    def test_any_defect_is_a_decode_error(self, mutate):
        blob = encode_shard_states(0, "sig", [("fp", b"x" * 32)])
        with pytest.raises(StateDecodeError):
            decode_shard_states(mutate(blob))


class TestSourceSubset:
    def test_subset_keeps_order_and_validates(self, dataset):
        src = PartitionedParquetSource(dataset["paths"])
        sub = src.subset([dataset["paths"][4], dataset["paths"][1]])
        assert [p.name for p in sub.partitions()] == ["part-001.parquet", "part-004.parquet"]
        assert sub.batch_rows == src.batch_rows and sub.columns == src.columns
        with pytest.raises(ValueError, match="not in this dataset"):
            src.subset(["/nope.parquet"])
        with pytest.raises(ValueError, match="no partitions"):
            src.subset([])
