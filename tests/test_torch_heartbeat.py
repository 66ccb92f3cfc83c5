"""Live scan heartbeat.

A streamed scan with `DEEQU_TPU_HEARTBEAT_S` set must emit periodic
progress snapshots — completed/predicted batches, instantaneous rows/s,
the pipeline bottleneck, a converging ETA — plus one final `done`
snapshot, via registered callbacks and/or a JSONL sink. The disabled
path must never construct a `ScanProgress`, never spawn the timer
thread, stay within the repo's <2% overhead budget (bounded
analytically, like test_observe_overhead.py), and produce bit-identical
metrics (differential test).

Port-mapped from tests/test_heartbeat.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py). As the reference does, the
scans that must outlive a few beats stall each row-group read by 10 ms
through `DEEQU_TPU_SOURCE_STALL_MS` (the model of a remote store's
latency).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import json
import threading
import time

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu_torch.analyzers import Completeness, Mean, Size, StandardDeviation
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.observe import heartbeat
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

pytestmark = pytest.mark.usefixtures("cpu_default")

N_ROWS = 100_000
BATCH_ROWS = 10_000
N_BATCHES = N_ROWS // BATCH_ROWS

ANALYZERS = [Size(), Completeness("x"), Mean("x"), StandardDeviation("x")]


@pytest.fixture(scope="module")
def parquet_path(tmp_path_factory):
    rng = np.random.default_rng(11)
    x = rng.normal(3.0, 1.5, N_ROWS)
    x[rng.random(N_ROWS) < 0.02] = np.nan
    table = pa.table({"x": x, "qty": rng.integers(0, 99, N_ROWS)})
    path = str(tmp_path_factory.mktemp("hb") / "data.parquet")
    pq.write_table(table, path, row_group_size=BATCH_ROWS)
    return path


def _scan(path):
    source = Table.scan_parquet(path, batch_rows=BATCH_ROWS)
    return AnalysisRunner.on_data(source).add_analyzers(ANALYZERS).run()


class TestHeartbeatOnStreamedScan:
    def test_emits_converging_snapshots(self, parquet_path, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_HEARTBEAT_S", "0.02")
        # stall decode 10ms/row-group so the scan outlives a few beats
        monkeypatch.setenv("DEEQU_TPU_SOURCE_STALL_MS", "10")
        monkeypatch.setenv("DEEQU_TPU_PIPELINE", "1")
        snaps = []
        cb = snaps.append
        heartbeat.register_callback(cb)
        try:
            _scan(parquet_path)
        finally:
            heartbeat.unregister_callback(cb)

        assert len(snaps) >= 2, "expected periodic + final snapshots"
        assert any(not s["done"] for s in snaps), "no periodic snapshot fired"
        final = snaps[-1]
        assert final["done"] is True
        assert final["name"] == "fused_scan"
        assert final["rows"] == N_ROWS
        assert final["batches"] == N_BATCHES
        assert final["predicted_batches"] == N_BATCHES
        assert final["total_rows"] == N_ROWS
        assert final["progress"] == 1.0
        assert final["eta_s"] == 0
        assert final["avg_rows_per_s"] > 0

        # ETA converges: once estimable it must end at (or below) where
        # it started, terminating in the final 0
        etas = [s["eta_s"] for s in snaps if "eta_s" in s]
        assert etas, "no snapshot carried an ETA"
        assert etas[-1] <= etas[0] + 1e-9
        assert etas[-1] == 0

        # pipelined scan attributes stage busy-time: the bottleneck is
        # one of the stream stages (decode stalled -> likely decode);
        # "read" is the native reader's fetch-slot bucket
        assert final.get("bottleneck") in {"read", "decode", "prep", "fold"}
        assert set(final.get("occupancy", {})) <= {
            "read",
            "decode",
            "prep",
            "fold",
        }

    def test_jsonl_sink_from_env(self, parquet_path, tmp_path, monkeypatch):
        out = str(tmp_path / "beats.jsonl")
        monkeypatch.setenv("DEEQU_TPU_HEARTBEAT_S", "0.02")
        monkeypatch.setenv("DEEQU_TPU_HEARTBEAT_OUT", out)
        monkeypatch.setenv("DEEQU_TPU_SOURCE_STALL_MS", "10")
        _scan(parquet_path)
        with open(out, encoding="utf-8") as fh:
            lines = [json.loads(line) for line in fh if line.strip()]
        assert len(lines) >= 1
        assert lines[-1]["done"] is True
        assert lines[-1]["rows"] == N_ROWS
        for snap in lines:
            assert {"ts", "name", "rows", "batches", "wall_s"} <= set(snap)


class TestHeartbeatDisabledPath:
    def test_no_scanprogress_and_no_thread_when_off(self, parquet_path, monkeypatch):
        monkeypatch.delenv("DEEQU_TPU_HEARTBEAT_S", raising=False)
        constructed = []

        class _Boom(heartbeat.ScanProgress):
            def __init__(self, *a, **k):
                constructed.append(1)
                super().__init__(*a, **k)

        monkeypatch.setattr(heartbeat, "ScanProgress", _Boom)
        _scan(parquet_path)
        assert constructed == []
        assert not any(
            t.name == heartbeat.THREAD_NAME for t in threading.enumerate()
        )

    def test_disabled_metrics_bit_identical(self, parquet_path, tmp_path, monkeypatch):
        monkeypatch.delenv("DEEQU_TPU_HEARTBEAT_S", raising=False)
        baseline = _scan(parquet_path).success_metrics_as_rows()

        monkeypatch.setenv("DEEQU_TPU_HEARTBEAT_S", "0.01")
        monkeypatch.setenv("DEEQU_TPU_HEARTBEAT_OUT", str(tmp_path / "hb.jsonl"))
        with_hb = _scan(parquet_path).success_metrics_as_rows()

        assert baseline == with_hb  # exact equality, not approx

    def test_noop_overhead_under_two_percent(self, parquet_path, monkeypatch):
        """Analytic overhead bound, mirroring test_observe_overhead.py:
        probes_per_run x measured no-op probe cost < 2% of scan wall."""
        monkeypatch.delenv("DEEQU_TPU_HEARTBEAT_S", raising=False)
        monkeypatch.delenv("DEEQU_TPU_SOURCE_STALL_MS", raising=False)
        _scan(parquet_path)  # warm up compiles

        wall = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            _scan(parquet_path)
            wall = min(wall, time.perf_counter() - t0)

        noop = heartbeat.NOOP_PROGRESS
        calls = 100_000
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for _ in range(calls):
                with noop.timed("stage"):
                    pass
                noop.advance(1)
            best = min(best, time.perf_counter() - t0)
        probe_cost = best / calls

        # per batch: decode + stage timers (pipeline stage thread), fold
        # timer + advance (consumer). x2 margin for start()/finish().
        probes_per_run = 8 * N_BATCHES
        overhead = probes_per_run * probe_cost
        assert overhead < 0.02 * wall, (
            f"no-op heartbeat overhead {overhead * 1e6:.1f}us exceeds 2% "
            f"of scan wall {wall * 1e3:.1f}ms"
        )


class TestHeartbeatUnit:
    def test_env_interval_parsing(self, monkeypatch):
        cases = [
            ("", 0.0), ("0", 0.0), ("off", 0.0), ("no", 0.0),
            ("false", 0.0), ("junk", 0.0), ("-3", 0.0), ("0.5", 0.5),
            (" 2 ", 2.0),
        ]
        for raw, expected in cases:
            monkeypatch.setenv(heartbeat.ENV_KNOB, raw)
            assert heartbeat.env_interval_s() == expected, raw
        monkeypatch.delenv(heartbeat.ENV_KNOB)
        assert heartbeat.env_interval_s() == 0.0

    def test_start_returns_falsy_noop_when_disabled(self, monkeypatch):
        monkeypatch.delenv(heartbeat.ENV_KNOB, raising=False)
        progress = heartbeat.start()
        assert progress is heartbeat.NOOP_PROGRESS
        assert not progress
        # every hook is inert and snapshot-free
        progress.advance(10)
        with progress.timed("x"):
            pass
        assert progress.snapshot() is None
        progress.finish()

    def test_periodic_jsonl_snapshots_with_eta(self, tmp_path):
        out = str(tmp_path / "unit.jsonl")
        progress = heartbeat.start(
            0.01, total_rows=1000, predicted_batches=4, out_path=out
        )
        assert isinstance(progress, heartbeat.ScanProgress)
        try:
            for _ in range(4):
                progress.advance(250)
                time.sleep(0.02)
        finally:
            progress.finish()
        with open(out, encoding="utf-8") as fh:
            snaps = [json.loads(line) for line in fh if line.strip()]
        assert len(snaps) >= 2
        assert snaps[-1]["done"] is True
        assert snaps[-1]["progress"] == 1.0
        assert snaps[-1]["eta_s"] == 0
        assert all(s["predicted_batches"] == 4 for s in snaps)
        # monotone non-decreasing row counts across emissions
        rows = [s["rows"] for s in snaps]
        assert rows == sorted(rows)

    def test_scan_heartbeat_contextmanager_and_registry(self):
        seen = []
        cb = seen.append
        heartbeat.register_callback(cb)
        heartbeat.register_callback(cb)  # idempotent
        try:
            with heartbeat.scan_heartbeat(5.0, total_rows=10, name="unit") as p:
                p.advance(10)
        finally:
            heartbeat.unregister_callback(cb)
        assert len(seen) == 1  # one final emit, delivered once
        assert seen[0]["done"] is True and seen[0]["name"] == "unit"

        with heartbeat.scan_heartbeat(5.0, total_rows=10) as p:
            p.advance(10)
        assert len(seen) == 1  # unregistered: no further deliveries

    def test_scan_heartbeat_disabled_yields_noop(self, monkeypatch):
        monkeypatch.delenv(heartbeat.ENV_KNOB, raising=False)
        with heartbeat.scan_heartbeat() as progress:
            assert progress is heartbeat.NOOP_PROGRESS

    def test_bottleneck_tracks_busiest_stage(self):
        progress = heartbeat.ScanProgress(1000.0, name="unit")
        with progress.timed("fold"):
            time.sleep(0.01)
        with progress.timed("decode"):
            time.sleep(0.03)
        snap = progress.snapshot()
        assert snap["bottleneck"] == "decode"
        assert snap["occupancy"]["decode"] >= snap["occupancy"]["fold"]
        progress.finish()

    def test_callback_exceptions_do_not_break_emission(self, tmp_path):
        out = str(tmp_path / "safe.jsonl")

        def bad(_snap):
            raise RuntimeError("consumer bug")

        progress = heartbeat.ScanProgress(1000.0, callback=bad, out_path=out)
        progress.advance(5)
        progress.finish()  # must not raise
        with open(out, encoding="utf-8") as fh:
            assert json.loads(fh.readline())["rows"] == 5


class TestReadaheadAttribution:
    """Read-ahead hits/misses fold into the
    heartbeat snapshot, and a miss-starved window renames the
    bottleneck to "read" (the blocked future waits otherwise hide
    inside the consumer stage's timer)."""

    def test_misses_promote_read_bottleneck(self):
        progress = heartbeat.ScanProgress(1000.0, name="unit")
        with progress.timed("fold"):
            time.sleep(0.01)
        for hit in (True, False, False):
            progress.note_readahead(hit)
        snap = progress.snapshot()
        assert snap["readahead"] == {"hits": 1, "misses": 2}
        assert snap["bottleneck"] == "read"
        progress.finish()

    def test_hits_keep_stage_bottleneck(self):
        progress = heartbeat.ScanProgress(1000.0, name="unit")
        with progress.timed("decode"):
            time.sleep(0.01)
        for hit in (True, True, False):
            progress.note_readahead(hit)
        snap = progress.snapshot()
        assert snap["readahead"] == {"hits": 2, "misses": 1}
        assert snap["bottleneck"] == "decode"
        progress.finish()

    def test_no_readahead_no_snapshot_key(self):
        progress = heartbeat.ScanProgress(1000.0, name="unit")
        assert "readahead" not in progress.snapshot()
        progress.finish()

    def test_noop_progress_accepts_note_readahead(self):
        heartbeat.NOOP_PROGRESS.note_readahead(True)  # must not raise
