"""Decode fast path observability: the decode counters, the telemetry
derivations, the sentinel's watch list, and the decode plan of the mesh
pass.

Port-mapped from tests/test_decode_fastpath.py's TestObservability: the
same cases against deequ_tpu_torch, every run on the CPU
(tests/torch_cpu.py), with `DEEQU_TPU_DECODE_WORKERS=1` pinned where
the telemetry reads the worker count, and the mesh over eight CPU
shards (`data_mesh(["cpu"] * 8)`, the JAX tests' eight virtual
devices).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu_torch.data.source import ParquetSource

pytestmark = pytest.mark.usefixtures("cpu_default")


class TestObservability:
    def test_telemetry_derivations_and_sentinel_watch(self, tmp_path, monkeypatch):
        # the port decodes on one thread; the JAX package's default is
        # min(cores, 4) workers, so its copy of this case pins the knob
        monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", "1")
        from deequ_tpu_torch.analyzers import Completeness, Mean
        from deequ_tpu_torch.observe.runtrace import traced_run
        from deequ_tpu_torch.observe.telemetry import engine_metric_record
        from deequ_tpu_torch.runners import AnalysisRunner

        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
        t = pa.table(
            {
                "i": pa.array(np.arange(500), type=pa.int64()),
                "ts": pa.array([np.datetime64("2024-01-01", "us")] * 500),
            }
        )
        path = str(tmp_path / "m.parquet")
        pq.write_table(t, path)
        with traced_run("t", enable=True) as handle:
            AnalysisRunner().on_data(ParquetSource(path)).add_analyzers(
                [Mean("i"), Completeness("ts")]
            ).run()
        rec = engine_metric_record(handle.trace)
        assert rec["engine.decode_fastpath_ratio"] == 0.5
        assert rec["engine.decode_workers"] == 1.0

        import importlib.util
        import os

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            "sentinel", os.path.join(repo, "tools", "torch_sentinel.py")
        )
        sentinel = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(sentinel)
        watched = dict(sentinel.WATCHED_SERIES)
        assert watched.get("engine.decode_fastpath_ratio") == "down"
        assert watched.get("engine.decode_workers") == "down"

    def test_decode_fastpath_span_attrs(self, tmp_path, monkeypatch):
        from deequ_tpu_torch import observe
        from deequ_tpu_torch.analyzers import Mean
        from deequ_tpu_torch.runners import AnalysisRunner

        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
        t = pa.table({"i": pa.array(np.arange(300), type=pa.int64())})
        path = str(tmp_path / "sp.parquet")
        pq.write_table(t, path)
        with observe.tracing() as tracer:
            AnalysisRunner().on_data(ParquetSource(path)).add_analyzers(
                [Mean("i")]
            ).run()

        def spans(root):
            stack = [root]
            while stack:
                sp = stack.pop()
                yield sp
                stack.extend(sp.children)

        plan_spans = [
            sp
            for root in tracer.roots
            for sp in spans(root)
            if sp.name == "decode_fastpath"
        ]
        assert plan_spans
        attrs = plan_spans[0].attrs
        assert attrs["cols_total"] == 1
        assert attrs["cols_fast"] == 1
        assert attrs["cols_fallback"] == 0
        assert attrs["workers"] >= 1

    def test_distributed_scan_uses_fastpath(self, tmp_path, monkeypatch):
        """DistributedScanPass plans decode routing like FusedScanPass:
        the mesh shards packed wire arrays, so the fast path must engage
        (and stay bit-identical) on the multi-device route too."""
        from deequ_tpu_torch import observe
        from deequ_tpu_torch.analyzers import Completeness, Mean
        from deequ_tpu_torch.parallel import DistributedScanPass, data_mesh

        t = pa.table(
            {
                "x": pa.array(
                    [float(i) / 3 if i % 5 else None for i in range(4096)]
                ),
                "b": pa.array([bool(i % 2) for i in range(4096)]),
            }
        )
        path = str(tmp_path / "d.parquet")
        pq.write_table(t, path)
        analyzers = [Mean("x"), Completeness("b")]

        def run():
            with observe.tracing() as tracer:
                res = DistributedScanPass(analyzers, mesh=data_mesh(["cpu"] * 8)).run(
                    ParquetSource(path)
                )
            snap = [
                (
                    repr(r.analyzer),
                    r.analyzer.compute_metric_from(r.state_or_raise()).value.get(),
                )
                for r in res
            ]
            return snap, tracer

        on, tracer = run()
        monkeypatch.setenv("DEEQU_TPU_DECODE_FASTPATH", "0")
        off, _ = run()
        assert on == off

        def spans(root):
            stack = [root]
            while stack:
                sp = stack.pop()
                yield sp
                stack.extend(sp.children)

        plan_spans = [
            sp
            for root in tracer.roots
            for sp in spans(root)
            if sp.name == "decode_fastpath"
        ]
        assert plan_spans
        assert plan_spans[0].attrs["cols_fast"] == 2
