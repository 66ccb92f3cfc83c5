"""Trace-differential suite.

The static cost analyzer's predicted dispatch signature — counters,
execution-span histogram, deduplicated family-group set — must equal the
one extracted from a real run's `RunTrace`, as one dict equality:

    plan_cost.dispatch_signature() == observe.dispatch_signature(trace)

Every scenario pins the data-dependent knobs the model states as
assumptions: placement via DEEQU_TPU_PLACEMENT, the counts-family
shortcut off via DEEQU_TPU_NO_COUNTS_FASTPATH, tables small enough to
stay on the single engine, group cardinalities below the device
frequency-aggregation threshold.

Port-mapped from tests/test_trace_differential.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pytest

from deequ_tpu_torch import observe
from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Distinctness,
    Histogram,
    Maximum,
    Mean,
    Minimum,
    StandardDeviation,
    Sum,
    Uniqueness,
)
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.lint import SchemaInfo, analyze_plan
from deequ_tpu_torch.observe import dispatch_signature
from deequ_tpu_torch.ops.fused import FusedScanPass
from deequ_tpu_torch.runners import AnalysisRunner

pytestmark = pytest.mark.usefixtures("cpu_default")


@pytest.fixture(autouse=True)
def _pinned_execution(monkeypatch):
    """Pin every knob the cost model states as an assumption."""
    monkeypatch.setenv("DEEQU_TPU_NO_COUNTS_FASTPATH", "1")
    yield


def _table(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return Table.from_numpy(
        {
            "price": rng.random(n) * 100.0,
            "cost": rng.standard_normal(n),
            "qty": rng.integers(0, 50, n),
            "cat": rng.integers(0, 8, n),
        }
    )


def _run(table, analyzers):
    ctx = (
        AnalysisRunner.on_data(table)
        .add_analyzers(analyzers)
        .with_tracing(True)
        .run()
    )
    assert ctx.run_trace is not None
    assert ctx.plan_cost is not None, "runner did not attach a PlanCost"
    return ctx


class TestRunnerDifferential:
    def test_device_scan_matches_trace(self, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
        ctx = _run(
            _table(),
            [
                Mean("price"),
                StandardDeviation("price"),
                Minimum("cost"),
                Maximum("cost"),
                Completeness("qty"),
                Sum("qty"),
            ],
        )
        predicted = ctx.plan_cost.dispatch_signature()
        observed = dispatch_signature(ctx.run_trace)
        assert predicted == observed
        # the scenario actually dispatched: this is not a trivial match
        assert observed["counters"]["device_passes"] == 1
        assert observed["spans"]["dispatch"] >= 1

    def test_host_all_family_groups_match_trace(self, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
        ctx = _run(
            _table(),
            [
                ApproxQuantile("price", 0.5),
                ApproxQuantile("cost", 0.5),
                ApproxCountDistinct("price"),
                ApproxQuantile("qty", 0.9, where="qty > 10"),
                Mean("price"),
            ],
        )
        predicted = ctx.plan_cost.dispatch_signature()
        observed = dispatch_signature(ctx.run_trace)
        assert predicted == observed
        # the family-group set is non-trivial: a multi-column batched
        # traversal AND a where-filtered solo group
        groups = observed["family_groups"]
        assert groups, "no family kernels dispatched"
        assert any(batched for (_, _, _, _, batched) in groups)
        assert any(w != "where:<all>" for (w, _, _, _, _) in groups)

    def test_grouping_sets_match_trace(self, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
        ctx = _run(
            _table(),
            [
                Uniqueness(["cat"]),
                Distinctness(["cat"]),
                Uniqueness(["cat", "qty"]),
            ],
        )
        predicted = ctx.plan_cost.dispatch_signature()
        observed = dispatch_signature(ctx.run_trace)
        assert predicted == observed
        # two distinct grouping column sets -> two frequency passes
        assert observed["spans"]["grouping"] == 2
        assert observed["counters"]["group_passes"] == 2

    def test_mixed_plan_matches_trace(self, monkeypatch):
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
        ctx = _run(
            _table(),
            [
                Mean("price"),
                StandardDeviation("price"),
                Histogram("cat"),
                Uniqueness(["cat"]),
                Distinctness(["qty"]),
            ],
        )
        predicted = ctx.plan_cost.dispatch_signature()
        observed = dispatch_signature(ctx.run_trace)
        assert predicted == observed
        # scan + aux (Histogram) + two grouping sets all present
        assert observed["counters"]["group_passes"] == 3
        assert observed["spans"]["fused_scan"] == 1


class TestMultiBatchDifferential:
    def test_batched_scan_spans_and_exact_wire_bytes(self, monkeypatch):
        """5 batches of 1024 rows through the fused pass directly: the
        span histogram matches AND the per-dispatch wire bytes equal the
        model's `pack_batch_inputs` replay, byte for byte."""
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
        n, batch = 5120, 1024
        table = _table(n)
        analyzers = [
            Mean("price"),
            StandardDeviation("price"),
            Minimum("cost"),
            Completeness("qty"),
        ]
        cost = analyze_plan(
            analyzers,
            SchemaInfo.from_table(table),
            num_rows=n,
            batch_size=batch,
            placement="device",
        )
        scan = cost.scan_pass
        assert scan.n_batches == 5
        assert scan.wire_bytes_per_batch is not None

        with observe.traced_run("scan", enable=True) as handle:
            results = FusedScanPass(analyzers, batch_size=batch).run(table)
        assert all(r.error is None for r in results)
        trace = handle.trace
        assert trace is not None

        assert cost.dispatch_signature() == dispatch_signature(trace)
        dispatches = [s for s in trace.spans() if s.name == "dispatch"]
        assert len(dispatches) == 5
        for sp in dispatches:
            assert sp.attrs.get("wire_bytes") == scan.wire_bytes_per_batch

    def test_prednn_mask_elision_is_predicted(self, monkeypatch):
        """A predicate over a non-nullable column ships NO prednn mask:
        the typechecker proves it all-true and the wire replay must
        account for the elision to stay byte-exact."""
        monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")
        n, batch = 2048, 1024
        table = _table(n)
        analyzers = [Mean("price", where="qty > 25"), Minimum("price")]
        cost = analyze_plan(
            analyzers,
            SchemaInfo.from_table(table),
            num_rows=n,
            batch_size=batch,
            placement="device",
        )
        scan = cost.scan_pass
        assert scan.wire_bytes_per_batch is not None

        with observe.traced_run("scan", enable=True) as handle:
            results = FusedScanPass(analyzers, batch_size=batch).run(table)
        assert all(r.error is None for r in results)
        trace = handle.trace

        assert cost.dispatch_signature() == dispatch_signature(trace)
        for sp in trace.spans():
            if sp.name == "dispatch":
                assert sp.attrs.get("wire_bytes") == scan.wire_bytes_per_batch
