"""Overhead guard for the observability subsystem.

The disabled-tracing path must cost <2% wall overhead vs a
no-instrumentation baseline. A raw A/B wall-clock comparison of two
full engine runs is hopelessly noisy on shared-vCPU CI boxes, so the
guard bounds the overhead analytically and deterministically:

    instrumented_cost ≈ probes_per_run × cost_per_disabled_probe

`probes_per_run` is the exact number of spans a traced run of the same
workload records (an overcount-safe proxy is taken ×4 to cover
`annotate`/`current_*` probes that don't open spans), and
`cost_per_disabled_probe` is measured on the no-op fast path (a single
thread-local getattr returning the falsy singleton). The product must
stay under 2% of the measured disabled-run wall time.

A differential companion (test_observe.py::TestTracingIsInert) pins the
other half of the contract: tracing never changes metric values.

Port-mapped from tests/test_observe_overhead.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py). The two chaos cases
(`test_disabled_chaos_and_controller_overhead_under_two_percent`,
`test_disarmed_fault_point_is_cheap`) read the fault-injection harness
(`testing/faults.py`), which the port does not have yet.
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import time

import numpy as np

from deequ_tpu_torch import observe
from deequ_tpu_torch.data.table import Table
import pytest

pytestmark = pytest.mark.usefixtures("cpu_default")


def _medium_table(n=400_000, seed=3):
    rng = np.random.default_rng(seed)
    return Table.from_numpy(
        {
            "x": rng.standard_normal(n),
            "y": rng.lognormal(1.0, 0.5, n),
            "z": rng.integers(0, 1_000_000, n).astype(np.float64),
            "flag": rng.random(n) < 0.5,
        }
    )


def _run(table):
    from deequ_tpu_torch.analyzers import (
        Completeness,
        Maximum,
        Mean,
        Minimum,
        StandardDeviation,
    )
    from deequ_tpu_torch.runners import AnalysisRunner

    analyzers = []
    for col in ("x", "y", "z"):
        analyzers += [Mean(col), StandardDeviation(col), Minimum(col), Maximum(col)]
    analyzers.append(Completeness("x"))
    return AnalysisRunner.on_data(table).add_analyzers(analyzers).run()


def _noop_probe_cost(calls=200_000):
    """Seconds per disabled `span()` call, best of 3 batches."""
    span = observe.span
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            span("probe", cat="dispatch", rows=1)
        best = min(best, time.perf_counter() - t0)
    return best / calls


def test_disabled_tracing_overhead_under_two_percent():
    table = _medium_table()
    _run(table)  # warm up: compile every (analyzer-set, shape) program

    # disabled-run wall time, best-of-3 (tracing off: no tracer installed)
    assert observe.current_tracer() is None
    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        _run(table)
        wall = min(wall, time.perf_counter() - t0)

    # exact probe count for this workload, from one traced run
    traced = _run_traced(table)
    n_spans = sum(1 for _ in traced.run_trace.spans())
    probes = n_spans * 4  # headroom for annotate()/current_*() probes

    per_call = _noop_probe_cost()
    overhead = probes * per_call
    assert overhead < 0.02 * wall, (
        f"disabled-path overhead bound {overhead * 1e6:.1f}µs "
        f"({probes} probes × {per_call * 1e9:.0f}ns) exceeds 2% of "
        f"{wall * 1e3:.1f}ms run wall time"
    )


def _run_traced(table):
    from deequ_tpu_torch.analyzers import (
        Completeness,
        Maximum,
        Mean,
        Minimum,
        StandardDeviation,
    )
    from deequ_tpu_torch.runners import AnalysisRunner

    analyzers = []
    for col in ("x", "y", "z"):
        analyzers += [Mean(col), StandardDeviation(col), Minimum(col), Maximum(col)]
    analyzers.append(Completeness("x"))
    return (
        AnalysisRunner.on_data(table)
        .add_analyzers(analyzers)
        .with_tracing(True)
        .run()
    )


def test_noop_span_is_cheap():
    """The disabled probe itself must stay in the tens-of-nanoseconds to
    low-microsecond class — a getattr plus a singleton return."""
    assert _noop_probe_cost(calls=100_000) < 5e-6


# -- forensics disabled path --------------------------------------


def _verify(table, forensics=False):
    from deequ_tpu_torch.checks.check import Check, CheckLevel
    from deequ_tpu_torch.verification.suite import VerificationSuite

    check = (
        Check(CheckLevel.ERROR, "overhead")
        .is_complete("x")
        .has_min("y", lambda v: v > 0.0)
        .satisfies("z >= 0", "z nonneg", lambda r: r >= 1.0)
    )
    builder = VerificationSuite.on_data(table).add_check(check)
    if forensics:
        builder = builder.with_forensics()
    return builder.run()


def _attr_probe_cost(calls=200_000):
    """Seconds per `x is not None` attribute probe — the entire per-batch
    cost of the disabled forensics path in the fused scan."""

    class Holder:
        __slots__ = ("f",)

        def __init__(self):
            self.f = None

    holder = Holder()
    sink = 0
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(calls):
            if holder.f is not None:
                sink += 1
        best = min(best, time.perf_counter() - t0)
    assert sink == 0
    return best / calls


def test_disabled_forensics_overhead_under_three_percent():
    """Forensics off (the default) must cost <3% of verification wall.
    The off path in the fused scan is exactly one `self._forensics is
    not None` attribute probe per decoded batch plus two per plan and
    one env read per run — bounded analytically like the tracing guard
    above: the batch count is taken from a traced run of the same
    workload (host_fold spans, one per batch), ×16 headroom to cover
    the plan-time probes, the env read and any future probe sites."""
    table = _medium_table()
    result = _verify(table)  # warm up compile caches
    assert result.forensics() is None  # off by default

    wall = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        result = _verify(table)
        wall = min(wall, time.perf_counter() - t0)
    assert result.forensics() is None

    with observe.tracing() as tracer:
        _verify(table)
    n_batches = sum(
        1
        for root in tracer.roots
        for sp in _spans(root)
        if sp.name == "host_fold"
    )
    probes = max(1, n_batches) * 16

    overhead = probes * _attr_probe_cost()
    assert overhead < 0.03 * wall, (
        f"disabled-forensics overhead bound {overhead * 1e6:.1f}µs "
        f"({probes} probes) exceeds 3% of {wall * 1e3:.1f}ms "
        "verification wall time"
    )


def _spans(root):
    stack = [root]
    while stack:
        sp = stack.pop()
        yield sp
        stack.extend(sp.children)
