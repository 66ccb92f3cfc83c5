"""The chaos differential on the port: injected faults change nothing.

Port-mapped from the chaos cases of tests/test_suite_differential_fuzz.py
(`CHAOS_MATRIX`, `test_chaos_faults_bit_identical_both_placements`): a
seeded fault plan injecting IO errors, short reads, corrupt pages,
decode failures, stage faults and stalls into a streamed scan must give
exactly the clean run's snapshot on both placements. Every containment
path (retry, in-place redo, pyarrow fallback) degrades to the same bits.

The matrix is the reference's, `seed=105,decode.worker:1.0:1` included:
as in the reference, every run takes two decode workers, so that the
worker the spec kills exists on any box. Every run is on the CPU; the
checks are the reference fuzzer's, bound to the port's Check DSL
(`port_random_check`).
"""

from __future__ import annotations

import numpy as np
import pytest

import test_suite_differential_fuzz as fuzz
from deequ_tpu_torch.data.table import Table as PTable
from deequ_tpu_torch.observe import spans
from deequ_tpu_torch.testing import faults
from deequ_tpu_torch.verification.suite import VerificationSuite as PSuite
from torch_stream_helpers import assert_metric_equal, bits, port_random_check

#: the reference's CHAOS_MATRIX
CHAOS_MATRIX = list(fuzz.CHAOS_MATRIX)


def test_matrix_is_the_reference_less_the_decode_worker():
    """The matrix is the reference's whole, its decode.worker spec too
    (the name is kept from when the port had no worker to kill)."""
    assert CHAOS_MATRIX == fuzz.CHAOS_MATRIX and len(CHAOS_MATRIX) == 8
    assert "seed=105,decode.worker:1.0:1" in CHAOS_MATRIX


@pytest.fixture(scope="module")
def chaos_file(tmp_path_factory):
    """The reference case's table and checks (seed 23,000), written as it
    writes them."""
    rng = np.random.default_rng(23_000)
    table = fuzz.random_table(rng)
    checks = [port_random_check(fuzz)(rng) for _ in range(2)]
    path = str(tmp_path_factory.mktemp("chaos") / "chaos.parquet")
    table.to_parquet(path, row_group_size=max(64, table.num_rows // 7), dictionary_encode_strings=True)
    return path, table.num_rows, checks


def _run(chaos_file, monkeypatch, placement, tracing=False):
    path, rows, checks = chaos_file
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    monkeypatch.setenv("DEEQU_TPU_PIPELINE", "1")
    monkeypatch.setenv("DEEQU_TPU_RETRY_BASE_MS", "0.1")
    # the worker pool needs more than one worker, on a one-core box too
    monkeypatch.setenv("DEEQU_TPU_DECODE_WORKERS", "2")
    builder = PSuite.on_data(PTable.scan_parquet(path, batch_rows=max(64, rows // 5)), device="cpu")
    for check in checks:
        builder = builder.add_check(check)
    if tracing:
        builder = builder.with_tracing(True)
    return builder.with_engine("single").run()


@pytest.mark.parametrize("spec", CHAOS_MATRIX)
@pytest.mark.parametrize("placement", ["host", "device"])
def test_chaos_faults_bit_identical_both_placements(spec, placement, chaos_file, monkeypatch):
    clean = bits(fuzz.suite_snapshot(_run(chaos_file, monkeypatch, placement)))
    with faults.install(spec) as plan:
        faulted = _run(chaos_file, monkeypatch, placement, tracing=True)
    assert sum(plan.injected.values()) >= 1, (
        f"spec {spec!r} never fired on {placement}: the matrix entry exercises nothing"
    )
    assert bits(fuzz.suite_snapshot(faulted)) == clean, (spec, placement, plan.injected)
    counters = faulted.run_trace.counters
    injected = sum(plan.injected.values())
    if spec.split(",")[-1].startswith(("read.pread", "read.short", "read.corrupt")):
        # every injected read fault is seen, and each retried one recovers
        assert counters.get("fault.observed", 0) == injected
        assert counters.get("retry.exhausted", 0) == 0
        if "read.corrupt" not in spec:
            assert counters.get("retry.attempts", 0) == injected
    elif "pipeline.stage" in spec or "decode.worker" in spec:
        # a failed stage item or a dead decode worker: one redo in place
        assert counters.get("fault.observed", 0) == injected == 1
        assert (counters.get("retry.attempts", 0), counters.get("retry.recovered", 0)) == (1, 1)
    else:
        # decode refusals and stalls are not IO faults: nothing retries
        assert counters.get("retry.attempts", 0) == 0


def test_an_exhausted_budget_reads_every_chunk_through_pyarrow(chaos_file, monkeypatch):
    """`read.pread:1.0` with no count: every pread fails on every attempt,
    so each chunk spends its budget and its column reads through pyarrow;
    the results do not move."""
    monkeypatch.setenv("DEEQU_TPU_RETRIES", "2")
    clean = bits(fuzz.suite_snapshot(_run(chaos_file, monkeypatch, "device")))
    with faults.install("seed=9,read.pread:1.0") as plan:
        faulted = _run(chaos_file, monkeypatch, "device", tracing=True)
    assert bits(fuzz.suite_snapshot(faulted)) == clean
    counters = faulted.run_trace.counters
    chunks = counters["retry.exhausted"]
    assert chunks >= 1
    assert plan.injected["read.pread"] == 3 * chunks
    assert counters["retry.attempts"] == 2 * chunks
    assert counters["fault.observed"] == plan.injected["read.pread"]
    assert counters.get("retry.recovered", 0) == 0


def test_a_fetch_that_raises_degrades_its_unit(chaos_file, monkeypatch):
    """A read that fails with an error no retry covers degrades its whole
    decode unit to pyarrow, counted as a fallback unit; the scan goes on
    and the results do not move."""
    from deequ_tpu_torch.data import native_reader

    clean = bits(fuzz.suite_snapshot(_run(chaos_file, monkeypatch, "device")))
    real = native_reader.fetch_chunk
    calls = {"n": 0}

    def broken(fd, meta):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("not an IO error")
        return real(fd, meta)

    monkeypatch.setattr(native_reader, "fetch_chunk", broken)
    faulted = _run(chaos_file, monkeypatch, "device", tracing=True)
    assert bits(fuzz.suite_snapshot(faulted)) == clean
    assert faulted.run_trace.counters["fault.fallback_units"] == 1


@pytest.mark.parametrize("spec", CHAOS_MATRIX)
def test_faulted_port_run_equals_the_jax_clean_run(spec, chaos_file, monkeypatch):
    """The faulted port run against the JAX package's clean run of the
    same file and checks (its plain pyarrow route, the
    device placement): float sums within 1e-12 relative, the rest exact
    (ROADMAP section 3)."""
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.verification import VerificationSuite as JSuite
    from torch_stream_helpers import plain_route

    path, rows, _checks = chaos_file
    rng = np.random.default_rng(23_000)
    fuzz.random_table(rng)
    jchecks = [fuzz.random_check(rng) for _ in range(2)]
    with monkeypatch.context() as jm:
        plain_route(jm)
        jbuilder = JSuite().on_data(JTable.scan_parquet(path, batch_rows=max(64, rows // 5)))
        for check in jchecks:
            jbuilder = jbuilder.add_check(check)
        jresult = jbuilder.with_engine("single").run()
    with faults.install(spec) as plan:
        presult = _run(chaos_file, monkeypatch, "device")
    assert sum(plan.injected.values()) >= 1
    assert presult.status.name == jresult.status.name
    jstatus = {c.description: r.status.name for c, r in jresult.check_results.items()}
    assert {c.description: r.status.name for c, r in presult.check_results.items()} == jstatus
    jmetrics = {repr(a): m for a, m in jresult.metrics.items()}
    pmetrics = {repr(a): m for a, m in presult.metrics.items()}
    assert pmetrics.keys() == jmetrics.keys()
    for key, jm in jmetrics.items():
        assert_metric_equal(jm, pmetrics[key], key)


def test_the_disabled_harness_has_no_plan():
    assert faults.active_plan() is None
    assert spans.current_tracer() is None
