"""Incremental runs of the port on the CPU over daily Parquet partitions,
and against the JAX package's incremental run over the same files.

A verification suite with a `FileSystemStateRepository` (the chip smoke
phase `incremental` at a small size): a cold fill scans every partition,
a rerun after one more day scans that day alone, and its metrics and
verdicts equal a rescan with the cache off bit for bit; a corrupt,
truncated or version-bumped envelope gives DQ314 and a rescan of that
partition alone; `merge_range` over the fingerprints equals the full run.

Against the JAX package (pinned as torch_stream_helpers.plain_route pins
it, single engine): counts, minima, maxima, HLL estimates, quantiles and
check statuses equal; sums, means, standard deviations and correlations
within 1e-12 relative (torch and XLA add in other orders), as the
profiler's parity tests hold them.
"""

from __future__ import annotations

import glob
import os
import struct
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu.checks import Check as JCheck
from deequ_tpu.checks import CheckLevel as JLevel
from deequ_tpu.data.table import Table as JTable
from deequ_tpu.repository.states import FileSystemStateRepository as JStateRepository
from deequ_tpu.verification import VerificationSuite as JSuite
from deequ_tpu_torch import Check, CheckLevel, Table, VerificationSuite
from deequ_tpu_torch.analyzers.base import ScanShareableAnalyzer
from deequ_tpu_torch.analyzers.grouping import GroupingAnalyzer
from deequ_tpu_torch.ops import runtime
from deequ_tpu_torch.repository import (
    FileSystemMetricsRepository,
    FileSystemStateRepository,
    ResultKey,
)
from deequ_tpu_torch.repository.states import STATE_FORMAT_VERSION, plan_signature_for
from torch_stream_helpers import assert_metric_equal, bits, plain_route

ROWS = 1500


def _day(rng, rows=ROWS):
    x = rng.normal(3.0, 2.0, rows)
    x[::11] = np.nan
    cats = np.array(["ok", "warn", "err", "skip", None], dtype=object)
    return {
        "x": x,
        "y": 0.5 * x + rng.normal(0.0, 1.0, rows),
        "id": rng.integers(0, 50 * rows, rows),
        "cat": cats[rng.integers(0, len(cats), rows)],
        "grp": rng.integers(0, 5, rows),
    }


def write_day(directory, day, seed=11):
    rng = np.random.default_rng(seed + day)
    path = os.path.join(str(directory), f"day-{day:03d}.parquet")
    pq.write_table(pa.table(_day(rng)), path, row_group_size=512)
    return path


def check(check_cls, level_cls):
    """The flagship analyzers, a quantile and a predicate (the chip smoke
    phase's check, in either package's DSL)."""
    return (
        check_cls(level_cls.ERROR, "daily")
        .has_size(lambda n: n > 0)
        .is_complete("x")  # fails: every 11th x is null
        .has_completeness("x", lambda c: c > 0.9)
        .has_mean("x", lambda v: 2.5 < v < 3.5)
        .has_min("x", lambda v: v < 0)
        .has_max("x", lambda v: v > 6)
        .has_sum("x", lambda v: v > 0)
        .has_standard_deviation("x", lambda v: 1.5 < v < 2.5)
        .has_correlation("x", "y", lambda r: r > 0.5)
        .has_approx_count_distinct("id", lambda v: v > 0)
        .has_approx_quantile("x", 0.5, lambda m: 2.5 < m < 3.5)
        .satisfies("x > 0 OR x IS NULL", "x positive or null", lambda r: r > 0.9)
    )


def run(directory, repo, device="cpu", key=None, mrepo=None, paths=None):
    source = Table.scan_parquet_dataset(paths if paths is not None else str(directory))
    builder = (
        VerificationSuite.on_data(source, device=device)
        .add_check(check(Check, CheckLevel))
        .with_state_repository(repo, "daily")
        .with_tracing(True)
    )
    if mrepo is not None:
        builder = builder.use_repository(mrepo).save_or_append_result(key)
    with runtime.monitored() as stats:
        result = builder.run()
    return result, stats


def split(stats):
    return stats.partitions_cached, stats.partitions_scanned, stats.partitions_total


def traced_split(result):
    """The same split from the run's trace counters (a zero count is left
    out of a run's counters)."""
    counters = result.run_trace.counters
    return tuple(
        counters.get(k, 0)
        for k in ("partitions_cached", "partitions_scanned", "partitions_total")
    )


def metric_bits(result):
    return {repr(a): bits(m.value.get()) for a, m in result.metrics.items()}


def verdicts(result):
    return [
        (cr.status.value, cr.message)
        for res in result.check_results.values()
        for cr in res.constraint_results
    ]


@pytest.fixture
def days(tmp_path, monkeypatch):
    monkeypatch.delenv("DEEQU_TPU_STATE_CACHE", raising=False)
    data = tmp_path / "data"
    data.mkdir()
    for day in range(6):
        write_day(data, day)
    return data


def test_cold_fill_append_and_rerun_equal_a_rescan(days, tmp_path, monkeypatch):
    repo = FileSystemStateRepository(str(tmp_path / "states"))
    mrepo = FileSystemMetricsRepository(str(tmp_path / "metrics.json"))
    cold, stats = run(days, repo, key=ResultKey(1, {"dataset": "daily"}), mrepo=mrepo)
    assert split(stats) == (0, 6, 6) == traced_split(cold)
    write_day(days, 6)
    warm, stats = run(days, repo, key=ResultKey(2, {"dataset": "daily"}), mrepo=mrepo)
    assert split(stats) == (6, 1, 7) == traced_split(warm)
    assert stats.device_passes == 1
    monkeypatch.setenv("DEEQU_TPU_STATE_CACHE", "0")
    rescan, stats = run(days, repo, key=ResultKey(3, {"dataset": "daily"}), mrepo=mrepo)
    assert split(stats) == (0, 7, 7) == traced_split(rescan)
    assert metric_bits(warm) == metric_bits(rescan)
    assert verdicts(warm) == verdicts(rescan)
    assert warm.status == rescan.status
    assert metric_bits(cold) != metric_bits(warm)  # day 6 counted
    # the metrics repository gives back what each run returned
    loaded = mrepo.load().with_tag_values({"dataset": "daily"}).get()
    assert sorted(r.result_key.data_set_date for r in loaded) == [1, 2, 3]
    for result_ in loaded:
        returned = {1: cold, 2: warm, 3: rescan}[result_.result_key.data_set_date]
        assert {
            repr(a): bits(m.value.get()) for a, m in result_.analyzer_context.metric_map.items()
        } == metric_bits(returned)


def _entries(tmp_path):
    return sorted(glob.glob(str(tmp_path / "states" / "**" / "*.dqstate"), recursive=True))


def _corrupt(path, how):
    raw = bytearray(open(path, "rb").read())
    if how == "flipped":
        raw[len(raw) // 3] ^= 0x01
    elif how == "truncated":
        raw = raw[: len(raw) // 2]
    else:  # version-bumped, with a digest that matches the new bytes
        import hashlib

        body = raw[:-32]
        body[4:8] = struct.pack(">I", STATE_FORMAT_VERSION + 1)
        raw = body + hashlib.sha256(bytes(body)).digest()
    with open(path, "wb") as fh:
        fh.write(bytes(raw))


@pytest.mark.parametrize("how", ["flipped", "truncated", "version-bumped"])
def test_unusable_envelope_warns_and_rescans_that_partition(days, tmp_path, how):
    repo = FileSystemStateRepository(str(tmp_path / "states"))
    cold, _ = run(days, repo)
    entries = _entries(tmp_path)
    assert len(entries) == 6
    _corrupt(entries[2], how)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        again, stats = run(days, repo)
    assert [str(w.message)[:6] for w in caught if "DQ314" in str(w.message)] == ["DQ314:"]
    assert split(stats) == (5, 1, 6)
    assert metric_bits(again) == metric_bits(cold)
    # the rescan saved a usable envelope again
    _, stats = run(days, repo)
    assert split(stats) == (6, 0, 6)


def test_merge_range_equals_the_full_run(days, tmp_path):
    repo = FileSystemStateRepository(str(tmp_path / "states"))
    full, _ = run(days, repo)
    source = Table.scan_parquet_dataset(str(days))
    analyzers = [
        a for a in dict.fromkeys(check(Check, CheckLevel).required_analyzers())
        if isinstance(a, ScanShareableAnalyzer) and not isinstance(a, GroupingAnalyzer)
    ]
    signature = plan_signature_for(analyzers, source, device="cpu")
    ranged = repo.merge_range(
        "daily", [p.fingerprint for p in source.partitions()], analyzers, signature, device="cpu"
    )
    assert {repr(a): bits(m.value.get()) for a, m in ranged.metric_map.items()} == metric_bits(full)


def test_incremental_run_equals_the_jax_package(days, tmp_path, monkeypatch):
    plain_route(monkeypatch)
    prepo = FileSystemStateRepository(str(tmp_path / "port_states"))
    jrepo = JStateRepository(str(tmp_path / "jax_states"))

    def jrun():
        return JSuite.do_verification_run(
            JTable.scan_parquet_dataset(str(days)), [check(JCheck, JLevel)],
            state_repository=jrepo, dataset_name="daily", engine="single",
        )

    jrun(), run(days, prepo)
    write_day(days, 6)
    jres = jrun()
    pres, stats = run(days, prepo)
    assert split(stats) == (6, 1, 7)
    assert pres.status.value == jres.status.value
    assert verdicts(pres) == [
        (cr.status.value, cr.message)
        for res in jres.check_results.values()
        for cr in res.constraint_results
    ]
    jmetrics = {repr(a): m for a, m in jres.metrics.items()}
    pmetrics = {repr(a): m for a, m in pres.metrics.items()}
    assert list(pmetrics) == list(jmetrics)
    for key, pm in pmetrics.items():
        assert_metric_equal(jmetrics[key], pm, key, rtol=1e-12)
