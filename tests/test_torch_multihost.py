"""Multi-process runs of the port (deequ_tpu_torch/parallel/multihost.py):
the cross-process state merge with an injected gather, and two real
processes joined by `torch.distributed` over gloo on localhost, started
by parallel/procspawn.py. Port-mapped copies of tests/test_multihost.py
and tests/test_two_process_multihost.py; each spawned run has a timeout
of 120 s or less."""

from __future__ import annotations

import os
import struct
import textwrap

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from deequ_tpu_torch.analyzers import (
    ApproxCountDistinct,
    ApproxQuantile,
    Completeness,
    Compliance,
    Correlation,
    CountDistinct,
    DataType,
    Distinctness,
    Entropy,
    Maximum,
    Mean,
    Minimum,
    PatternMatch,
    Size,
    StandardDeviation,
    Sum,
    Uniqueness,
)
from deequ_tpu_torch.analyzers.state_provider import InMemoryStateProvider, serialize_state
from deequ_tpu_torch.data.source import PartitionedParquetSource
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.parallel import multihost
from deequ_tpu_torch.parallel.procspawn import WorkerFailure, run_worker_processes
from deequ_tpu_torch.runners.analysis_runner import AnalysisRunner

INEXACT = ("Mean", "Sum", "StandardDeviation", "Correlation", "Entropy")

ALL_ANALYZERS = [
    Size(), Completeness("x"), Compliance("pos", "x > 0"), PatternMatch("s", r"^\d+$"),
    Mean("x"), Minimum("x"), Maximum("x"), Sum("x"), StandardDeviation("x"),
    Correlation("x", "y"), DataType("s"), ApproxCountDistinct("g"), ApproxQuantile("x", 0.5),
    Uniqueness(("g",)), Distinctness(("g",)), CountDistinct(("g",)), Entropy("g"),
]


@pytest.fixture(autouse=True)
def _device_placement(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


def make_arrays(seed: int, n: int = 3000) -> dict:
    rng = np.random.default_rng(seed)
    x = rng.normal(1.0, 2.0, n)
    x[::13] = np.nan
    return {
        "x": x,
        "y": rng.normal(size=n),
        "g": rng.integers(0, 40, n),
        "s": np.array([["12", "abc", "3.5", None][i % 4] for i in range(n)], dtype=object),
    }


def run(table, analyzers, **kw):
    return AnalysisRunner.do_analysis_run(table, analyzers, "cpu", **kw)


def envelope(analyzers, blobs) -> bytes:
    return multihost.analyzer_list_digest(analyzers) + b"".join(
        struct.pack(">i", len(b)) + b for b in blobs
    )


def assert_close(got, want, analyzer):
    if isinstance(analyzer, ApproxQuantile):
        # sketches merged in another order: within the rank error
        assert got == pytest.approx(want, rel=0.05), analyzer
    elif repr(analyzer).startswith(INEXACT):
        assert got == pytest.approx(want, rel=1e-12), analyzer
    else:
        assert got == want, analyzer


def test_single_process_identity():
    assert multihost.process_index() == 0 and multihost.process_count() == 1
    assert multihost.allgather_bytes(b"abc") == [b"abc"]
    assert multihost.allgather_bytes(b"") == [b""]


def test_merge_equals_whole_table():
    """Three parts analyzed on their own and merged through one envelope
    each equal the whole table."""
    raw = [make_arrays(seed) for seed in (1, 2, 3)]
    providers = []
    for arrays in raw:
        provider = InMemoryStateProvider()
        run(Table.from_numpy(arrays), ALL_ANALYZERS, save_states_with=provider)
        providers.append(provider)

    def envelope_of(provider):
        blobs = []
        for a in ALL_ANALYZERS:
            state = provider.load(a)
            blobs.append(b"\x00" if state is None else b"\x01" + serialize_state(a, state))
        return envelope(ALL_ANALYZERS, blobs)

    whole = run(
        Table.from_numpy({k: np.concatenate([r[k] for r in raw]) for k in raw[0]}), ALL_ANALYZERS
    )
    for host in range(3):

        def gather(payload, host=host):
            assert payload == envelope_of(providers[host])
            return [envelope_of(p) for p in providers]

        merged, errors = multihost.merge_states_across_hosts(ALL_ANALYZERS, providers[host], gather=gather)
        assert not errors
        for a in ALL_ANALYZERS:
            got = a.compute_metric_from(merged.load(a)).value.get()
            assert_close(got, whole.metric_map[a].value.get(), a)


def test_run_multihost_analysis_single_process():
    table = Table.from_numpy(make_arrays(9))
    with pytest.warns(DeprecationWarning, match="run_sharded_analysis"):
        ctx = multihost.run_multihost_analysis(table, ALL_ANALYZERS, device="cpu")
    single = run(table, ALL_ANALYZERS)
    for a in ALL_ANALYZERS:
        assert_close(ctx.metric_map[a].value.get(), single.metric_map[a].value.get(), a)


def test_remote_failure_fails_the_global_metric():
    table = Table.from_numpy(make_arrays(4))

    def gather(payload):
        blob = b"\x02" + b"boom on host 1"
        return [payload, envelope([Size(), Mean("x")], [blob, blob])]

    with pytest.warns(DeprecationWarning):
        ctx = multihost.run_multihost_analysis(table, [Size(), Mean("x")], gather=gather, device="cpu")
    for a in (Size(), Mean("x")):
        assert ctx.metric_map[a].value.is_failure
        assert "boom on host 1" in str(ctx.metric_map[a].value.exception)


def test_local_failure_propagates_but_an_empty_part_does_not():
    with pytest.warns(DeprecationWarning):
        ctx = multihost.run_multihost_analysis(
            Table.from_numpy(make_arrays(5)), [Size(), Mean("nope")], device="cpu"
        )
    assert ctx.metric_map[Size()].value.is_success
    assert ctx.metric_map[Mean("nope")].value.is_failure
    other = InMemoryStateProvider()
    run(Table.from_numpy(make_arrays(6)), [Mean("x")], save_states_with=other)

    def gather(payload):
        blob = b"\x01" + serialize_state(Mean("x"), other.load(Mean("x")))
        return [payload, envelope([Mean("x")], [blob])]

    with pytest.warns(DeprecationWarning):
        ctx2 = multihost.run_multihost_analysis(
            Table.from_numpy({"x": np.full(10, np.nan)}), [Mean("x")], gather=gather, device="cpu"
        )
    assert ctx2.metric_map[Mean("x")].value.is_success


def test_envelope_digest_mismatch_raises():
    provider = InMemoryStateProvider()
    run(Table.from_numpy(make_arrays(7, n=100)), [Size(), Sum("x")], save_states_with=provider)

    def gather(payload):
        a = b"\x01" + serialize_state(Size(), provider.load(Size()))
        b = b"\x01" + serialize_state(Sum("x"), provider.load(Sum("x")))
        return [payload, envelope([Sum("x"), Size()], [b, a])]

    with pytest.raises(ValueError, match="analyzer-list mismatch"):
        multihost.merge_states_across_hosts([Size(), Sum("x")], provider, gather=gather)


def test_duplicate_analyzers_merge_once():
    with pytest.warns(DeprecationWarning):
        ctx = multihost.run_multihost_analysis(
            Table.from_numpy(make_arrays(8, n=100)), [Size(), Size(), Mean("x")], device="cpu"
        )
    assert ctx.metric_map[Size()].value.get() == 100.0


def test_global_data_mesh_needs_cuda_in_one_process():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.global_data_mesh()


# -- two real processes over gloo -----------------------------------------------

WORKER_HEAD = textwrap.dedent(
    """
    import json, os, sys

    os.environ["DEEQU_TPU_PLACEMENT"] = "device"
    os.environ["DEEQU_TPU_MAX_GROUPS_IN_MEMORY"] = "200"
    rank, port, tmpdir, data_dir = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]

    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, ApproxQuantile, Completeness, CountDistinct, Maximum, Mean,
        Minimum, Size, StandardDeviation, Sum, Uniqueness,
    )
    from deequ_tpu_torch.parallel import multihost

    ANALYZERS = [
        Size(), Completeness("x"), Mean("x"), Sum("x"), Minimum("x"), Maximum("x"),
        StandardDeviation("x"), ApproxCountDistinct("g"), ApproxQuantile("x", 0.5),
        Uniqueness(("g",)), CountDistinct(("g",)),
    ]

    def values(ctx):
        out = {}
        for a in ANALYZERS:
            v = ctx.metric_map[a].value.get()
            out[repr(a)] = v.hex() if isinstance(v, float) else v
        return out

    multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout_s=60)
    try:
        gathered = multihost.allgather_bytes(b"r" * (3 * rank))
        out = {"rank": multihost.process_index(), "count": multihost.process_count(),
               "gathered": [g.decode() for g in gathered]}
    """
)

SHARDED_WORKER = WORKER_HEAD + textwrap.indent(
    textwrap.dedent(
        """
        from deequ_tpu_torch.data.source import PartitionedParquetSource

        src = PartitionedParquetSource(data_dir)
        out["metrics"] = values(multihost.run_sharded_analysis(src, ANALYZERS, device="cpu"))
        """
    ),
    "    ",
) + textwrap.dedent(
    """
    finally:
        multihost.shutdown()
    print("RESULT:" + json.dumps(out), flush=True)
    """
)

MULTIHOST_WORKER = WORKER_HEAD + textwrap.indent(
    textwrap.dedent(
        """
        import warnings

        from deequ_tpu_torch.data.source import ParquetSource

        source = ParquetSource(os.path.join(data_dir, f"part-{rank:03d}.parquet"), batch_rows=5_000)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            ctx = multihost.run_multihost_analysis(source, ANALYZERS, device="cpu")
        out["metrics"] = values(ctx)
        """
    ),
    "    ",
) + textwrap.dedent(
    """
    finally:
        multihost.shutdown()
    print("RESULT:" + json.dumps(out), flush=True)
    """
)


def worker_analyzers():
    return [
        Size(), Completeness("x"), Mean("x"), Sum("x"), Minimum("x"), Maximum("x"),
        StandardDeviation("x"), ApproxCountDistinct("g"), ApproxQuantile("x", 0.5),
        Uniqueness(("g",)), CountDistinct(("g",)),
    ]


def write_parts(root, n_parts, rows):
    os.makedirs(root, exist_ok=True)
    paths = []
    for i in range(n_parts):
        rng = np.random.default_rng(100 + i)
        x = rng.normal(3.0, 2.0, rows(i))
        x[::7] = np.nan
        path = os.path.join(root, f"part-{i:03d}.parquet")
        pq.write_table(
            pa.table({"x": pa.array(x, mask=np.isnan(x)), "g": pa.array(rng.integers(0, 1000, rows(i)))}),
            path,
            row_group_size=5_000,
        )
        paths.append(path)
    return paths


def hexed(ctx, analyzers):
    out = {}
    for a in analyzers:
        v = ctx.metric_map[a].value.get()
        out[repr(a)] = v.hex() if isinstance(v, float) else v
    return out


def assert_exchange(results):
    for rank, r in enumerate(results):
        assert (r["rank"], r["count"]) == (rank, 2)
        assert r["gathered"] == ["", "rrr"]


def test_two_process_sharded_scan_equals_solo(tmp_path):
    """Two processes shard six partitions between them, exchange states
    over gloo and both equal the solo partitioned run bit for bit."""
    paths = write_parts(str(tmp_path / "data"), 6, lambda i: 2_000 + 700 * i)
    results = run_worker_processes(SHARDED_WORKER, 2, [str(tmp_path / "data")], timeout=120)
    assert_exchange(results)
    solo = hexed(run(PartitionedParquetSource(paths), worker_analyzers()), worker_analyzers())
    assert results[0]["metrics"] == results[1]["metrics"] == solo


def test_two_process_multihost_analysis_equals_whole_table(tmp_path):
    """Each process streams its own Parquet part (its group counts spill
    past 200 groups) and merges states over gloo: both equal a run over
    the two parts together (float sums within 1e-12, the quantile within
    its rank error)."""
    paths = write_parts(str(tmp_path / "data"), 2, lambda i: 50_000)
    results = run_worker_processes(MULTIHOST_WORKER, 2, [str(tmp_path / "data")], timeout=120)
    assert_exchange(results)
    assert results[0]["metrics"] == results[1]["metrics"]
    whole = run(PartitionedParquetSource(paths), worker_analyzers())
    for a in worker_analyzers():
        got = results[0]["metrics"][repr(a)]
        got = float.fromhex(got) if isinstance(got, str) else got
        assert_close(got, whole.metric_map[a].value.get(), a)


def test_a_rank_that_never_arrives_fails_the_run():
    worker = textwrap.dedent(
        """
        import sys
        from deequ_tpu_torch.parallel import multihost

        multihost.initialize(f"127.0.0.1:{sys.argv[2]}", 2, 0, timeout_s=3)
        """
    )
    with pytest.raises(WorkerFailure, match="failed"):
        run_worker_processes(worker, 1, timeout=60)


def test_worker_failures_raise():
    with pytest.raises(WorkerFailure, match="no RESULT line"):
        run_worker_processes("print('hello')\n", 1, timeout=60)
    with pytest.raises(WorkerFailure, match="failed") as exc:
        run_worker_processes("import sys\nsys.stderr.write('bad rank')\nsys.exit(3)\n", 2, timeout=60)
    assert "bad rank" in exc.value.details
    with pytest.raises(WorkerFailure, match="timed out"):
        run_worker_processes("import time\ntime.sleep(30)\n", 1, timeout=2)
