"""Traces across processes: two real processes joined by
`torch.distributed` over gloo, each tracing its part of a sharded scan
with one output path, write one file each (the path suffixed with the
process's rank, `observe.runtrace._per_process_path`), stamped with the
rank as their `pid`; `merge_chrome_traces` of the two shows both
processes (pids 0 and 1) and the shard exchange's spans. The spawned run
has a timeout of 120 s."""

from __future__ import annotations

import json
import os
import textwrap

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

from deequ_tpu_torch import observe
from deequ_tpu_torch.observe import export, runtrace
from deequ_tpu_torch.parallel.procspawn import run_worker_processes

WORKER = textwrap.dedent(
    """
    import json, os, sys

    os.environ["DEEQU_TPU_PLACEMENT"] = "device"
    rank, port, _tmp, data_dir, out_dir = (
        int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4], sys.argv[5])

    from deequ_tpu_torch import observe
    from deequ_tpu_torch.analyzers import ApproxCountDistinct, Mean, Size
    from deequ_tpu_torch.data.source import PartitionedParquetSource
    from deequ_tpu_torch.observe import export
    from deequ_tpu_torch.parallel import multihost

    multihost.initialize(f"127.0.0.1:{port}", 2, rank, backend="gloo", timeout_s=60)
    try:
        with observe.traced_run(
                "sharded_scan", enable=os.path.join(out_dir, "trace.json")) as handle:
            multihost.run_sharded_analysis(
                PartitionedParquetSource(data_dir), [Size(), Mean("x"), ApproxCountDistinct("x")],
                device="cpu")
        out = {"rank": rank, "pid": export.process_index(), "path": handle.trace.path,
               "counters": handle.trace.counters}
    finally:
        multihost.shutdown()
    print("RESULT:" + json.dumps(out), flush=True)
    """
)


def test_rank_zero_and_no_suffix_outside_a_process_group(tmp_path):
    assert export.process_index() == 0
    assert export.process_count() == 1
    path = str(tmp_path / "t.json")
    assert runtrace._per_process_path(path) == path


def test_two_workers_write_one_trace_each_and_merge_by_rank(tmp_path):
    data_dir = tmp_path / "data"
    data_dir.mkdir()
    rng = np.random.default_rng(4)
    for i in range(4):
        pq.write_table(pa.table({"x": rng.normal(size=1500)}),
                       str(data_dir / f"part-{i}.parquet"), row_group_size=500)
    out_dir = tmp_path / "traces"
    out_dir.mkdir()
    results = run_worker_processes(WORKER, 2, [str(data_dir), str(out_dir)], timeout=120)
    for rank, r in enumerate(results):
        assert r["pid"] == rank
        assert r["path"] == str(out_dir / f"trace_p{rank}.json")
        assert r["counters"]["shard.count"] == 2
        assert r["counters"].get("shard.index", 0) == rank
        assert r["counters"]["shard.partitions_total"] == 4
    assert sum(r["counters"].get("shard.partitions_local", 0) for r in results) == 4
    for r in results:
        with open(r["path"], encoding="utf-8") as f:
            doc = json.load(f)
        assert {e["pid"] for e in doc["traceEvents"]} == {r["rank"]}
    merged = observe.merge_chrome_traces([r["path"] for r in results])
    assert {e["pid"] for e in merged["traceEvents"]} == {0, 1}
    names = {e["name"] for e in merged["traceEvents"] if e["ph"] == "B"}
    assert {"sharded_scan", "shard_allgather", "shard_merge", "fused_scan"} <= names
