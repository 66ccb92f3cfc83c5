#!/usr/bin/env python3
"""The staged stream pipeline against the serial loop, on one CUDA card.

Run from the repository root on a machine with one CUDA card:

    python3 tools/torch_stream_pipeline_ab.py [--rows 4194304,10000000,25165824] [--pairs 3]

For each row count it builds chip_smoke.py's TPC-H lineitem table (16
columns, seed 7), writes it to one Parquet file in row groups of
4,194,304 rows (the fused pass's batch, so 1, 3 and 6 batches at the
default counts) in a temporary directory, and profiles it with
`ColumnProfilerRunner.on_data(Table.scan_parquet(path), device="cuda")`:
one warm-up run with the pipeline on, then `--pairs` pairs in the order
on, off, off, on, on, off, ... (`DEEQU_TPU_PIPELINE` unset and "0").
Every run's profile must equal the warm-up's, bit for bit.

It prints the card's nvidia-smi line, one JSON line per run (wall
seconds) and one per row count (each mode's runs and median, and
off/on, the pipeline's speed-up), and writes the same lines to
chiprun_out/stream_pipeline_ab.jsonl when that directory exists. Host
wall times spread by about 20% between runs on a shared host: compare
the modes only within one call.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

ROW_GROUP = 4_194_304


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--rows", default="4194304,10000000,25165824")
    parser.add_argument("--pairs", type=int, default=3)
    parser.add_argument("--seed", type=int, default=7)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.stderr.write("torch_stream_pipeline_ab: no CUDA device\n")
        return 2
    import chip_smoke
    from deequ_tpu_torch import ColumnProfilerRunner
    from deequ_tpu_torch.data.table import Table
    from deequ_tpu_torch.ops import cuda_build

    out_dir = os.path.join(ROOT, "chiprun_out")
    out = None
    if os.path.isdir(out_dir):
        out = open(os.path.join(out_dir, "stream_pipeline_ab.jsonl"), "w")

    def emit(obj) -> None:
        line = json.dumps(obj)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    smi = chip_smoke.nvidia_smi_line()
    print(smi, flush=True)
    cuda_build.build()

    def profile(path, pipeline_on: bool):
        if pipeline_on:
            os.environ.pop("DEEQU_TPU_PIPELINE", None)
        else:
            os.environ["DEEQU_TPU_PIPELINE"] = "0"
        try:
            torch.cuda.synchronize()
            start = time.perf_counter()
            result = ColumnProfilerRunner.on_data(Table.scan_parquet(path), device="cuda").run()
            torch.cuda.synchronize()
            return result.to_json(), time.perf_counter() - start
        finally:
            os.environ.pop("DEEQU_TPU_PIPELINE", None)

    order = []
    for i in range(args.pairs):
        order += [True, False] if i % 2 == 0 else [False, True]
    for rows in (int(r) for r in args.rows.split(",")):
        with tempfile.TemporaryDirectory(prefix="stream_ab_") as tmp:
            path = os.path.join(tmp, "lineitem.parquet")
            _, table = chip_smoke.lineitem_table(rows, args.seed)
            start = time.perf_counter()
            table.to_parquet(path, row_group_size=ROW_GROUP)
            write_s = time.perf_counter() - start
            del table
            reference, warmup_s = profile(path, True)
            walls = {"on": [], "off": []}
            for k, pipeline_on in enumerate(order):
                got, wall = profile(path, pipeline_on)
                if got != reference:
                    raise AssertionError(f"{rows} rows: run {k} differs from the warm-up run")
                mode = "on" if pipeline_on else "off"
                walls[mode].append(wall)
                emit({"rows": rows, "run": k, "pipeline": mode, "wall_s": wall})
            on, off = statistics.median(walls["on"]), statistics.median(walls["off"])
            emit({
                "rows": rows,
                "batches": -(-rows // ROW_GROUP),
                "card": smi,
                "write_s": write_s,
                "warmup_s": warmup_s,
                "on_s": walls["on"],
                "off_s": walls["off"],
                "median_on_s": on,
                "median_off_s": off,
                "off_over_on": off / on,
            })
    if out is not None:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
