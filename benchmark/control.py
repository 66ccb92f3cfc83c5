#!/usr/bin/env python3
"""The control of a cell's comparison: the plain reference computed in
float32, the precision below the configuration's float64, put in the
program's place. It has to come out as not correct.

    python3 benchmark/control.py --workload <name> --seeds 1,2,3 [--rows N]

From the repository root. For each seed it makes the cell's data at the
configuration's size (or `--rows`), judges the control's numbers with
the cell's own comparison and prints one JSON line: each number beside
its limit, and whether the control was caught. Exits 1 when a seed's
control passes. It runs no program code, so it needs no card; the
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_numbers(workload: str, seed: int, workdir: str, sizes=None):
    from benchmark import core

    cell = core.resolve(workload)
    gen = core.load_module("gen", cell.config["generator"])
    reference = core.load_module("reference", cell.traffic_name)
    data = gen.make(cell.config, seed, workdir, write_file=False, **(sizes or {}))
    return reference.control(core.Context(cell, data, seed, workdir, "cpu"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="comma-separated")
    parser.add_argument("--rows", type=int, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    caught_all = True
    for seed in (int(s) for s in args.seeds.split(",")):
        workdir = tempfile.mkdtemp(prefix="deequ-control-")
        try:
            numbers = control_numbers(args.workload, seed, workdir,
                                      {"rows": args.rows} if args.rows else None)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        caught = any(value > limit for _, value, limit in numbers)
        caught_all &= caught
        print(json.dumps({"workload": args.workload, "seed": seed, "caught": caught,
                          "numbers": {n: {"value": v, "limit": lim} for n, v, lim in numbers}}),
              flush=True)
    return 0 if caught_all else 1


if __name__ == "__main__":
    sys.exit(main())
