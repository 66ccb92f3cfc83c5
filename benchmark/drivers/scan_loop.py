"""Whole runs over one Parquet file, back to back (one client, closed loop).

Each request is a fresh `Table.scan_parquet` of the configuration's file
through the runner the traffic names:

    "profile"   ColumnProfilerRunner, the default profile of every column
    "verify"    VerificationSuite with the traffic's `constraints`
                (benchmark/checks.py)
    "analysis"  AnalysisRunner with the traffic's `analyzers`:
                [{"kind": k, "columns": [...]}], k one of size,
                completeness, mean, stddev, min, max, sum,
                approx_distinct, correlation (one pair per entry)

A request counts the file's rows. `output` turns a run's result into
plain numbers for the reference: `{key: value}` and, for a verification,
`status[i]` per constraint in order.
"""

from __future__ import annotations

import time

from benchmark.core import Iteration


def _analyzers(specs):
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, Completeness, Correlation, Maximum, Mean, Minimum, Size,
        StandardDeviation, Sum,
    )

    by_kind = {"completeness": Completeness, "mean": Mean, "stddev": StandardDeviation,
               "min": Minimum, "max": Maximum, "sum": Sum, "approx_distinct": ApproxCountDistinct}
    out = []
    for spec in specs:
        if spec["kind"] == "size":
            out.append(Size())
        elif spec["kind"] == "correlation":
            out.append(Correlation(*spec["columns"]))
        else:
            out.extend(by_kind[spec["kind"]](column) for column in spec["columns"])
    return out


def setup(ctx):
    from deequ_tpu_torch import AnalysisRunner, ColumnProfilerRunner, Table, VerificationSuite

    from benchmark.checks import build_check

    path, device, traffic = ctx.data.path, ctx.device, ctx.cell.traffic
    runner = traffic["runner"]
    if runner == "profile":
        def call():
            return ColumnProfilerRunner.on_data(Table.scan_parquet(path), device=device).run()
    elif runner == "verify":
        check = build_check(traffic["constraints"], ctx.data.rows)

        def call():
            return VerificationSuite.on_data(Table.scan_parquet(path), device=device) \
                .add_check(check).run()
    elif runner == "analysis":
        analyzers = _analyzers(traffic["analyzers"])

        def call():
            return AnalysisRunner.on_data(Table.scan_parquet(path), device=device) \
                .add_analyzers(analyzers).run()
    else:
        raise ValueError(f"unknown runner {runner!r}")
    state = {"call": call, "device": device}
    request(state, ctx, 0)  # the warm-up: every shape the window uses
    return state


def settings(state, ctx) -> dict:
    from benchmark.drivers_common import program_settings

    return program_settings(ctx)


def request(state, ctx, index: int) -> Iteration:
    start = time.perf_counter()
    try:
        result = state["call"]()
        if state["device"] == "cuda":
            import torch

            torch.cuda.synchronize()
    except Exception as exc:  # a failed request is counted, and the window goes on
        end = time.perf_counter()
        return Iteration(start, end, 0, end - start, False, error=f"{type(exc).__name__}: {exc}")
    end = time.perf_counter()
    return Iteration(start, end, ctx.data.rows, end - start, True, result)


def output(state, ctx, result) -> dict:
    from benchmark.drivers_common import profile_numbers, result_numbers

    convert = profile_numbers if ctx.cell.traffic["runner"] == "profile" else result_numbers
    return convert(result)


def close(state) -> None:
    state.clear()
