"""Whole runs over a table held in memory, back to back (one client,
closed loop).

Set-up builds one table of the generator's columns and keeps it, as an
executor keeps a cached day (`held_table`: numpy arrays as they are,
Arrow string dictionaries by their codes, other Arrow strings built
only if read, which no analyzer of the traffic does); each request is an
`AnalysisRunner.on_data(table).add_analyzers(...).run()` over it with
the engine left at its default. On the card that is what a user with
the cell's cards gets: set-up checks that the default resolved to a mesh
of the cell's `chips` cards. On the CPU (the tests) the default never
shards, so the driver passes a mesh of `chips` CPU shards explicitly.

The traffic's `analyzers`, `[{"kind": k, "columns": [...], "bands":
[...]}]`, k one of size, approx_distinct, completeness, min, max, mean,
quantiles (with `probabilities`); each named band of the traffic's
`bands` (an SQL predicate) adds the analyzer again with that `where`.
A request counts the table's rows. `output` gives each analyzer's value
under `key(...)`, a quantile member's as a list in probability order.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from benchmark.core import Iteration

NAMES = {"size": "Size", "approx_distinct": "ApproxCountDistinct",
         "completeness": "Completeness", "min": "Minimum", "max": "Maximum", "mean": "Mean",
         "quantiles": "ApproxQuantiles"}


def key(kind: str, column: Optional[str], where: Optional[str]) -> str:
    """The output key of one analyzer: `Name(column)`, `Size(*)`, and
    ` where <predicate>` for a filtered one."""
    name = f"{NAMES[kind]}({column or '*'})"
    return name if where is None else f"{name} where {where}"


def members(traffic: dict) -> List[Tuple[str, dict, Optional[str], Optional[str]]]:
    """(key, spec, column, where) of every analyzer of the traffic, in order."""
    out = []
    for spec in traffic["analyzers"]:
        wheres = [traffic["bands"][b] for b in spec["bands"]] if "bands" in spec else [None]
        for where in wheres:
            for column in spec.get("columns", [None]):
                out.append((key(spec["kind"], column, where), spec, column, where))
    return out


def _analyzer(spec: dict, column: Optional[str], where: Optional[str]):
    from deequ_tpu_torch.analyzers import (
        ApproxCountDistinct, ApproxQuantiles, Completeness, Maximum, Mean, Minimum, Size,
    )

    kind = spec["kind"]
    if kind == "size":
        return Size(where=where)
    if kind == "quantiles":
        return ApproxQuantiles(column, spec["probabilities"])
    by_kind = {"approx_distinct": ApproxCountDistinct, "completeness": Completeness,
               "min": Minimum, "max": Maximum, "mean": Mean}
    return by_kind[kind](column, where=where)


def held_table(columns: dict):
    """The port's Table of the generator's columns, in their order: a
    numpy array as `Table.from_numpy` takes it, an Arrow string
    dictionary as `Table.from_arrow` does (its codes and entries), and
    any other Arrow string array as a column whose rows are built on
    first read."""
    import numpy as np
    import pyarrow as pa

    from deequ_tpu_torch import Table
    from deequ_tpu_torch.data.table import Column, ColumnType

    numbers = Table.from_numpy({k: v for k, v in columns.items() if isinstance(v, np.ndarray)})
    dicts = {k: v for k, v in columns.items() if isinstance(v, pa.DictionaryArray)}
    coded = Table.from_arrow(pa.table(dicts)) if dicts else None
    out = []
    for name, values in columns.items():
        if isinstance(values, np.ndarray):
            out.append(numbers.column(name))
        elif name in dicts:
            out.append(coded.column(name))
        else:
            out.append(Column(name, ColumnType.STRING,
                              lambda v=values: v.to_numpy(zero_copy_only=False),
                              np.ones(len(values), dtype=bool)))
    return Table(out)


def setup(ctx):
    from deequ_tpu_torch import AnalysisRunner
    from deequ_tpu_torch.parallel.distributed import data_mesh

    device = ctx.device
    table = held_table(ctx.data.columns)
    analyzers = [(k, spec, _analyzer(spec, column, where))
                 for k, spec, column, where in members(ctx.cell.traffic)]
    mesh = data_mesh(["cpu"] * ctx.cell.chips) if device == "cpu" else None

    def call():
        runner = AnalysisRunner.on_data(table, device=device)
        if mesh is not None:
            runner = runner.with_engine("distributed", mesh)
        return runner.add_analyzers([a for _, _, a in analyzers]).run()

    state = {"call": call, "device": device, "analyzers": analyzers, "mesh": mesh,
             "rows": table.num_rows}
    engine = settings(state, ctx)["engine"]
    if engine != f"mesh of {ctx.cell.chips}":
        raise RuntimeError(f"{ctx.cell.name} runs on a mesh of {ctx.cell.chips}; the engine "
                           f"resolved to {engine!r}")
    request(state, ctx, 0)  # the warm-up: every shape the window uses
    return state


def settings(state, ctx) -> dict:
    import torch

    from deequ_tpu_torch.runners.engine import resolve_engine

    from benchmark.drivers_common import program_settings

    out = program_settings(ctx)
    mesh = state["mesh"]
    resolved = resolve_engine("auto" if mesh is None else "distributed", mesh,
                              num_rows=state["rows"], device=torch.device(ctx.device))
    out["engine"] = "single" if resolved is None else f"mesh of {len(resolved.devices)}"
    return out


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
    return Iteration(start, end, state["rows"], end - start, True, result)


def output(state, ctx, result) -> dict:
    from benchmark.drivers_common import metric_value

    out = {}
    for k, spec, analyzer in state["analyzers"]:
        metric = result.metric_map.get(analyzer)
        value = None if metric is None else metric_value(metric)
        if isinstance(value, dict):  # a quantile member: {probability: value}
            value = [value[str(float(p))] for p in spec["probabilities"]]
        out[k] = value
    return out


def close(state) -> None:
    state.clear()
