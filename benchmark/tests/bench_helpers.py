"""Tiny runs of the harness on the CPU for the benchmark's tests."""

from __future__ import annotations

import time
import warnings

TINY = {"lineitem.profile": {"rows": 3000}, "lineitem.verify": {"rows": 3000},
        "lineitem.scan": {"rows": 3000}}
CELLS = tuple(TINY)


def tiny_run(cell: str, tmp_path, seed: int = 2**31 + 17, trace: bool = False,
             bench_dir=None, seconds: float = 0.3) -> dict:
    from benchmark import core

    kwargs = {"bench_dir": bench_dir} if bench_dir else {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return core.run_cell(cell, seed, seconds, trace, t0=time.perf_counter(),
                             workdir=str(tmp_path), device="cpu", sizes=TINY[cell],
                             log=lambda line: None, **kwargs)
