"""The `verify` traffic's check over the lineitem table, in plain numpy:
each constraint's metric and status (reference/constraints.py)."""

from __future__ import annotations

from typing import List

import numpy as np

from benchmark.reference import plain
from benchmark.reference.constraints import Columns, add_check

def columns(data) -> Columns:
    return Columns(data.rows, dict(data.numeric),
                   {c: (codes, list(data.dictionaries[c])) for c, codes in data.codes.items()},
                   texts=("l_comment",))


def expected(ctx, dtype=np.float64) -> plain.Expected:
    exp = plain.Expected()
    add_check(exp, ctx.cell.traffic["constraints"], columns(ctx.data), dtype)
    return exp


def judge(ctx, outputs: List[dict]):
    return plain.numbers(plain.compare(expected(ctx), outputs))


def control(ctx):
    """The reference in float32 in the program's place."""
    out = expected(ctx, np.float32).as_output()
    return plain.numbers(plain.compare(expected(ctx), [out]))
