"""Differential fuzz of the expression engine against SQL three-valued
logic (emulated with pandas + explicit null handling): random
comparison/AND/OR predicates over columns with ~20% nulls must produce
exactly the WHERE-mask SQL would (NULL comparisons drop rows; each
operand's null-ness is tracked through the conjunction).

Port-mapped from tests/test_expr_differential.py: the same cases against deequ_tpu_torch,
every run on the CPU (tests/torch_cpu.py).
"""

from __future__ import annotations

from torch_cpu import cpu_default  # noqa: F401 - a fixture, used by pytestmark

import numpy as np
import pandas as pd
import pytest

from deequ_tpu_torch.data.expr import Predicate
from deequ_tpu_torch.data.table import Table

pytestmark = pytest.mark.usefixtures("cpu_default")

OPS = [">", ">=", "<", "<=", "=", "!="]


@pytest.mark.parametrize("seed", range(40))
def test_random_predicates_match_sql_semantics(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 200))
    a = rng.integers(-5, 5, n).astype(float)
    a[rng.random(n) < 0.2] = np.nan
    b = rng.integers(-5, 5, n).astype(float)
    s = np.array(["x", "y", "zz", None], dtype=object)[rng.integers(0, 4, n)]
    table = Table.from_pydict({"a": list(a), "b": list(b), "s": list(s)})
    df = pd.DataFrame({"a": a, "b": b, "s": s})

    op = rng.choice(OPS)
    lit = int(rng.integers(-5, 5))
    conj = rng.choice(["AND", "OR"])
    op2 = rng.choice([">", "<"])
    predicate = f"a {op} {lit} {conj} b {op2} 0"

    py_op = "==" if op == "=" else op
    p = pd.eval(f"df.a {py_op} {lit}")
    q = pd.eval(f"df.b {op2} 0")
    p_null, q_null = df.a.isna(), df.b.isna()
    if conj == "AND":
        expected = (p & ~p_null) & (q & ~q_null)
    else:
        expected = (p & ~p_null) | (q & ~q_null)

    got = Predicate(predicate).eval_mask(table)
    np.testing.assert_array_equal(np.asarray(expected), got, err_msg=predicate)


@pytest.mark.parametrize("seed", range(0, 40, 5))
def test_in_list_and_is_null(seed):
    rng = np.random.default_rng(100 + seed)
    n = int(rng.integers(1, 150))
    a = rng.integers(-5, 5, n).astype(float)
    a[rng.random(n) < 0.3] = np.nan
    s = np.array(["x", "y", "zz", None], dtype=object)[rng.integers(0, 4, n)]
    table = Table.from_pydict({"a": list(a), "s": list(s)})
    df = pd.DataFrame({"a": a, "s": s})

    got = Predicate("s IN ('x','zz') OR a IS NULL").eval_mask(table)
    expected = np.asarray(df.s.isin(["x", "zz"]) | df.a.isna())
    np.testing.assert_array_equal(expected, got)

    got2 = Predicate("s IS NOT NULL AND a >= 0").eval_mask(table)
    expected2 = np.asarray(df.s.notna() & (df.a >= 0).fillna(False))
    np.testing.assert_array_equal(expected2, got2)
