"""The profiler's per-batch memos on the host fold, against the full-row
route and the JAX package.

`_LowCardCounts` publishes, for each string or boolean column it counts,
which values occur (`__lccbool`, `__lccpresence`) and the null count
(`__lccnulls`), as the JAX package's does
(deequ_tpu/profiles/internal_analyzers.py). On the host fold
ApproxCountDistinct builds its registers from the present values, and
Completeness answers from the null count. Registers and counts must
equal the full-row route's bit for bit, and a host-all profile with the
memos must equal the one without them bit for bit and the JAX package's
host profile (its C library on, as the port's) within the tolerances of
tests/test_torch_profiler.py.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from deequ_tpu_torch.analyzers import ApproxCountDistinct, Completeness
from deequ_tpu_torch.analyzers import sketch
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.ops.fused import HostInputs
from deequ_tpu_torch.profiles.internal_analyzers import _LowCardCounts
from test_torch_profiler import assert_same_profiles, random_table

MEMO_KEYS = ("__lccbool", "__lccpresence", "__lccnulls")


def memo_table(seed: int, n: int, null_rate: float):
    rng = np.random.default_rng(seed)
    flag = np.where(rng.random(n) < null_rate, None, rng.random(n) < 0.3)
    cat = np.array(["a", "bb", "ccc", "δ", ""], dtype=object)[rng.integers(0, 5, n)]
    cat[rng.random(n) < null_rate] = None
    return {"flag": flag, "cat": cat, "x": rng.normal(size=n)}


def _inputs(table, analyzers):
    specs = {spec.key: spec for a in analyzers for spec in a.input_specs()}
    return HostInputs(specs, table)


@pytest.mark.parametrize("null_rate", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("column", ["flag", "cat"])
def test_memo_registers_and_counts_equal_the_full_row_route(column, null_rate, monkeypatch):
    table = Table.from_numpy(memo_table(5, 3000, null_rate))
    counts, acd, comp = _LowCardCounts(column, 256), ApproxCountDistinct(column), Completeness(column)
    full = _inputs(table, [acd, comp])
    want_regs = acd.host_reduce(full)["registers"]
    want_comp = comp.host_reduce(full)

    memo = _inputs(table, [counts, acd, comp])
    counts.host_batch(memo)
    assert any(f"{key}:{column}" in memo for key in MEMO_KEYS)
    served = []
    real = sketch._memo_registers
    monkeypatch.setattr(sketch, "_memo_registers",
                        lambda inputs, col: served.append(col) or real(inputs, col))
    got_regs = acd.host_reduce(memo)["registers"]
    assert served == [column]
    assert f"hll:{column}" not in memo, "the packed codes were built all the same"
    assert np.array_equal(got_regs, want_regs)
    got_comp = comp.host_reduce(memo)
    assert {k: float(v) for k, v in got_comp.items()} == {k: float(v) for k, v in want_comp.items()}


def test_a_filtered_count_distinct_reads_no_memo():
    table = Table.from_numpy(memo_table(6, 500, 0.2))
    counts, acd = _LowCardCounts("cat", 256), ApproxCountDistinct("cat", where="x > 0")
    memo = _inputs(table, [counts, acd])
    counts.host_batch(memo)
    full = _inputs(table, [acd])
    assert np.array_equal(acd.host_reduce(memo)["registers"], acd.host_reduce(full)["registers"])
    assert "hll:cat" in memo


def _profile(cols, monkeypatch, memos: bool):
    from deequ_tpu_torch import ColumnProfilerRunner

    if not memos:
        real = _LowCardCounts.host_batch

        def without(self, inputs):
            out = real(self, inputs)
            for key in MEMO_KEYS:
                inputs.pop(f"{key}:{self.column}", None)
            return out

        monkeypatch.setattr(_LowCardCounts, "host_batch", without)
    served = []
    real_memo = sketch._memo_registers
    monkeypatch.setattr(sketch, "_memo_registers",
                        lambda inputs, col: (lambda r: served.append(r is not None) or r)(
                            real_memo(inputs, col)))
    profile = ColumnProfilerRunner.on_data(Table.from_numpy(cols), device="cpu").run()
    monkeypatch.undo()
    return profile, served


@pytest.mark.parametrize("placement", ["host-all", "host-discrete"])
def test_host_profile_bit_identical_with_and_without_memos(placement, monkeypatch):
    cols = memo_table(7, 4000, 0.25)
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    with_memos, served = _profile(cols, monkeypatch, memos=True)
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    without_memos, served_off = _profile(cols, monkeypatch, memos=False)
    assert served.count(True) == 2, served  # flag and cat
    assert True not in served_off
    assert with_memos.to_json() == without_memos.to_json()


@pytest.mark.parametrize("seed", [0, 1])
def test_host_profile_with_memos_equals_jax(seed, monkeypatch):
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.ops import native as jnative
    from deequ_tpu.profiles import ColumnProfilerRunner as JRunner
    from deequ_tpu_torch import ColumnProfilerRunner

    if not jnative.available():
        pytest.skip("the JAX package's C host library does not build here")
    cols = {**random_table(seed, 2500), **memo_table(seed, 2500, 0.2)}
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
    jp = JRunner.on_data(JTable.from_numpy(cols)).with_engine("single").run()
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host-all")
    pp = ColumnProfilerRunner.on_data(Table.from_numpy(cols), device="cpu").run()
    assert_same_profiles(jp, pp, rtol=1e-12)
    pcols = {c["column"]: c for c in json.loads(pp.to_json())["columns"]}
    assert pcols["flag"]["approximateNumDistinctValues"] == 2
