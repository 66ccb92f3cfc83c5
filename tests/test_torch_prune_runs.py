"""Row-group pruning on the port's scan path, and EXPLAIN held against
the run it predicts, on the CPU.

- A pruned run equals the unpruned run (DEEQU_TPU_PUSHDOWN=0) bit for
  bit, and the JAX package's pruned run: counts, extremes, registers and
  quantiles exactly, float sums within 1e-12 relative.
- The groups skipped, the where filters elided, the passes, batches and
  device launches equal `explain_plan`'s prediction exactly, and so do
  the first batch's wire bytes: the sum of `nbytes` of the buffers
  `pack_batch_inputs` returns, less one bit row (wire_pad_size / 8
  bytes) for each mask the prediction ships that the run found all-true
  on the batch and sent as a constant.
- A where proven all-true is never evaluated and its column is never
  decoded; the wire bytes are the same on and off, since the port ships
  an all-true mask as a constant either way.
- An infinite value on a row the where excludes changes nothing, under
  the `device` and `host-all` placements (the JAX package's `host-all`
  answer).
"""

from __future__ import annotations

import contextlib

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import deequ_tpu_torch.analyzers as an
from deequ_tpu_torch.data.expr import Predicate
from deequ_tpu_torch.data.table import Table
from deequ_tpu_torch.lint import explain_plan
from deequ_tpu_torch.ops import fused, runtime
from deequ_tpu_torch.runners import AnalysisRunner

GROUP = 1000
GROUPS = 10
SUM_RTOL = 1e-12


@pytest.fixture(scope="module")
def clustered(tmp_path_factory):
    """10 groups of 1,000 rows sorted by a key with repeats, so a group's
    first key may equal the one before's last (as dbgen's lineitem)."""
    rng = np.random.default_rng(11)
    n = GROUP * GROUPS
    key = np.sort(rng.integers(1, n // 4, n), kind="stable")
    price = np.round(rng.uniform(900, 100_000, n), 2)
    quantity = rng.integers(1, 51, n)
    discount = rng.integers(0, 11, n) / 100.0
    comment = np.array([f"c{i % 37}" for i in range(n)], dtype=object)
    path = str(tmp_path_factory.mktemp("prune") / "clustered.parquet")
    pq.write_table(
        pa.table({
            "key": key, "price": price, "quantity": quantity,
            "discount": discount, "comment": comment, "part": rng.integers(1, 2000, n),
        }),
        path, row_group_size=GROUP, compression="zstd",
    )
    k7 = int(key[7 * GROUP])
    skipped = sum(1 for g in range(GROUPS) if key[(g + 1) * GROUP - 1] < k7)
    return path, k7, skipped


def skip_members(mod, where, double_where):
    return [
        mod.Size(where=where),
        mod.Completeness("comment", where=where),
        mod.Mean("price", where=where),
        mod.Sum("price", where=where),
        mod.Minimum("price", where=where),
        mod.Maximum("price", where=where),
        mod.StandardDeviation("price", where=where),
        mod.ApproxCountDistinct("part", where=where),
        mod.ApproxQuantile("quantity", 0.5, where=where),
        mod.Maximum("quantity", where=double_where),
    ]


def elide_members(mod, where):
    return [
        mod.Size(where=where),
        mod.Completeness("comment", where=where),
        mod.Mean("price", where=where),
        mod.Sum("price", where=where),
        mod.Minimum("price", where=where),
        mod.Maximum("price", where=where),
        mod.StandardDeviation("price", where=where),
        mod.ApproxCountDistinct("part", where=where),
        mod.ApproxQuantile("price", 0.5, where=where),
    ]


@contextlib.contextmanager
def first_wire(seen):
    """Record each `pack_batch_inputs` call's (buffer bytes, layout)."""
    original = fused.pack_batch_inputs

    def wrapper(*args, **kwargs):
        buffers, layout = original(*args, **kwargs)
        seen.append((sum(b.numel() * b.element_size() for b in buffers.values()), layout))
        return buffers, layout

    fused.pack_batch_inputs = wrapper
    try:
        yield seen
    finally:
        fused.pack_batch_inputs = original


def run(path, analyzers, monkeypatch, pushdown):
    monkeypatch.setenv("DEEQU_TPU_PUSHDOWN", pushdown)
    # one batch per row group (none is under a quarter of the batch, so
    # none coalesces): the pruned scan folds the unpruned scan's batches
    # less the skipped ones, whose partials are empty
    source = Table.scan_parquet(path, batch_rows=GROUP)
    seen = []
    with runtime.monitored() as stats, first_wire(seen):
        ctx = AnalysisRunner.on_data(source, device="cpu").add_analyzers(analyzers).run()
    explained = explain_plan(source, analyzers, device="cpu")
    return ctx, stats, seen, explained


def values(ctx):
    return {repr(a): m.value.get() for a, m in ctx.metric_map.items()}


def bits(value):
    if isinstance(value, dict):
        return {k: bits(v) for k, v in value.items()}
    return np.float64(value).tobytes()


def assert_explained(stats, seen, explained):
    """Observed counts and first-batch wire bytes against the prediction."""
    cost = explained.cost
    scan = cost.scan_pass
    assert cost.counters == {
        "device_passes": stats.device_passes,
        "device_launches": stats.device_launches,
        "group_passes": stats.group_passes,
    }
    assert scan.n_batches == len(seen)
    assert (scan.rg_skipped or 0) == stats.rg_skipped
    nbytes, layout = seen[0]
    padded = layout[2]
    const_keys = set(layout[1])
    runtime_elided = [k for k in scan.wire_bit_keys if k in const_keys]
    assert scan.wire_bytes_per_batch - len(runtime_elided) * (padded // 8) == nbytes
    return runtime_elided


@pytest.fixture
def device_placement(monkeypatch):
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "device")


def test_skip_run_equals_unpruned_and_explain(clustered, monkeypatch, device_placement):
    path, k7, skipped = clustered
    where = f"key >= {k7}"
    analyzers = skip_members(an, where, f"{where} and discount >= 0.0")
    on, on_stats, on_seen, on_explain = run(path, analyzers, monkeypatch, "1")
    off, off_stats, off_seen, off_explain = run(path, analyzers, monkeypatch, "0")
    assert {k: bits(v) for k, v in values(on).items()} == {
        k: bits(v) for k, v in values(off).items()
    }
    assert skipped > 0
    assert on_stats.rg_skipped == skipped == on_explain.cost.scan_pass.rg_skipped
    assert on_stats.rg_rows_skipped == skipped * GROUP
    # the DOUBLE atom never proves all-true: the second where is never
    # elided; the first is elided only when every decoded group is
    # all-true for it
    assert f"{where} and discount >= 0.0" not in on_explain.cost.prune.elided_wheres()
    assert off_stats.rg_skipped == 0 and off_stats.rg_total == 0
    assert on_stats.device_launches < off_stats.device_launches
    assert on_stats.device_launches == on_explain.cost.scan_pass.n_batches
    for stats, seen, explained in ((on_stats, on_seen, on_explain), (off_stats, off_seen, off_explain)):
        assert assert_explained(stats, seen, explained) == []


def test_elide_run_equals_unpruned_and_explain(clustered, monkeypatch, device_placement):
    path, _k7, _ = clustered
    where = "quantity >= 1"
    analyzers = elide_members(an, where)
    evaluated = []
    original = Predicate.eval_mask

    def counting(self, table):
        evaluated.append(self.expression)
        return original(self, table)

    monkeypatch.setattr(Predicate, "eval_mask", counting)
    on, on_stats, on_seen, on_explain = run(path, analyzers, monkeypatch, "1")
    on_evaluated = list(evaluated)
    off, off_stats, off_seen, off_explain = run(path, analyzers, monkeypatch, "0")
    assert {k: bits(v) for k, v in values(on).items()} == {
        k: bits(v) for k, v in values(off).items()
    }
    assert on_stats.rg_skipped == 0 and on_stats.rg_total == GROUPS
    assert on_stats.wheres_elided == 1 and off_stats.wheres_elided == 0
    assert on_explain.cost.prune.elided_wheres() == (where,)
    assert where not in on_evaluated and where in evaluated[len(on_evaluated):]
    # the elided filter's column is not decoded: one column fewer
    assert on_stats.wire_cols_total == off_stats.wire_cols_total - 1
    # an all-true mask ships as a constant on and off
    assert on_seen[0][0] == off_seen[0][0]
    assert assert_explained(on_stats, on_seen, on_explain) == []
    assert assert_explained(off_stats, off_seen, off_explain) == [f"where:{where}"]


def test_pruned_run_equals_jax(clustered, monkeypatch, device_placement):
    """The port's pruned run against the JAX package's on the same file."""
    import deequ_tpu.analyzers as jan
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.runners import AnalysisRunner as JRunner

    path, k7, _ = clustered
    where = f"key >= {k7}"
    monkeypatch.setenv("DEEQU_TPU_PUSHDOWN", "1")
    got = values(
        AnalysisRunner.on_data(Table.scan_parquet(path, batch_rows=1 << 20), device="cpu")
        .add_analyzers(skip_members(an, where, f"{where} and discount >= 0.0"))
        .run()
    )
    want = values(
        JRunner.on_data(JTable.scan_parquet(path, batch_rows=1 << 20))
        .with_engine("single")
        .add_analyzers(skip_members(jan, where, f"{where} and discount >= 0.0"))
        .run()
    )
    assert got.keys() == want.keys()
    for key, value in want.items():
        if key.startswith(("Mean", "Sum", "StandardDeviation")):
            assert got[key] == pytest.approx(value, rel=SUM_RTOL), key
        else:
            assert got[key] == value, key


def test_main_path_shape_explained_on_a_table(monkeypatch, device_placement):
    """An in-memory table: passes, batches, launches and the first batch's
    wire bytes, as predicted."""
    rng = np.random.default_rng(4)
    n = 5000
    x = rng.normal(3.0, 2.0, n)
    x[::11] = np.nan
    cat = np.array(["ok", "warn", "err", None], dtype=object)[rng.integers(0, 4, n)]
    table = Table.from_pydict(
        {"x": x, "y": 0.5 * x + rng.normal(size=n), "id": rng.integers(0, n, n), "cat": cat}
    )
    analyzers = [
        an.Size(), an.Completeness("x"), an.Mean("x"), an.StandardDeviation("x"),
        an.Correlation("x", "y"), an.ApproxCountDistinct("id"),
        an.ApproxQuantile("x", 0.5), an.Compliance("pos", "x > 0 OR x IS NULL"),
        an.Compliance("in", "cat IS NULL OR cat IN ('ok', 'warn', 'err')"),
        an.PatternMatch("cat", r"^(ok|warn)$"), an.Uniqueness(["id"]), an.Entropy("cat"),
    ]
    seen = []
    with runtime.monitored() as stats, first_wire(seen):
        AnalysisRunner.on_data(table, device="cpu").add_analyzers(analyzers).run()
    explained = explain_plan(table, analyzers, device="cpu", batch_size=None)
    elided = assert_explained(stats, seen, explained)
    # the IN predicate holds on every row, and neither predicate is ever
    # NULL: the run ships those masks as constants, which the static
    # model (a string predicate; the typechecker's conservative
    # nullability) does not know
    assert elided == [
        "pred:cat IS NULL OR cat IN ('ok', 'warn', 'err')",
        "prednn:cat IS NULL OR cat IN ('ok', 'warn', 'err')",
        "prednn:x > 0 OR x IS NULL",
    ]


@pytest.mark.parametrize("placement", ["device", "host-all"])
def test_inf_on_an_excluded_row_changes_nothing(monkeypatch, placement):
    """x = [1, 2, inf], y = [1, 1, -1], where y > 0: the JAX package's
    host-all answer (its device route multiplies inf by a 0 mask)."""
    from deequ_tpu.analyzers import Mean as JMean
    from deequ_tpu.analyzers import StandardDeviation as JStd
    from deequ_tpu.analyzers import Sum as JSum
    from deequ_tpu.data.table import Table as JTable
    from deequ_tpu.runners import AnalysisRunner as JRunner

    data = {"x": np.array([1.0, 2.0, np.inf]), "y": np.array([1.0, 1.0, -1.0])}
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", "host")
    jax_host_all = values(
        JRunner.on_data(JTable.from_pydict(data)).with_engine("single")
        .add_analyzers([JMean("x", where="y > 0"), JSum("x", where="y > 0"),
                        JStd("x", where="y > 0")])
        .run()
    )
    monkeypatch.setenv("DEEQU_TPU_PLACEMENT", placement)
    with runtime.monitored() as stats:
        got = values(
            AnalysisRunner.on_data(Table.from_pydict(data), device="cpu")
            .add_analyzers([an.Mean("x", where="y > 0"), an.Sum("x", where="y > 0"),
                            an.StandardDeviation("x", where="y > 0")])
            .run()
        )
    assert stats.placements == [placement]
    assert got == jax_host_all == {
        "Mean(x,Some(y > 0))": 1.5,
        "Sum(x,Some(y > 0))": 3.0,
        "StandardDeviation(x,Some(y > 0))": 0.5,
    }
